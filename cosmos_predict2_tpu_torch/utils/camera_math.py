"""Camera, rigid-transform and quaternion math and volume rendering.

Counterpart of cosmos_predict2_tpu/utils/camera_math.py, on torch tensors:
the math runs in fp32 and casts back to the input's dtype; validity checks
return boolean tensors instead of asserting.

Conventions: poses are world-to-camera [R|t], [..., 3, 4], OpenCV axes;
points are row vectors with the homogeneous coordinate on the right, so a
transform applies as ``points_hom @ pose^T``; quaternions are (x, y, z, w).
The camera-conditioned variant's input is :func:`get_plucker_rays` at the
token grid.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

Tensor = torch.Tensor


def _f32(x) -> Tensor:
    return torch.as_tensor(x).float()


def _dtype(x) -> torch.dtype:
    return torch.as_tensor(x).dtype


# ---------------------------- validity checks ----------------------------


def check_valid_pose(cam_pose: Tensor, atol: float = 1e-4) -> Tensor:
    """det(R) close to 1 per pose."""
    if cam_pose.shape[-2:] != (3, 4):
        raise ValueError(f"pose must be [...,3,4], got {tuple(cam_pose.shape)}")
    det = torch.linalg.det(_f32(cam_pose[..., :3]))
    return torch.isfinite(det) & ((det - 1.0).abs() < atol)


def check_unit_quaternion(q: Tensor, atol: float = 1e-5) -> Tensor:
    if q.shape[-1] != 4:
        raise ValueError(f"quaternion must be [...,4], got {tuple(q.shape)}")
    return (torch.linalg.norm(_f32(q), dim=-1) - 1.0).abs() < atol


# --------------------------------- poses ---------------------------------


def invert_pose(cam_pose: Tensor) -> Tensor:
    """world2cam [R|t] -> cam2world [R^T | -R^T t]."""
    R, t = _f32(cam_pose[..., :3]), _f32(cam_pose[..., 3:])
    R_inv = R.transpose(-1, -2)
    return torch.cat([R_inv, -R_inv @ t], dim=-1).to(_dtype(cam_pose))


def compose_poses(cam_poses: list[Tensor]) -> Tensor:
    """Compose rigid transforms, ``poses[0]`` applied first."""
    first = torch.as_tensor(cam_poses[0])
    R_new, t_new = _f32(first[..., :3]), _f32(first[..., 3:])
    for pose in cam_poses[1:]:
        R, t = _f32(pose[..., :3]), _f32(pose[..., 3:])
        R_new = R @ R_new
        t_new = R @ t_new + t
    return torch.cat([R_new, t_new], dim=-1).to(first.dtype)


def get_camera_center(cam_pose: Tensor) -> Tensor:
    """The camera centre in world coordinates, -R^T t."""
    R, t = _f32(cam_pose[..., :3]), _f32(cam_pose[..., 3:])
    return (-R.transpose(-1, -2) @ t)[..., 0].to(_dtype(cam_pose))


def get_relative_poses_wrt_frame0(cam_pose: Tensor) -> Tensor:
    """Poses re-expressed in the first camera's frame (view 0 becomes [I|0])."""
    pose_ref_inv = invert_pose(cam_pose[..., 0, :, :])
    return compose_poses([pose_ref_inv[..., None, :, :], cam_pose])


# ---------------------------- point transforms ----------------------------


def to_homogeneous(points: Tensor) -> Tensor:
    return torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)


def world2camera(points: Tensor, cam_pose: Tensor) -> Tensor:
    out = _f32(to_homogeneous(points)) @ _f32(cam_pose).transpose(-1, -2)
    return out.to(_dtype(points))


def camera2world(points: Tensor, cam_pose: Tensor) -> Tensor:
    out = _f32(to_homogeneous(points)) @ _f32(invert_pose(cam_pose)).transpose(-1, -2)
    # half dtypes stay fp32, as the reference's (no second quantization)
    return out if _dtype(points) in (torch.bfloat16, torch.float16) else out.to(_dtype(points))


def camera2image(points: Tensor, cam_intr: Tensor) -> Tensor:
    return (_f32(points) @ _f32(cam_intr).transpose(-1, -2)).to(_dtype(points))


def image2camera(points: Tensor, cam_intr: Tensor) -> Tensor:
    return (_f32(points) @ torch.linalg.inv(_f32(cam_intr)).transpose(-1, -2)).to(_dtype(points))


# -------------------- intrinsics / extrinsics <-> vectors --------------------


def intrinsic_params_to_matrices(params: Tensor) -> Tensor:
    """(fx, fy, cx, cy) -> K [..., 3, 3]."""
    fx, fy, cx, cy = (params[..., i] for i in range(4))
    one, zero = torch.ones_like(fx), torch.zeros_like(fx)
    return torch.stack([
        torch.stack([fx, zero, cx], dim=-1),
        torch.stack([zero, fy, cy], dim=-1),
        torch.stack([zero, zero, one], dim=-1),
    ], dim=-2)


def intrinsic_matrices_to_params(cam_intr: Tensor) -> Tensor:
    """K -> (fx, fy, cx, cy)."""
    return torch.stack([cam_intr[..., 0, 0], cam_intr[..., 1, 1], cam_intr[..., 0, 2], cam_intr[..., 1, 2]], dim=-1)


def extrinsic_params_to_matrices(qxyzw_t: Tensor) -> Tensor:
    """(qx, qy, qz, qw, tx, ty, tz) -> world2cam [R|t]."""
    R = quaternion_to_rotation_matrix(qxyzw_t[..., :4])
    t = _f32(qxyzw_t[..., 4:7])[..., None]
    return torch.cat([R.float(), t], dim=-1).to(_dtype(qxyzw_t))


def extrinsic_matrices_to_params(cam_pose: Tensor) -> Tensor:
    """world2cam [R|t] -> (qx, qy, qz, qw, tx, ty, tz)."""
    return torch.cat([quaternion_from_rotation_matrix(cam_pose[..., :3]), cam_pose[..., 3]], dim=-1)


# ---------------------------------- rays ----------------------------------


def get_camera_rays(cam_pose: Tensor, cam_intr: Tensor, image_size: tuple[int, int]) -> Tensor:
    """Unit world-space ray directions through the pixel centres, [..., H*W, 3]."""
    H, W = image_size
    dev = cam_pose.device
    y = torch.arange(H, dtype=torch.float32, device=dev) + 0.5
    x = torch.arange(W, dtype=torch.float32, device=dev) + 0.5
    yg, xg = torch.meshgrid(y, x, indexing="ij")
    xy = torch.stack([xg, yg], dim=-1).reshape(-1, 2).expand(*cam_pose.shape[:-2], H * W, 2)
    grid_cam = image2camera(to_homogeneous(xy), cam_intr)  # the pixel centres at depth 1
    grid_world = camera2world(grid_cam, cam_pose)
    rays = _f32(grid_world) - _f32(get_camera_center(cam_pose)[..., None, :])
    rays = rays / torch.linalg.norm(rays, dim=-1, keepdim=True).clamp_min(1e-8)
    return rays.to(cam_pose.dtype)


def get_plucker_rays(cam_pose: Tensor, cam_intr: Tensor, image_size: tuple[int, int]) -> Tensor:
    """Plücker coordinates [moment | direction], [..., H*W, 6]: m = o x d
    with o the camera centre."""
    rays = get_camera_rays(cam_pose, cam_intr, image_size)
    center = get_camera_center(cam_pose)[..., None, :].expand(rays.shape)
    moment = torch.linalg.cross(_f32(center), _f32(rays), dim=-1)
    return torch.cat([moment.to(rays.dtype), rays], dim=-1)


# ---------------------------- quaternions (x, y, z, w) ----------------------------


def quaternion_normalize(q: Tensor, eps: float = 1e-8) -> Tensor:
    q32 = _f32(q)
    return (q32 / torch.linalg.norm(q32, dim=-1, keepdim=True).clamp_min(eps)).to(_dtype(q))


def quaternion_to_rotation_matrix(q: Tensor) -> Tensor:
    qx, qy, qz, qw = (_f32(q[..., i]) for i in range(4))
    r = [
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw), 2 * (qx * qz + qy * qw)],
        [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qx * qw)],
        [2 * (qx * qz - qy * qw), 2 * (qx * qw + qy * qz), 1 - 2 * (qx * qx + qy * qy)],
    ]
    return torch.stack([torch.stack(row, dim=-1) for row in r], dim=-2).to(_dtype(q))


def quaternion_from_rotation_matrix(R: Tensor, eps: float = 1e-6) -> Tensor:
    """Shepperd's method without branches: the four candidates, selected per element."""
    R32 = _f32(R)
    m00, m11, m22 = R32[..., 0, 0], R32[..., 1, 1], R32[..., 2, 2]
    trace = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(x.clamp_min(0.0) + eps)

    def m(i, j):
        return R32[..., i, j]

    s0 = safe_sqrt(trace + 1.0) * 2.0
    c0 = (0.25 * s0, (m(2, 1) - m(1, 2)) / s0, (m(0, 2) - m(2, 0)) / s0, (m(1, 0) - m(0, 1)) / s0)
    s1 = safe_sqrt(1.0 + m00 - m11 - m22) * 2.0
    c1 = ((m(2, 1) - m(1, 2)) / s1, 0.25 * s1, (m(0, 1) + m(1, 0)) / s1, (m(0, 2) + m(2, 0)) / s1)
    s2 = safe_sqrt(1.0 + m11 - m00 - m22) * 2.0
    c2 = ((m(0, 2) - m(2, 0)) / s2, (m(0, 1) + m(1, 0)) / s2, 0.25 * s2, (m(1, 2) + m(2, 1)) / s2)
    s3 = safe_sqrt(1.0 + m22 - m00 - m11) * 2.0
    c3 = ((m(1, 0) - m(0, 1)) / s3, (m(0, 2) + m(2, 0)) / s3, (m(1, 2) + m(2, 1)) / s3, 0.25 * s3)

    cond0 = trace > 0
    cond1 = ~cond0 & (m00 > m11) & (m00 > m22)
    cond2 = ~cond0 & ~cond1 & (m11 > m22)

    def select(i):  # candidate order (w, x, y, z)
        return torch.where(cond0, c0[i], torch.where(cond1, c1[i], torch.where(cond2, c2[i], c3[i])))

    q = torch.stack([select(1), select(2), select(3), select(0)], dim=-1)
    return quaternion_normalize(q).to(_dtype(R))


def quaternion_invert(q: Tensor) -> Tensor:
    """The conjugate (the inverse of a unit quaternion)."""
    return torch.cat([-q[..., :3], q[..., 3:]], dim=-1)


def quaternion_multiply(q1: Tensor, q2: Tensor) -> Tensor:
    """Hamilton product q1 (x) q2, normalized."""
    x1, y1, z1, w1 = (q1[..., i] for i in range(4))
    x2, y2, z2, w2 = (q2[..., i] for i in range(4))
    qx = w1 * x2 + w2 * x1 + y1 * z2 - z1 * y2
    qy = w1 * y2 + w2 * y1 + z1 * x2 - x1 * z2
    qz = w1 * z2 + w2 * z1 + x1 * y2 - y1 * x2
    qw = w1 * w2 - (x1 * x2 + y1 * y2 + z1 * z2)
    return quaternion_normalize(torch.stack([qx, qy, qz, qw], dim=-1))


# ---------------------------- volume rendering ----------------------------


def sample_dists(
    near: Tensor, far: Tensor, num_samples: int, *, stratified: bool = False,
    generator: Optional[torch.Generator] = None,
) -> Tensor:
    """Distances along rays in [near, far): midpoints, or with ``stratified``
    one uniform draw per bin from ``generator`` (required then)."""
    shape = (*near.shape[:-1], num_samples)
    if stratified:
        if generator is None:
            raise ValueError("stratified sampling needs an explicit generator")
        rands = torch.rand(shape, generator=generator, device=near.device)
    else:
        rands = torch.full(shape, 0.5, device=near.device)
    rands = (rands + torch.arange(num_samples, dtype=torch.float32, device=near.device)) / num_samples
    return rands * (_f32(far) - _f32(near)) + _f32(near)


def volume_rendering_alphas(densities: Tensor, dists: Tensor, dist_far: Optional[Tensor] = None) -> Tensor:
    """Quadrature alphas 1 - exp(-sigma delta)."""
    if dist_far is None:
        dist_far = torch.full_like(dists[..., :1, :], 1e10)
    d = torch.cat([dists, dist_far], dim=-2)
    return 1.0 - torch.exp(-densities * (d[..., 1:, :] - d[..., :-1, :]))


def alpha_compositing_weights(alphas: Tensor) -> Tensor:
    """w_i = alpha_i prod_{j<i} (1 - alpha_j), the product in fp32."""
    alphas_front = torch.cat([torch.zeros_like(alphas[..., :1, :]), alphas[..., :-1, :]], dim=-2)
    visibility = torch.cumprod(_f32(1.0 - alphas_front), dim=-2)
    return (alphas * visibility).to(alphas.dtype)


def composite(quantities: Tensor, weights: Tensor) -> Tensor:
    """The weighted sum over the sample axis."""
    return (quantities * weights).sum(dim=-2)


def volume_render_rays(
    nerf: Callable[[Tensor, Tensor], tuple[Tensor, Tensor]],
    center: Tensor,
    ray_unit: Tensor,
    near: Tensor,
    far: Tensor,
    num_samples: int,
    *,
    stratified: bool = False,
    solid_background: bool = False,
    generator: Optional[torch.Generator] = None,
) -> tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Volume-render rays through a radiance field ``nerf(points, ray_dirs)
    -> (rgbs [..., N, 3], densities [..., N, 1])``. Returns (rgb, opacity,
    weights, points, dists); the sample distances carry no gradient."""
    dists = sample_dists(near, far, num_samples, stratified=stratified, generator=generator).detach()
    points = center[..., None, :] + ray_unit[..., None, :] * dists[..., None]
    ray_dirs = ray_unit[..., None, :].expand(points.shape)
    rgbs, densities = nerf(points, ray_dirs)
    dist_far = None if solid_background else far[..., None]
    alphas = volume_rendering_alphas(densities, dists[..., None], dist_far=dist_far)
    weights = alpha_compositing_weights(alphas)
    opacity = composite(torch.ones_like(weights), weights)
    rgb = composite(rgbs, weights)
    return rgb, opacity, weights, points, dists

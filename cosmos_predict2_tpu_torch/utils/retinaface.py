"""RetinaFace-ResNet50 face detector for the face-blur guardrail.

Counterpart of cosmos_predict2_tpu/utils/retinaface.py. The reference runs
RetinaFace with the public ``Resnet50_Final.pth`` checkpoint
(imaginaire/auxiliary/guardrail/face_blur_filter/face_blur_filter.py:53-80),
the biubug6/Pytorch_Retinaface architecture (cfg_re50: min_sizes
[[16,32],[64,128],[256,512]], steps [8,16,32], variance [0.1,0.2], FPN/SSH
out_channel 256).

:class:`RetinaFace` is an ``nn.Module`` of ``F.conv2d`` calls (NCHW,
cuDNN on a card; the JAX package runs them as ``lax.conv``), every
BatchNorm folded into its conv at conversion, as the JAX package's
``_fold_bn`` folds it: inference only. Its keys are the public
checkpoint's with the BatchNorms gone (``body.conv1``,
``body.layer{1-4}.{i}.conv{1-3}`` and ``.downsample``,
``fpn.{output1-3,merge1,merge2}``, ``ssh{1-3}.{conv3X3,...}``,
``{Class,Bbox,Landmark}Head.{0-2}``), each a conv with a bias. Prior-box
generation, box decoding, confidence filtering and NMS run on the host in
numpy, the JAX package's code as it is (the reference's
retinaface_utils.py:24-117).

Weight import: :func:`convert_retinaface_state_dict` takes the public
checkpoint's state dict; :func:`retinaface_params_to_state_dict` the JAX
package's parameter tree (for the tests).
"""

from __future__ import annotations

import math
from typing import Any, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

MIN_SIZES = ((16, 32), (64, 128), (256, 512))
STEPS = (8, 16, 32)
VARIANCE = (0.1, 0.2)
NUM_ANCHORS = 2
# BGR channel means, matching the reference preprocess (detect.py upstream)
BGR_MEAN = (104.0, 117.0, 123.0)
# (blocks, stride) of ResNet-50's layer1..layer4
RESNET50_LAYERS = ((3, 1), (4, 2), (6, 2), (3, 2))
SSH_CONVS = ("conv3X3", "conv5X5_1", "conv5X5_2", "conv7X7_2", "conv7x7_3")
HEADS = {"ClassHead": 2, "BboxHead": 4, "LandmarkHead": 10}


# --------------------------------- module ---------------------------------


def _conv(conv: nn.Conv2d, x: torch.Tensor, relu: bool = False) -> torch.Tensor:
    out = F.conv2d(x, conv.weight, conv.bias, conv.stride, conv.padding)
    return F.relu(out) if relu else out


class _Bottleneck(nn.Module):
    def __init__(self, cin: int, width: int, stride: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, width, 1)
        self.conv2 = nn.Conv2d(width, width, 3, stride, 1)
        self.conv3 = nn.Conv2d(width, 4 * width, 1)
        self.downsample = nn.Conv2d(cin, 4 * width, 1, stride) if stride != 1 or cin != 4 * width else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = _conv(self.conv2, _conv(self.conv1, x, relu=True), relu=True)
        h = _conv(self.conv3, h)
        sc = x if self.downsample is None else _conv(self.downsample, x)
        return F.relu(h + sc)


class _Body(nn.Module):
    """ResNet-50's stem and layer1..4; returns (C3, C4, C5)."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3)
        cin = 64
        for li, (n_blocks, stride) in enumerate(RESNET50_LAYERS, start=1):
            width = 64 * 2 ** (li - 1)
            blocks = []
            for bi in range(n_blocks):
                blocks.append(_Bottleneck(cin, width, stride if bi == 0 else 1))
                cin = 4 * width
            setattr(self, f"layer{li}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, ...]:
        h = F.max_pool2d(_conv(self.conv1, x, relu=True), 3, 2, 1)
        h = self.layer1(h)
        c3 = self.layer2(h)
        c4 = self.layer3(c3)
        return c3, c4, self.layer4(c4)


def _nearest_to(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Nearest resize of NCHW x to (h, w), the JAX package's index rule."""
    H, W = x.shape[2:]
    rows = torch.arange(h, device=x.device) * H // h
    cols = torch.arange(w, device=x.device) * W // w
    return x[:, :, rows][:, :, :, cols]


class _FPN(nn.Module):
    def __init__(self, out: int = 256):
        super().__init__()
        self.output1, self.output2, self.output3 = (nn.Conv2d(c, out, 1) for c in (512, 1024, 2048))
        self.merge1, self.merge2 = nn.Conv2d(out, out, 3, 1, 1), nn.Conv2d(out, out, 3, 1, 1)

    def forward(self, c3, c4, c5):
        o1, o2, o3 = (_conv(m, c, relu=True) for m, c in ((self.output1, c3), (self.output2, c4), (self.output3, c5)))
        o2 = _conv(self.merge2, o2 + _nearest_to(o3, *o2.shape[2:]), relu=True)
        o1 = _conv(self.merge1, o1 + _nearest_to(o2, *o1.shape[2:]), relu=True)
        return o1, o2, o3


class _SSH(nn.Module):
    def __init__(self, cin: int = 256, out: int = 256):
        super().__init__()
        self.conv3X3 = nn.Conv2d(cin, out // 2, 3, 1, 1)
        self.conv5X5_1 = nn.Conv2d(cin, out // 4, 3, 1, 1)
        self.conv5X5_2 = nn.Conv2d(out // 4, out // 4, 3, 1, 1)
        self.conv7X7_2 = nn.Conv2d(out // 4, out // 4, 3, 1, 1)
        self.conv7x7_3 = nn.Conv2d(out // 4, out // 4, 3, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c51 = _conv(self.conv5X5_1, x, relu=True)
        c7 = _conv(self.conv7x7_3, _conv(self.conv7X7_2, c51, relu=True))
        return F.relu(torch.cat([_conv(self.conv3X3, x), _conv(self.conv5X5_2, c51), c7], dim=1))


class RetinaFace(nn.Module):
    """x (B, 3, H, W) float32, BGR mean-subtracted -> (loc (B, P, 4),
    conf softmax (B, P, 2), landm (B, P, 10)), P the priors of the three
    FPN levels in the public model's order."""

    def __init__(self):
        super().__init__()
        self.body = _Body()
        self.fpn = _FPN()
        self.ssh1, self.ssh2, self.ssh3 = _SSH(), _SSH(), _SSH()
        for head, n in HEADS.items():
            setattr(self, head, nn.ModuleList(nn.Conv2d(256, NUM_ANCHORS * n, 1) for _ in range(3)))

    def forward(self, x: torch.Tensor):
        feats = self.fpn(*self.body(x))
        feats = [ssh(f) for ssh, f in zip((self.ssh1, self.ssh2, self.ssh3), feats)]
        # the public model permutes each head's NCHW output to NHWC, then flattens
        out = {head: torch.cat([_conv(getattr(self, head)[i], f).permute(0, 2, 3, 1).reshape(f.shape[0], -1, n)
                                for i, f in enumerate(feats)], dim=1) for head, n in HEADS.items()}
        return out["BboxHead"], out["ClassHead"].softmax(dim=-1), out["LandmarkHead"]


def build_retinaface(device: torch.device | str = "cuda", seed: Optional[int] = 0) -> RetinaFace:
    """RetinaFace-ResNet50 in fp32, built on the meta device and materialised
    on ``device``; ``seed`` draws seeded weights there
    (text_encoders/common.py::init_weights), the stem's scaled by 1/128 so
    that it takes the BGR range (+-128) to unit scale, as the trained
    model's first BatchNorm does (else the logits reach ~35 and every score
    saturates); ``None`` leaves them for a checkpoint
    (:func:`convert_retinaface_state_dict`)."""
    from cosmos_predict2_tpu_torch.text_encoders.common import build_tower

    module = build_tower(RetinaFace, device, torch.float32, seed)
    if seed is not None:
        module.body.conv1.weight.data.mul_(1.0 / 128)
    return module


# ------------------------------ host-side box math ------------------------------


def prior_boxes(image_h: int, image_w: int) -> np.ndarray:
    """Anchor priors in center-offset form (P, 4), normalized; clip=False."""
    anchors = []
    for k, step in enumerate(STEPS):
        fh, fw = math.ceil(image_h / step), math.ceil(image_w / step)
        for i in range(fh):
            for j in range(fw):
                for m in MIN_SIZES[k]:
                    s_kx, s_ky = m / image_w, m / image_h
                    cx = (j + 0.5) * step / image_w
                    cy = (i + 0.5) * step / image_h
                    anchors.append((cx, cy, s_kx, s_ky))
    return np.asarray(anchors, dtype=np.float32)


def decode_boxes(loc: np.ndarray, priors: np.ndarray) -> np.ndarray:
    """Reference decode (retinaface_utils.py:47-117) on (P, 4) arrays."""
    centers = priors[:, :2] + loc[:, :2] * VARIANCE[0] * priors[:, 2:]
    sizes = priors[:, 2:] * np.exp(loc[:, 2:] * VARIANCE[1])
    boxes = np.concatenate([centers - sizes / 2, centers + sizes / 2], axis=1)
    return boxes


def nms(dets: np.ndarray, threshold: float) -> list[int]:
    """Plain numpy NMS (reference py_cpu_nms)."""
    x1, y1, x2, y2, scores = dets[:, 0], dets[:, 1], dets[:, 2], dets[:, 3], dets[:, 4]
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = int(order[0])
        keep.append(i)
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        w = np.maximum(0.0, xx2 - xx1 + 1)
        h = np.maximum(0.0, yy2 - yy1 + 1)
        inter = w * h
        iou = inter / (areas[i] + areas[order[1:]] - inter)
        order = order[1:][iou <= threshold]
    return keep


def filter_boxes(
    boxes: np.ndarray,
    scores: np.ndarray,
    confidence_threshold: float = 0.7,
    nms_threshold: float = 0.4,
    top_k: int = 5000,
    keep_top_k: int = 750,
) -> np.ndarray:
    """Reference filter_detected_boxes (retinaface_utils.py:24-45)."""
    inds = np.where(scores > confidence_threshold)[0]
    boxes, scores = boxes[inds], scores[inds]
    order = scores.argsort()[::-1][:top_k]
    boxes, scores = boxes[order], scores[order]
    dets = np.hstack((boxes, scores[:, None])).astype(np.float32, copy=False)
    keep = nms(dets, nms_threshold)
    return dets[keep, :][:keep_top_k, :4]


class RetinaFaceDetector:
    """Callable (H, W, 3) uint8 RGB frame -> [(x0, y0, x1, y1), ...]: the
    module on its device, one frame a call, then the host's box math."""

    def __init__(self, module: RetinaFace, confidence_threshold: float = 0.7, nms_threshold: float = 0.4):
        self.module = module.eval()
        self.confidence_threshold = confidence_threshold
        self.nms_threshold = nms_threshold
        self.device = next(module.parameters()).device
        self._priors: dict[tuple[int, int], np.ndarray] = {}

    @torch.no_grad()
    def forward(self, frame_u8: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """One frame through the module -> (loc (P, 4), face score (P,)) on the host."""
        bgr = frame_u8[..., ::-1].astype(np.float32) - np.asarray(BGR_MEAN, np.float32)
        x = torch.from_numpy(np.ascontiguousarray(bgr.transpose(2, 0, 1)))[None].to(self.device)
        loc, conf, _ = self.module(x)
        return loc[0].cpu().numpy(), conf[0, :, 1].cpu().numpy()

    def boxes(self, loc: np.ndarray, scores: np.ndarray, h: int, w: int) -> list:
        """The host's box math: decode against the (h, w) priors, filter,
        NMS, clip to the frame and round down to ints."""
        if (h, w) not in self._priors:
            self._priors[(h, w)] = prior_boxes(h, w)
        boxes = decode_boxes(loc, self._priors[(h, w)]) * np.asarray([w, h, w, h], np.float32)
        kept = filter_boxes(boxes, scores, self.confidence_threshold, self.nms_threshold)
        return [(int(max(0, x0)), int(max(0, y0)), int(min(w, x1)), int(min(h, y1))) for x0, y0, x1, y1 in kept]

    def __call__(self, frame_u8: np.ndarray) -> list:
        h, w = frame_u8.shape[:2]
        return self.boxes(*self.forward(frame_u8), h, w)


# ------------------------------- weight import -------------------------------


def _array(v: Any) -> np.ndarray:
    return (v.detach().float().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)).astype(np.float32)


def _fold_bn(w_oihw, bn_w, bn_b, bn_mean, bn_var, eps: float = 1e-5) -> tuple[np.ndarray, np.ndarray]:
    """Conv OIHW + BatchNorm running stats -> (OIHW weight scaled per output
    channel, bias)."""
    scale = _array(bn_w) / np.sqrt(_array(bn_var) + eps)
    return _array(w_oihw) * scale[:, None, None, None], _array(bn_b) - _array(bn_mean) * scale


def _conv_names() -> list[tuple[str, str, str]]:
    """(port key, public checkpoint conv key, its BatchNorm key or "") for
    every conv of the model."""
    names = [("body.conv1", "body.conv1", "body.bn1")]
    for li, (n_blocks, _) in enumerate(RESNET50_LAYERS, start=1):
        for bi in range(n_blocks):
            pre = f"body.layer{li}.{bi}"
            names += [(f"{pre}.conv{i}", f"{pre}.conv{i}", f"{pre}.bn{i}") for i in (1, 2, 3)]
            names.append((f"{pre}.downsample", f"{pre}.downsample.0", f"{pre}.downsample.1"))
    # the fpn and ssh convs are nn.Sequential(conv, bn[, relu]): keys .0 / .1
    names += [(f"fpn.{n}", f"fpn.{n}.0", f"fpn.{n}.1") for n in ("output1", "output2", "output3", "merge1", "merge2")]
    names += [(f"ssh{i}.{n}", f"ssh{i}.{n}.0", f"ssh{i}.{n}.1") for i in (1, 2, 3) for n in SSH_CONVS]
    names += [(f"{head}.{i}", f"{head}.{i}.conv1x1", "") for head in HEADS for i in range(3)]
    return names


def convert_retinaface_state_dict(sd: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The public Resnet50_Final.pth state dict (tensors or arrays; a
    ``module.`` prefix is dropped) -> :class:`RetinaFace`'s, fp32."""
    sd = {k.removeprefix("module."): v for k, v in sd.items()}
    out: dict[str, torch.Tensor] = {}
    for port, conv, bn in _conv_names():
        if f"{conv}.weight" not in sd and port.endswith("downsample"):
            continue  # a block without a projection shortcut
        if bn:
            w, b = _fold_bn(sd[f"{conv}.weight"], *(sd[f"{bn}.{n}"] for n in ("weight", "bias", "running_mean",
                                                                                 "running_var")))
        else:
            w, b = _array(sd[f"{conv}.weight"]), _array(sd[f"{conv}.bias"])
        out[f"{port}.weight"], out[f"{port}.bias"] = torch.from_numpy(w), torch.from_numpy(b)
    return out


def retinaface_params_to_state_dict(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The JAX package's parameter tree (NumPy arrays; HWIO weights, a
    per-channel scale and bias) -> :class:`RetinaFace`'s state dict, the
    scale folded into the weight."""

    def node(port: str) -> Mapping[str, Any]:
        parts = port.split(".")
        if port == "body.conv1":
            return params["body"]["stem"]
        if parts[0] == "body":
            return params["body"][parts[1]][f"b{parts[2]}"][parts[3]]
        if parts[0] in HEADS:
            return params[parts[0]][int(parts[1])]
        return params[parts[0]][parts[1]]

    out: dict[str, torch.Tensor] = {}
    for port, _, _ in _conv_names():
        try:
            p = node(port)
        except KeyError:
            continue  # a block without a projection shortcut
        w = np.transpose(_array(p["w"]), (3, 2, 0, 1)) * _array(p["scale"])[:, None, None, None]
        out[f"{port}.weight"] = torch.from_numpy(np.ascontiguousarray(w))
        out[f"{port}.bias"] = torch.from_numpy(_array(p["bias"]))
    return out

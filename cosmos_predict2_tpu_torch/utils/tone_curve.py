"""Tone mapping and background-recoloring for synthetic-asset data prep.

The port's copy of cosmos_predict2_tpu/utils/tone_curve.py, the counterpart
of the reference's host-side image-conditioning utilities
(imaginaire/utils/tone_curve.py:23-197, replace_bg_color.py:25-106) used
by its object/asset data pipelines. Pure NumPy on the host: this is IO-side
pixel conditioning, not device compute, as in the reference, where these
never touch CUDA.

The math is the standard set: IEC 61966-2-1 sRGB transfer, the Khronos
"commerce" neutral tonemap, and OIDN-style log-average autoexposure.
Array-first API: every routine takes (..., 3[/4]) float arrays; thin PIL
adapters at the bottom (PIL imported inside them) keep the reference's
call shapes.
"""

from __future__ import annotations

import math
from typing import Literal, Sequence

import numpy as np

# ------------------------------ transfer ------------------------------


def srgb_to_linear(srgb: np.ndarray) -> np.ndarray:
    """IEC 61966-2-1 decode; any shape, values in [0, 1]."""
    srgb = np.asarray(srgb)
    return np.where(srgb > 0.04045, ((srgb + 0.055) / 1.055) ** 2.4, srgb / 12.92)


def linear_to_srgb(lin: np.ndarray) -> np.ndarray:
    """IEC 61966-2-1 encode; any shape, values in [0, 1]."""
    lin = np.asarray(lin)
    return np.where(lin > 0.0031308, 1.055 * np.maximum(lin, 0.0) ** (1.0 / 2.4) - 0.055, 12.92 * lin)


# aliases matching the reference's names (tone_curve.py:23,35)
srgb2lin = srgb_to_linear
lin2srgb = linear_to_srgb


def luminance(rgb: np.ndarray) -> np.ndarray:
    """Rec.709 luminance of (..., 3) linear RGB (tone_curve.py:73-74)."""
    return rgb[..., 0] * 0.212671 + rgb[..., 1] * 0.715160 + rgb[..., 2] * 0.072169


# ------------------------------ tonemap ------------------------------


def commerce_tonemap(color: np.ndarray) -> np.ndarray:
    """Khronos PBR neutral tone mapper on (..., 3) linear RGB
    (tone_curve.py:47-66): black-level offset, Reinhard-style peak
    compression above the knee, and desaturation toward the new peak.
    """
    color = np.asarray(color, dtype=np.float32).copy()
    knee = 0.8 - 0.04
    desat = 0.15

    lo = np.min(color, axis=-1, keepdims=True)
    color -= np.where(lo < 0.08, lo - 6.25 * lo * lo, 0.04)

    peak = np.max(color, axis=-1, keepdims=True)
    d = 1.0 - knee
    new_peak = 1.0 - d * d / (peak + d - knee)
    with np.errstate(divide="ignore", invalid="ignore"):
        scaled = color * (new_peak / peak)
    g = 1.0 - 1.0 / (desat * (peak - new_peak) + 1.0)
    compressed = scaled * (1.0 - g) + new_peak * g
    return np.where(peak < knee, color, compressed)


def autoexposure(image: np.ndarray, mask: np.ndarray, key: float = 0.18) -> float:
    """OIDN-style autoexposure on (H, W, 3) linear RGB with an (H, W, 1)
    coverage mask (tone_curve.py:78-114): 16x16 mean-binned luminance,
    coverage-normalized, exposure = key / geometric-mean(L).
    """
    bin_size = 16
    eps = 1e-8
    lum = luminance(np.asarray(image) * np.asarray(mask))
    m = np.asarray(mask)[..., 0]

    crop_h = lum.shape[0] // bin_size * bin_size
    crop_w = lum.shape[1] // bin_size * bin_size
    top = round((lum.shape[0] - crop_h) / 2)
    left = round((lum.shape[1] - crop_w) / 2)
    lum = lum[top : top + crop_h, left : left + crop_w]
    m = m[top : top + crop_h, left : left + crop_w]

    lum = lum.reshape(crop_h // bin_size, bin_size, crop_w // bin_size, bin_size).mean(axis=(1, 3))
    m = m.reshape(crop_h // bin_size, bin_size, crop_w // bin_size, bin_size).mean(axis=(1, 3))
    with np.errstate(divide="ignore", invalid="ignore"):
        lum = lum / m
    lum = lum[m > eps]
    lum = lum[lum > eps]
    if lum.size == 0:
        return 1.0
    return float(key / np.exp2(np.log2(lum).mean()))


def apply_tone_curve_array(
    rgba: np.ndarray,
    input_mapping: Literal["log", "straight"] = "log",
    output_mapping: Literal["commerce", "straight", "log"] = "commerce",
    exposure_bias: float = 1.5,
    auto: bool = True,
    ae_pregain: float = 1.0,
    ae_key: float = 0.18,
    ae_strength_below: float = 1.0,
    ae_strength_above: float = 1.0,
) -> tuple[np.ndarray, float]:
    """Joint exposure adjustment of one (H, W, 4) float [0,1] RGBA stack
    (tone_curve.py:118-183; "log" input for cam_v1 renders, "straight"
    for cam_v2). Returns (adjusted rgba float array, exposure used).
    """
    rgba = np.asarray(rgba, dtype=np.float32)
    mask = rgba[..., 3:4]
    img = srgb_to_linear(rgba[..., :3])

    if input_mapping == "log":
        img = np.exp(img) - 1.0
    elif input_mapping != "straight":
        raise NotImplementedError(f"Unknown input_mapping: {input_mapping}")

    if auto:
        img = img * ae_pregain
        log_exp = math.log2(autoexposure(img, mask, key=ae_key))
        log_exp *= ae_strength_below if log_exp <= 0 else ae_strength_above
        exposure = 2.0**log_exp
    else:
        exposure = 1.0
    exposure *= exposure_bias
    img = img * exposure

    if output_mapping == "commerce":
        img = commerce_tonemap(img)
    elif output_mapping == "log":
        img = np.log(img + 1.0)
    elif output_mapping != "straight":
        raise NotImplementedError(f"Unknown output_mapping: {output_mapping}")

    return np.concatenate([linear_to_srgb(img), mask], axis=-1), exposure


def replace_bg_color_u8(
    fg: np.ndarray, fg_mask: np.ndarray, bg_color_old: Sequence[int], bg_color_new: Sequence[int]
) -> np.ndarray:
    """Swap a rendered asset's background color in LINEAR light
    (replace_bg_color.py:49-69): add (new - old) scaled by background
    coverage, so anti-aliased edges blend correctly. All uint8 in/out;
    fg (..., 3), fg_mask (..., 1) with 255 = full foreground.
    """
    assert fg.dtype == np.uint8 and fg_mask.dtype == np.uint8
    bg_cover = 1.0 - fg_mask.astype(np.float32) / 255.0
    old = srgb_to_linear(np.asarray(bg_color_old, np.float32) / 255.0)
    new = srgb_to_linear(np.asarray(bg_color_new, np.float32) / 255.0)
    lin = srgb_to_linear(fg.astype(np.float32) / 255.0) + bg_cover * (new - old)
    return np.clip((linear_to_srgb(lin) * 255.0).round(), 0, 255).astype(np.uint8)


# ------------------------------ PIL adapters ------------------------------


def apply_tone_curve(imgs: list, **kwargs) -> tuple[list, float]:
    """PIL-list adapter with the reference's exact signature
    (tone_curve.py:118). Images are stacked along H (processed jointly,
    one shared exposure), adjusted, and split back."""
    from PIL import Image

    arr = np.concatenate([np.asarray(im) for im in imgs], axis=0).astype(np.float32) / 255.0
    out, exposure = apply_tone_curve_array(arr, **kwargs)
    out = np.clip((out * 255.0).round(), 0, 255).astype(np.uint8)
    return [Image.fromarray(x) for x in np.split(out, len(imgs), axis=0)], exposure


def apply_exposure(img, exposure: float):
    """Exposure-only adjust of one PIL RGB(A) image (tone_curve.py:186-196)."""
    from PIL import Image

    arr = np.asarray(img).astype(np.float32) / 255.0
    arr[..., :3] = linear_to_srgb(srgb_to_linear(arr[..., :3]) * exposure)
    return Image.fromarray(np.clip((arr * 255.0).round(), 0, 255).astype(np.uint8))


def replace_bg_color_pil(fg_pil, fg_mask_pil, bg_color_old, bg_color_new):
    """PIL adapter for replace_bg_color_u8 (replace_bg_color.py:71-80)."""
    from PIL import Image

    mask = np.array(fg_mask_pil)
    mask = mask[..., None] if mask.ndim == 2 else mask[..., :1]
    return Image.fromarray(replace_bg_color_u8(np.array(fg_pil), mask, bg_color_old, bg_color_new))

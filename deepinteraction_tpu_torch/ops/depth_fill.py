"""Multi-scale depth completion (ip_basic ``fill_in_multiscale``), port of
``deepinteraction_tpu/ops/depth_fill.py`` with its cv2 conventions:

- dilation / erosion: max / min over a structuring element, -inf / +inf pad;
- 5x5 median blur with replicate pad;
- 5x5 bilateral filter (sigma_color 0.5, sigma_space 2) with reflect-101 pad;
- the reference quirks: the stale pre-median ``valid`` mask reused for the
  bilateral write-back, and top_row 0 for an empty column;
- the JAX package's lite form (``lite=True``, ``DI_DEPTH_FILL_LITE``).

Maps are [..., H, W].
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

FULL_5 = np.ones((5, 5), np.float32)
FULL_9 = np.ones((9, 9), np.float32)


def _cross(n):
    k = np.zeros((n, n), np.float32)
    k[n // 2, :] = 1
    k[:, n // 2] = 1
    return k


CROSS_3 = _cross(3)
CROSS_5 = _cross(5)
CROSS_7 = _cross(7)


def _pad2d(img: torch.Tensor, r: int, mode: str, value: float = 0.0) -> torch.Tensor:
    """Pad the last two dims by r (F.pad wants a channel dim for non-constant
    modes)."""
    lead = img.shape[:-2]
    x = img.reshape(-1, 1, *img.shape[-2:])
    if mode == "constant":
        x = F.pad(x, (r, r, r, r), value=value)
    else:
        x = F.pad(x, (r, r, r, r), mode=mode)
    return x.reshape(*lead, *x.shape[-2:])


def _window_reduce(img, kernel_mask, op, pad_value):
    kh, kw = kernel_mask.shape
    h, w = img.shape[-2:]
    p = _pad2d(img, kh // 2, "constant", pad_value)
    out = None
    for dy in range(kh):
        for dx in range(kw):
            if kernel_mask[dy, dx] == 0:
                continue
            sl = p[..., dy : dy + h, dx : dx + w]
            out = sl if out is None else op(out, sl)
    return out


def dilate(img, kernel):
    return _window_reduce(img, kernel, torch.maximum, -math.inf)


def erode(img, kernel):
    return _window_reduce(img, kernel, torch.minimum, math.inf)


def median5(img):
    h, w = img.shape[-2:]
    p = _pad2d(img, 2, "replicate")
    taps = [p[..., dy : dy + h, dx : dx + w] for dy in range(5) for dx in range(5)]
    return torch.sort(torch.stack(taps, -1), -1).values[..., 12]


def bilateral5(img, sigma_color=0.5, sigma_space=2.0):
    h, w = img.shape[-2:]
    p = _pad2d(img, 2, "reflect")
    num = torch.zeros_like(img)
    den = torch.zeros_like(img)
    cc = -0.5 / (sigma_color**2)
    sc = -0.5 / (sigma_space**2)
    for dy in range(5):
        for dx in range(5):
            r2 = (dy - 2) ** 2 + (dx - 2) ** 2
            if r2 > 4:  # OpenCV skips taps outside the radius-2 circle
                continue
            tap = p[..., dy : dy + h, dx : dx + w]
            wgt = torch.exp(cc * (tap - img) ** 2) * float(np.float32(np.exp(sc * r2)))
            num = num + wgt * tap
            den = den + wgt
    return num / torch.clamp(den, min=1e-20)


def _top_mask(valid: torch.Tensor) -> torch.Tensor:
    """rows >= the first valid row of each column (0 for an empty column)."""
    h = valid.shape[-2]
    rows = torch.arange(h, device=valid.device)[:, None]
    first = torch.where(valid, rows, torch.full_like(rows, h)).amin(-2)
    top_row = torch.where(first == h, torch.zeros_like(first), first)
    return rows >= top_row[..., None, :]


def fill_in_multiscale(depth: torch.Tensor, max_depth: float = 100.0, lite: bool = False) -> torch.Tensor:
    """Dense depth from sparse depth, [..., H, W] -> [..., H, W]
    (extrapolate=False, blur_type='bilateral', the reference's call-site
    settings).

    ``lite`` is the JAX package's ``DI_DEPTH_FILL_LITE`` (BEVWarp applies it
    in eval only): 2 hole-extension dilations instead of 6, and no final
    median or bilateral pass."""
    d_in = depth if depth.is_floating_point() else depth.float()
    near = (d_in > 0.1) & (d_in <= 15.0)
    med = (d_in > 15.0) & (d_in <= 30.0)
    far = d_in > 30.0

    valid = d_in > 0.1
    s1 = torch.where(valid, max_depth - d_in, d_in)

    dil_far = dilate(s1 * far, CROSS_3)
    dil_med = dilate(s1 * med, CROSS_5)
    dil_near = dilate(s1 * near, CROSS_7)

    s2 = s1
    s2 = torch.where(dil_far > 0.1, dil_far, s2)
    s2 = torch.where(dil_med > 0.1, dil_med, s2)
    s2 = torch.where(dil_near > 0.1, dil_near, s2)

    s3 = erode(dilate(s2, FULL_5), FULL_5)

    s4 = torch.where(s3 > 0.1, median5(s3), s3)

    empty = (~(s4 > 0.1)) & _top_mask(s4 > 0.1)
    s5 = torch.where(empty, dilate(s4, FULL_9), s4)

    top_mask = _top_mask(s5 > 0.1)
    s7 = s5
    for _ in range(2 if lite else 6):
        empty = (s7 < 0.1) & top_mask
        s7 = torch.where(empty, dilate(s7, FULL_5), s7)

    if not lite:
        blur = median5(s7)
        valid = (s7 > 0.1) & top_mask
        s7 = torch.where(valid, blur, s7)
        # reference quirk: the bilateral write-back reuses the pre-median mask
        s7 = torch.where(valid, bilateral5(s7, 0.5, 2.0), s7)

    return torch.where(s7 > 0.1, max_depth - s7, s7)

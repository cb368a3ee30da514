"""Optional image augmentations, on the images' device (port of
``deepinteraction_tpu/data/extra_transforms.py``).

Rebuilds of the remaining reference PIPELINES
(datasets/pipelines/transform_3d.py):

- ``photometric_distortion``: PhotoMetricDistortionMultiViewImage (L144-241)
  — random brightness / contrast (two orderings) / saturation / hue /
  channel swap, same ranges and probability structure as mmdet.
- ``random_resize``: the Waymo-oriented MyResize (L243+) generalized —
  resize every view by a ratio drawn from ``ratio_range`` and fold the
  scale into lidar2img.
- ``random_scale`` / ``rescale_keep_ratio`` / ``resize_multiview``: the full
  MyResize semantics (transform_3d.py:313-590) — the three multiscale
  selection modes (ratio_range / "range" / "value"), mmcv ``imrescale``
  keep-ratio scaling, per-axis scale_factor, and 2D bbox resize + border
  clip.
- ``pad_waymo_view``: LoadMultiViewImageFromFilesWaymo.pad (L258-262) —
  zero-pad short (886-row) Waymo views to the common 1280-row height.

Images are float32 RGB torch tensors in 0-255, [V, H, W, 3] or a sequence
of [H, W, 3], on any device; the transforms run there. The matrices,
scale factors and 2D boxes stay numpy on the host. The random draws come
from a numpy ``Generator`` in the JAX package's order, so one seed gives
the same distortion and scale. Where JAX calls cv2, this module has its
arithmetic in torch: ``cv2.resize(INTER_LINEAR)`` is ``F.interpolate``
bilinear with half-pixel centres and no antialias (as ``ops/images.py``),
and ``cvtColor`` RGB<->HSV on float32 is written out with cv2's formulas
(H in degrees, S in [0, 1], V in the input's scale, HSV->RGB by cv2's
sector table).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

FLT_EPSILON = float(np.finfo(np.float32).eps)
# cv2's HSV->RGB sector table: for each 60-degree sector the entries of
# (v, v(1-s), v(1-s f), v(1-s(1-f))) that B, G and R take
_SECTORS = ((1, 3, 0), (1, 0, 2), (3, 0, 1), (0, 2, 1), (0, 1, 3), (2, 1, 0))


def _rgb_to_hsv(img: torch.Tensor) -> torch.Tensor:
    """``cv2.cvtColor(img, COLOR_RGB2HSV)`` on float32 [..., 3]."""
    r, g, b = img.unbind(-1)
    v = torch.maximum(torch.maximum(r, g), b)
    vmin = torch.minimum(torch.minimum(r, g), b)
    diff = v - vmin
    s = diff / (v.abs() + FLT_EPSILON)
    d = 60.0 / (diff + FLT_EPSILON)
    h = torch.where(v == r, (g - b) * d, torch.where(v == g, (b - r) * d + 120.0, (r - g) * d + 240.0))
    h = torch.where(h < 0, h + 360.0, h)
    return torch.stack([h, s, v], -1)


def _hsv_to_rgb(img: torch.Tensor) -> torch.Tensor:
    """``cv2.cvtColor(img, COLOR_HSV2RGB)`` on float32 [..., 3], H in
    degrees."""
    h, s, v = img.unbind(-1)
    h = h * np.float32(6.0 / 360.0)
    h = h - torch.floor(h / 6.0) * 6.0
    sector = torch.floor(h)
    f = h - sector
    sector = sector.long()
    bad = (sector < 0) | (sector >= 6)
    sector = torch.where(bad, 0, sector)
    f = torch.where(bad, 0.0, f)
    tab = torch.stack([v, v * (1.0 - s), v * (1.0 - s * f), v * (1.0 - s * (1.0 - f))], -1)
    idx = torch.tensor(_SECTORS, device=img.device)[sector]  # [..., 3]: B, G, R
    bgr = torch.gather(tab, -1, idx)
    rgb = bgr.flip(-1)
    return torch.where((s == 0)[..., None], v[..., None].expand_as(rgb), rgb)


def photometric_distortion(
    images: torch.Tensor,  # [V, H, W, 3] float32, 0-255 RGB (pre-normalize)
    rng: np.random.Generator,
    brightness_delta: float = 32.0,
    contrast_range: Tuple[float, float] = (0.5, 1.5),
    saturation_range: Tuple[float, float] = (0.5, 1.5),
    hue_delta: float = 18.0,
) -> torch.Tensor:
    """All views get the SAME draw (the reference distorts each view with
    one transform instance per sample)."""
    out = images.float().clone()

    if rng.integers(2):
        out += rng.uniform(-brightness_delta, brightness_delta)

    contrast_first = bool(rng.integers(2))
    alpha = rng.uniform(*contrast_range) if rng.integers(2) else None
    if contrast_first and alpha is not None:
        out *= alpha

    do_sat = bool(rng.integers(2))
    sat = rng.uniform(*saturation_range)
    do_hue = bool(rng.integers(2))
    hue = rng.uniform(-hue_delta, hue_delta)
    if do_sat or do_hue:
        hsv = _rgb_to_hsv(out.clamp(0, 255))
        h, s, v = hsv.unbind(-1)
        if do_sat:
            s = s * sat
        if do_hue:
            h = h + hue
            # numpy's float remainder: fmod, moved into [0, 360)
            h = torch.fmod(h, 360.0)
            h = torch.where(h < 0, h + 360.0, h)
        out = _hsv_to_rgb(torch.stack([h, s, v], -1))

    if not contrast_first and alpha is not None:
        out *= alpha

    if rng.integers(2):
        perm = rng.permutation(3)
        out = out[..., torch.from_numpy(perm).to(out.device)]
    return out.clamp(0.0, 255.0)


def random_scale(
    img_scales: Sequence[Tuple[int, int]],
    rng: np.random.Generator,
    multiscale_mode: str = "range",
    ratio_range: Tuple[float, float] | None = None,
) -> Tuple[Tuple[int, int], int | None]:
    """MyResize._random_scale (transform_3d.py:448-478): pick a (long, short)
    target scale.

    - ``ratio_range`` set: one base scale times a uniform ratio draw;
    - mode "range": independent uniform integer draws of long and short
      edges between the two bounding scales;
    - mode "value": uniform choice among the listed scales.
    Returns (scale, scale_idx) — scale_idx is None except in "value" mode,
    matching the reference's bookkeeping.
    """
    if ratio_range is not None:
        assert len(img_scales) == 1
        lo, hi = ratio_range
        ratio = float(rng.random()) * (hi - lo) + lo
        base = img_scales[0]
        return (int(base[0] * ratio), int(base[1] * ratio)), None
    if len(img_scales) == 1:
        return tuple(img_scales[0]), 0
    if multiscale_mode == "range":
        assert len(img_scales) == 2
        longs = [max(s) for s in img_scales]
        shorts = [min(s) for s in img_scales]
        long_edge = int(rng.integers(min(longs), max(longs) + 1))
        short_edge = int(rng.integers(min(shorts), max(shorts) + 1))
        return (long_edge, short_edge), None
    if multiscale_mode == "value":
        idx = int(rng.integers(len(img_scales)))
        return tuple(img_scales[idx]), idx
    raise ValueError(f"unknown multiscale_mode {multiscale_mode!r}")


def _resize(img: torch.Tensor, size_wh: Tuple[int, int]) -> torch.Tensor:
    """[H, W, 3] -> [h, w, 3] with ``cv2.resize(INTER_LINEAR)``'s
    arithmetic."""
    w, h = size_wh
    x = img.float().permute(2, 0, 1)[None]
    x = F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False, antialias=False)
    return x[0].permute(1, 2, 0)


def rescale_keep_ratio(img: torch.Tensor, scale: Tuple[int, int]) -> Tuple[torch.Tensor, float, float]:
    """mmcv ``imrescale`` semantics (MyResize keep_ratio=True branch,
    transform_3d.py:484-497): scale so the image fits inside
    (max(scale), min(scale)) preserving aspect; per-axis w/h factors are
    recomputed from the ROUNDED output size, reproducing the reference's
    'minor difference' between w_scale and h_scale."""
    h, w = img.shape[:2]
    factor = min(max(scale) / max(h, w), min(scale) / min(h, w))
    nw, nh = int(w * factor + 0.5), int(h * factor + 0.5)
    return _resize(img, (nw, nh)), nw / w, nh / h


def resize_multiview(
    images: Sequence[torch.Tensor],  # V x [H, W, 3]
    lidar2img: np.ndarray,  # [V, 4, 4]
    scale: Tuple[int, int],
    keep_ratio: bool = True,
    bboxes_2d: np.ndarray | None = None,  # [N, 4] xyxy, optional
    bbox_clip_border: bool = True,
):
    """MyResize applied to every view (transform_3d.py:480-590):
    resize, produce the [w, h, w, h] ``scale_factor``, fold the scale into
    lidar2img, and resize + clip 2D boxes like _resize_bboxes."""
    mats = lidar2img.copy()
    out: List[torch.Tensor] = []
    w_scale = h_scale = 1.0
    for i, img in enumerate(images):
        if keep_ratio:
            rimg, w_scale, h_scale = rescale_keep_ratio(img, scale)
        else:
            h, w = img.shape[:2]
            rimg = _resize(img, (scale[0], scale[1]))
            w_scale, h_scale = scale[0] / w, scale[1] / h
        out.append(rimg)
        smat = np.eye(4, dtype=np.float32)
        smat[0, 0] = w_scale
        smat[1, 1] = h_scale
        mats[i] = smat @ mats[i]
    scale_factor = np.array([w_scale, h_scale, w_scale, h_scale], np.float32)
    new_boxes = None
    if bboxes_2d is not None:
        new_boxes = bboxes_2d * scale_factor
        if bbox_clip_border:
            nh, nw = out[0].shape[:2]
            new_boxes[:, 0::2] = np.clip(new_boxes[:, 0::2], 0, nw)
            new_boxes[:, 1::2] = np.clip(new_boxes[:, 1::2], 0, nh)
    return out, mats, scale_factor, new_boxes


def pad_waymo_view(img: torch.Tensor, target_rows: int = 1280) -> torch.Tensor:
    """LoadMultiViewImageFromFilesWaymo.pad (transform_3d.py:258-262):
    zero-pad a short (e.g. 886-row side-camera) view to the common height."""
    if img.shape[0] >= target_rows:
        return img
    return F.pad(img, (0, 0, 0, 0, 0, target_rows - img.shape[0]))


def random_resize(
    images: Sequence[torch.Tensor],  # V x [H, W, 3]
    lidar2img: np.ndarray,  # [V, 4, 4]
    rng: np.random.Generator,
    ratio_range: Tuple[float, float] = (0.9, 1.1),
):
    """Per-sample random scale; the scale matrix premultiplies lidar2img
    exactly like ScaleImageMultiViewImage (transform_3d.py:129-134)."""
    ratio = float(rng.uniform(*ratio_range))
    mats = lidar2img.copy()
    out = []
    for i, img in enumerate(images):
        h, w = img.shape[:2]
        nw, nh = int(w * ratio), int(h * ratio)
        out.append(_resize(img, (nw, nh)))
        scale = np.eye(4, dtype=np.float32)
        scale[0, 0] = nw / w
        scale[1, 1] = nh / h
        mats[i] = scale @ mats[i]
    return out, mats, ratio

"""ROIAlignV2 (aligned, sampling ratio 2) as dense gathers (port of
``deepinteraction_tpu/ops/roi_align.py``; detectron2 border semantics: a
sample at y <= -1 or y >= H contributes 0, otherwise coordinates clamp)."""

from __future__ import annotations

import torch


def _bilinear_flat(flat, h, w, base, x, y):
    """detectron2 bilinear lookup in a flat [V*H*W, C] table; ``base`` is
    the view's row offset, broadcast against x/y."""
    inside = (y > -1.0) & (y < h) & (x > -1.0) & (x < w)
    y = y.clamp(0.0, h - 1)
    x = x.clamp(0.0, w - 1)
    y0, x0 = torch.floor(y), torch.floor(x)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    ly, lx = y - y0, x - x0
    hy, hx = 1.0 - ly, 1.0 - lx
    y0i, x0i, y1i, x1i = (t.long() for t in (y0, x0, y1, x1))
    v00 = flat[base + y0i * w + x0i]
    v01 = flat[base + y0i * w + x1i]
    v10 = flat[base + y1i * w + x0i]
    v11 = flat[base + y1i * w + x1i]
    out = (
        v00 * (hy * hx)[..., None]
        + v01 * (hy * lx)[..., None]
        + v10 * (ly * hx)[..., None]
        + v11 * (ly * lx)[..., None]
    )
    return torch.where(inside[..., None], out, out.new_zeros(()))


def _sample_grid(boxes, output_size, spatial_scale, sampling_ratio):
    p, s = output_size, sampling_ratio
    x0 = boxes[:, 0] * spatial_scale - 0.5
    y0 = boxes[:, 1] * spatial_scale - 0.5
    x1 = boxes[:, 2] * spatial_scale - 0.5
    y1 = boxes[:, 3] * spatial_scale - 0.5
    bin_w = (x1 - x0) / p
    bin_h = (y1 - y0) / p
    off = (torch.arange(s, dtype=boxes.dtype, device=boxes.device) + 0.5) / s
    bins = torch.arange(p, dtype=boxes.dtype, device=boxes.device)
    frac = bins[None, :, None] + off[None, None, :]  # [1, p, s]
    sx = x0[:, None, None] + frac * bin_w[:, None, None]
    sy = y0[:, None, None] + frac * bin_h[:, None, None]
    n = boxes.shape[0]
    xg = sx[:, None, None, :, :].expand(n, p, s, p, s)
    yg = sy[:, :, :, None, None].expand(n, p, s, p, s)
    return xg, yg


def roi_align(feat, boxes, *, output_size=7, spatial_scale=1.0, sampling_ratio=2):
    """feat [H, W, C]; boxes [N, 4] (x0, y0, x1, y1) -> [N, P, P, C]."""
    h, w, c = feat.shape
    xg, yg = _sample_grid(boxes, output_size, spatial_scale, sampling_ratio)
    samples = _bilinear_flat(feat.reshape(h * w, c), h, w, 0, xg, yg)
    return samples.mean(dim=(2, 4))


def roi_align_views(
    feats, boxes, view_idx, *, output_size=7, spatial_scale=1.0, sampling_ratio=2
):
    """Each box crops from its own view of feats [V, H, W, C]; boxes [N, 4];
    view_idx [N] -> [N, P, P, C]."""
    v, h, w, c = feats.shape
    xg, yg = _sample_grid(boxes, output_size, spatial_scale, sampling_ratio)
    base = (view_idx.long() * (h * w))[:, None, None, None, None]
    samples = _bilinear_flat(feats.reshape(v * h * w, c), h, w, base, xg, yg)
    return samples.mean(dim=(2, 4))

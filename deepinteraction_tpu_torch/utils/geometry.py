"""Geometry helpers (port of the parts of
``deepinteraction_tpu/utils/geometry.py`` the eval path uses)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def transform_points(mat: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply a [4, 4] homogeneous matrix to [..., 3] points."""
    return pts @ mat[:3, :3].T + mat[:3, 3]


def grid_sample_2d(feat: torch.Tensor, grid_xy: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of an [H, W, C] map at [..., 2] normalised (x, y)
    coords: ``F.grid_sample`` with zero padding and ``align_corners=False``.
    Returns [..., C]."""
    c = feat.shape[-1]
    lead = grid_xy.shape[:-1]
    out = F.grid_sample(
        feat.permute(2, 0, 1)[None],
        grid_xy.reshape(1, 1, -1, 2),
        mode="bilinear",
        padding_mode="zeros",
        align_corners=False,
    )  # [1, C, 1, N]
    return out[0, :, 0].T.reshape(*lead, c)


def grid_sample_2d_views(
    feats: torch.Tensor, grid_xy: torch.Tensor, view_idx: torch.Tensor
) -> torch.Tensor:
    """Bilinear sample where each element picks its own view of a
    [V, H, W, C] stack (zero padding, ``align_corners=False``)."""
    v, h, w, c = feats.shape
    flat = feats.reshape(v * h * w, c)
    fx = ((grid_xy[..., 0] + 1.0) * w - 1.0) * 0.5
    fy = ((grid_xy[..., 1] + 1.0) * h - 1.0) * 0.5
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    tx = (fx - x0)[..., None]
    ty = (fy - y0)[..., None]
    base = view_idx.long() * (h * w)

    def tap(ix, iy):
        inside = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        row = base + iy.clamp(0, h - 1).long() * w + ix.clamp(0, w - 1).long()
        return torch.where(inside[..., None], flat[row], flat.new_zeros(()))

    v00, v01 = tap(x0, y0), tap(x0 + 1, y0)
    v10, v11 = tap(x0, y0 + 1), tap(x0 + 1, y0 + 1)
    return (v00 * (1 - tx) + v01 * tx) * (1 - ty) + (v10 * (1 - tx) + v11 * tx) * ty

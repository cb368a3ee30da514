"""Geometry helpers (port of the parts of
``deepinteraction_tpu/utils/geometry.py`` the model uses): point
transforms, and bilinear and nearest sampling with zero padding and
``align_corners=False``, of one map or of a stack of views where each
point picks its own view."""

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


def _pixel_coords(grid_xy: torch.Tensor, h: int, w: int):
    """Continuous pixel coordinates of normalised (x, y) grid points
    (``align_corners=False``)."""
    fx = ((grid_xy[..., 0] + 1.0) * w - 1.0) * 0.5
    fy = ((grid_xy[..., 1] + 1.0) * h - 1.0) * 0.5
    return fx, fy


def take_rows(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``table[rows]`` for a [T, C] table and integer rows of any shape:
    [..., C]. Through ``index_select``, whose backward adds with atomics
    (``index_add_``): the backward of ``table[rows]`` (``index_put_`` with
    accumulate) serialises repeated rows, and a pillar's keys repeat a
    few pixels many times."""
    return table.index_select(0, rows.reshape(-1)).reshape(*rows.shape, table.shape[-1])


def grid_sample_2d_views(
    feats: torch.Tensor, grid_xy: torch.Tensor, view_idx: torch.Tensor
) -> torch.Tensor:
    """Bilinear sample where each element picks its own view of a
    [V, H, W, C] stack (zero padding, ``align_corners=False``)."""
    v, h, w, c = feats.shape
    flat = feats.reshape(v * h * w, c)
    fx, fy = _pixel_coords(grid_xy, h, w)
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    tx = (fx - x0)[..., None]
    ty = (fy - y0)[..., None]
    base = view_idx.long() * (h * w)

    def tap(ix, iy):
        inside = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        row = base + iy.clamp(0, h - 1).long() * w + ix.clamp(0, w - 1).long()
        return torch.where(inside[..., None], take_rows(flat, row), flat.new_zeros(()))

    v00, v01 = tap(x0, y0), tap(x0 + 1, y0)
    v10, v11 = tap(x0, y0 + 1), tap(x0 + 1, y0 + 1)
    return (v00 * (1 - tx) + v01 * tx) * (1 - ty) + (v10 * (1 - tx) + v11 * tx) * ty


def nearest_row_ids(vhw, grid_xy: torch.Tensor, view_idx: torch.Tensor):
    """The flat row of the nearest pixel of each sample point in a [V*H*W]
    table of a [V, H, W] stack, and whether that pixel lies in the image:
    ([...] int64, [...] bool). Rounds as the JAX package does,
    ``floor(f + 0.5)`` (``torch.round`` rounds halves to even and
    ``F.grid_sample(mode="nearest")`` to the nearest even integer too)."""
    _, h, w = vhw
    fx, fy = _pixel_coords(grid_xy, h, w)
    ix = torch.floor(fx + 0.5)
    iy = torch.floor(fy + 0.5)
    inside = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    row = (view_idx.long() * h + iy.clamp(0, h - 1).long()) * w + ix.clamp(0, w - 1).long()
    return row, inside


def grid_sample_2d_views_nearest(
    feats: torch.Tensor, grid_xy: torch.Tensor, view_idx: torch.Tensor
) -> torch.Tensor:
    """Nearest sample where each element picks its own view of a
    [V, H, W, C] stack: one row gather a point, 0 outside the image.
    Returns [..., C]."""
    v, h, w, c = feats.shape
    row, inside = nearest_row_ids((v, h, w), grid_xy, view_idx)
    flat = feats.reshape(v * h * w, c)
    return torch.where(inside[..., None], take_rows(flat, row), flat.new_zeros(()))


def grid_sample_2d_nearest(feat: torch.Tensor, grid_xy: torch.Tensor) -> torch.Tensor:
    """Nearest sample of an [H, W, C] map at [..., 2] normalised (x, y)
    coords, 0 outside the image. Returns [..., C]."""
    view = torch.zeros(grid_xy.shape[:-1], dtype=torch.long, device=grid_xy.device)
    return grid_sample_2d_views_nearest(feat[None], grid_xy, view)

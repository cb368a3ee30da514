"""Multi-scale deformable attention (port of
``deepinteraction_tpu/ops/deform_attn.py::MSDeformableAttention``), with
mmcv ``MultiScaleDeformableAttention`` semantics:

- sampling location = ref + offset / (W_l, H_l), in [0, 1] coords;
- bilinear sampling with zero padding and ``align_corners=False``
  (``F.grid_sample`` on each level's [B*heads, head_dim, H_l, W_l] value);
- attention weights softmaxed jointly over levels x points;
- the output projection, then ``query + out`` (dropout in train only).

In eval, the JAX package's point reductions (``levers.py``), each 0 (off)
by default here:

- ``joint_points`` = kj (``DI_MSDA_JOINT_POINTS``), when 0 < kj < L*P: each
  (query, head) keeps its kj highest-weight points over levels x points,
  weights renormalised over them (:func:`joint_topk_sample`). It wins over
- ``eval_points`` = k (``DI_MSDA_EVAL_POINTS``), when 0 < k < P: each
  (query, head, level) keeps its k highest-weight points, weights
  renormalised over levels x kept points (:func:`topk_points`).

Ties keep the lower index first, as ``lax.top_k`` does: the points are
ranked by a stable descending sort (``torch.topk`` promises no order
among equals, and at init every weight ties). This is not a Pallas kernel
in the JAX package, so it is plain PyTorch here.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.geometry import take_rows
from .dropout import apply_dropout


def _top(w: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries along the last dim, largest first,
    ties to the lower index."""
    return torch.sort(w, dim=-1, descending=True, stable=True).indices[..., :k]


def topk_points(offsets: torch.Tensor, weights: torch.Tensor, k: int):
    """Keep the k highest-weight points per (query, head, level):
    offsets [..., L, P, 2], weights [..., L, P] -> ([..., L, k, 2],
    [..., L, k]), the kept weights renormalised over (L, k)."""
    idx = _top(weights, k)
    off_k = torch.gather(offsets, -2, idx[..., None].expand(*idx.shape, 2))
    w_k = torch.gather(weights, -1, idx)
    return off_k, w_k / w_k.sum((-2, -1), keepdim=True)


def joint_topk_sample(v: torch.Tensor, offsets: torch.Tensor, weights: torch.Tensor,
                      reference_points: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                      kj: int) -> torch.Tensor:
    """The attention-weighted sum of the kj highest-weight points over all
    levels x points per (query, head), weights renormalised over them.

    v [B, Nv, h*hd] (the projected values, levels concatenated), offsets
    [B, Nq, h, L, P, 2], weights [B, Nq, h, L, P] (softmaxed over L*P),
    reference_points [B, Nq, L, 2]. Each kept point, whatever its level, is
    sampled bilinearly (zero padding) by gathering its four pixels from one
    table of all levels' values: kj*4 row gathers a (query, head) instead
    of L*P*4. Returns [B, Nq, h, hd]."""
    b, nq, h, l, p, _ = offsets.shape
    hd = v.shape[-1] // h
    dev = v.device
    w = weights.reshape(b, nq, h, l * p)
    idx = _top(w, kj)  # [B, Nq, h, kj]
    wk = torch.gather(w, -1, idx)
    wk = wk / wk.sum(-1, keepdim=True)
    off = torch.gather(offsets.reshape(b, nq, h, l * p, 2), 3, idx[..., None].expand(*idx.shape, 2))
    lvl = idx // p
    hw = torch.tensor(spatial_shapes, device=dev)  # [L, 2] as (H, W)
    start = torch.cumsum(hw.prod(-1), 0) - hw.prod(-1)
    hh, ww, st = hw[lvl, 0], hw[lvl, 1], start[lvl]  # each [B, Nq, h, kj]
    ref = reference_points[:, :, None].expand(b, nq, h, l, 2)
    ref = torch.gather(ref, 3, lvl[..., None].expand(*lvl.shape, 2))
    loc = ref + off / torch.stack([ww, hh], -1).to(off.dtype)
    grid = loc * 2.0 - 1.0
    fx = ((grid[..., 0] + 1.0) * ww - 1.0) * 0.5
    fy = ((grid[..., 1] + 1.0) * hh - 1.0) * 0.5
    x0, y0 = torch.floor(fx), torch.floor(fy)
    tx, ty = fx - x0, fy - y0
    # the table's rows are (batch, value token, head)
    table = v.reshape(b * v.shape[1] * h, hd)
    base = torch.arange(b, device=dev)[:, None, None, None] * v.shape[1]
    head = torch.arange(h, device=dev)[None, None, :, None]
    out = None
    for dx, dy, tap_w in ((0, 0, (1 - tx) * (1 - ty)), (1, 0, tx * (1 - ty)), (0, 1, (1 - tx) * ty),
                          (1, 1, tx * ty)):
        ix, iy = x0 + dx, y0 + dy
        inside = (ix >= 0) & (ix < ww) & (iy >= 0) & (iy < hh)
        tok = st + iy.clamp(min=0).long().minimum(hh - 1) * ww + ix.clamp(min=0).long().minimum(ww - 1)
        rows = ((base + tok) * h + head).reshape(-1)
        cw = torch.where(inside, tap_w * wk, tap_w.new_zeros(()))
        part = take_rows(table, rows).reshape(b, nq, h, kj, hd) * cw[..., None]
        out = part if out is None else out + part
    return out.sum(3)


class MSDeformableAttention(nn.Module):
    def __init__(self, embed_dims: int, num_heads: int = 8, num_levels: int = 4,
                 num_points: int = 4, dropout: float = 0.1, joint_points: int = 0, eval_points: int = 0):
        super().__init__()
        self.embed_dims, self.num_heads = embed_dims, num_heads
        self.num_levels, self.num_points, self.dropout = num_levels, num_points, dropout
        self.joint_points, self.eval_points = joint_points, eval_points
        c, h, l, p = embed_dims, num_heads, num_levels, num_points
        self.value_proj = nn.Linear(c, c)
        self.sampling_offsets = nn.Linear(c, 2 * h * l * p)
        self.attention_weights = nn.Linear(c, h * l * p)
        self.output_proj = nn.Linear(c, c)

    def forward(self, query: torch.Tensor, value: torch.Tensor, reference_points: torch.Tensor,
                spatial_shapes: Sequence[Tuple[int, int]], train: bool = False, generator: torch.Generator | None = None) -> torch.Tensor:
        """query [B, Nq, C]; value [B, Nv, C], the levels' [H_l, W_l] maps
        flattened and concatenated; reference_points [B, Nq, L, 2] in [0, 1]
        as (x, y). Returns [B, Nq, C]."""
        c, h, l, p = self.embed_dims, self.num_heads, self.num_levels, self.num_points
        hd = c // h
        b, nq = query.shape[:2]
        assert len(spatial_shapes) == l, (spatial_shapes, l)
        v = self.value_proj(value)
        offsets = self.sampling_offsets(query).reshape(b, nq, h, l, p, 2)
        weights = torch.softmax(self.attention_weights(query).reshape(b, nq, h, l * p), -1)
        weights = weights.reshape(b, nq, h, l, p)

        kj, k = self.joint_points, self.eval_points
        if not train and 0 < kj < l * p:
            out = joint_topk_sample(v, offsets, weights, reference_points, spatial_shapes, kj)
            return query + self.output_proj(out.reshape(b, nq, c))
        if not train and 0 < k < p:
            offsets, weights = topk_points(offsets, weights, k)
            p = k

        out = None
        start = 0
        for li, (hh, ww) in enumerate(spatial_shapes):
            v_l = v[:, start:start + hh * ww].reshape(b, hh, ww, h, hd)
            v_l = v_l.permute(0, 3, 4, 1, 2).reshape(b * h, hd, hh, ww)
            start += hh * ww
            wh = offsets.new_tensor([ww, hh])
            loc = reference_points[:, :, None, li, None, :] + offsets[:, :, :, li] / wh  # [B, Nq, h, p, 2]
            grid = (loc * 2.0 - 1.0).permute(0, 2, 1, 3, 4).reshape(b * h, nq, p, 2)
            sampled = F.grid_sample(v_l, grid, mode="bilinear", padding_mode="zeros",
                                    align_corners=False)  # [B*h, hd, Nq, p]
            w_l = weights[:, :, :, li].permute(0, 2, 1, 3).reshape(b * h, 1, nq, p)
            part = (sampled * w_l).sum(-1)  # [B*h, hd, Nq]
            out = part if out is None else out + part
        out = out.reshape(b, h, hd, nq).permute(0, 3, 1, 2).reshape(b, nq, c)
        out = apply_dropout(self.output_proj(out), self.dropout, train, generator)
        return query + out

"""Multi-scale deformable attention (port of the exact path of
``deepinteraction_tpu/ops/deform_attn.py::MSDeformableAttention``), with
mmcv ``MultiScaleDeformableAttention`` semantics:

- sampling location = ref + offset / (W_l, H_l), in [0, 1] coords;
- bilinear sampling with zero padding and ``align_corners=False``
  (``F.grid_sample`` on each level's [B*heads, head_dim, H_l, W_l] value);
- attention weights softmaxed jointly over levels x points;
- the output projection, then ``query + out`` (dropout in train only).

The JAX package's eval-time point reductions (``DI_MSDA_EVAL_POINTS``,
``DI_MSDA_JOINT_POINTS``) are left out: the port has the parity behaviour
only. This is not a Pallas kernel in the JAX package, so it is plain
PyTorch here.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .dropout import apply_dropout


class MSDeformableAttention(nn.Module):
    def __init__(self, embed_dims: int, num_heads: int = 8, num_levels: int = 4,
                 num_points: int = 4, dropout: float = 0.1):
        super().__init__()
        self.embed_dims, self.num_heads = embed_dims, num_heads
        self.num_levels, self.num_points, self.dropout = num_levels, num_points, dropout
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

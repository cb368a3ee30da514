"""FPN image neck (port of ``deepinteraction_tpu/models/fpn.py``): lateral
1x1 convs, top-down nearest upsample + add, 3x3 output convs, extra levels
by stride-2 subsampling. NHWC in and out."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d


class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int], out_channels: int = 256, num_outs: int = 5):
        super().__init__()
        self.n = len(in_channels)
        self.num_outs = num_outs
        for i, c in enumerate(in_channels):
            self.add_module(f"lateral{i}", Conv2d(c, out_channels, 1))
            self.add_module(f"fpn{i}", Conv2d(out_channels, out_channels, 3, 1, 1))

    def forward(self, inputs: Sequence[torch.Tensor], num_levels: int | None = None):
        """``num_levels`` limits the output convs to the first levels a
        caller uses (the v1 detector reads level 0 only)."""
        lat = [getattr(self, f"lateral{i}")(x) for i, x in enumerate(inputs)]
        for i in range(self.n - 1, 0, -1):
            up = F.interpolate(
                lat[i].permute(0, 3, 1, 2), size=lat[i - 1].shape[1:3], mode="nearest-exact"
            )
            lat[i - 1] = lat[i - 1] + up.permute(0, 2, 3, 1)
        levels = self.num_outs if num_levels is None else num_levels
        outs = [getattr(self, f"fpn{i}")(lat[i]) for i in range(min(levels, self.n))]
        while len(outs) < levels:
            outs.append(outs[-1][:, ::2, ::2])
        return outs

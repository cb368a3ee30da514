"""SECOND dense BEV backbone + SECONDFPN neck (port of
``deepinteraction_tpu/models/second.py``). BN eps 1e-3. SECONDFPN returns
``[concat(ups), up0, up1]`` like the reference's patched neck."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm, Conv2d, ConvTranspose2d

BN_EPS = 1e-3


class SECOND(nn.Module):
    def __init__(self, cin: int, out_channels=(128, 256), layer_nums=(5, 5), layer_strides=(1, 2)):
        super().__init__()
        self.layer_nums = tuple(layer_nums)
        for i, (c, n, s) in enumerate(zip(out_channels, layer_nums, layer_strides)):
            self.add_module(f"block{i}_conv0", Conv2d(cin, c, 3, s, 1, bias=False))
            self.add_module(f"block{i}_bn0", BatchNorm(c, BN_EPS))
            for j in range(n):
                self.add_module(f"block{i}_conv{j + 1}", Conv2d(c, c, 3, 1, 1, bias=False))
                self.add_module(f"block{i}_bn{j + 1}", BatchNorm(c, BN_EPS))
            cin = c

    def forward(self, x: torch.Tensor):
        outs = []
        for i, n in enumerate(self.layer_nums):
            for j in range(n + 1):
                x = getattr(self, f"block{i}_conv{j}")(x)
                x = F.relu(getattr(self, f"block{i}_bn{j}")(x))
            outs.append(x)
        return outs


class SECONDFPN(nn.Module):
    def __init__(self, in_channels, out_channels=(256, 256), upsample_strides=(1, 2)):
        super().__init__()
        self.n = len(out_channels)
        for i, (cin, c, s) in enumerate(zip(in_channels, out_channels, upsample_strides)):
            conv = (
                ConvTranspose2d(cin, c, s, stride=s, bias=False)
                if s > 1
                else Conv2d(cin, c, 1, bias=False)
            )
            self.add_module(f"deblock{i}_conv", conv)
            self.add_module(f"deblock{i}_bn", BatchNorm(c, BN_EPS))

    def forward(self, inputs: Sequence[torch.Tensor]):
        ups = [
            F.relu(getattr(self, f"deblock{i}_bn")(getattr(self, f"deblock{i}_conv")(inputs[i])))
            for i in range(self.n)
        ]
        return [torch.cat(ups, -1)] + ups

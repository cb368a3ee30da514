"""Shared building blocks, channels-last (NHWC / [..., C]) like the JAX
package (``deepinteraction_tpu/models/layers.py``).

Convolutions keep torch weight layouts and run ``F.conv2d`` on an NCHW view
of the NHWC tensor (a ``permute``, no copy: cuDNN takes the channels-last
strides as they are). Normalisation is eval-only: BatchNorm uses its running
statistics, with Flax's arithmetic ``(x - mean) * (rsqrt(var + eps) * scale)
+ bias``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` applied to an NHWC tensor; returns NHWC."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kernel_size == (1, 1) and self.stride == (1, 1) and self.padding == (0, 0):
            w = self.weight.view(self.out_channels, self.in_channels)
            return F.linear(x, w, self.bias)
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight, self.bias, self.stride, self.padding)
        return y.permute(0, 2, 3, 1)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` applied to an NHWC tensor; returns NHWC."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2), self.weight, self.bias, self.stride)
        return y.permute(0, 2, 3, 1)


class BatchNorm(nn.Module):
    """Eval-mode BatchNorm over the last dim (Flax ``nn.BatchNorm`` with
    ``use_running_average=True``)."""

    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        return (x - self.running_mean) * mul + self.bias


class MaskedBatchNorm(BatchNorm):
    """BatchNorm over the valid rows of a masked set; invalid rows are 0.
    Eval branch of the JAX ``MaskedBatchNorm`` (running statistics)."""

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        y = super().forward(x)
        return torch.where(mask[..., None], y, y.new_zeros(()))


class ConvBNReLU(nn.Module):
    """Conv2d + optional BN + optional ReLU; bias iff no norm."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3,
                 use_norm: bool = True, use_act: bool = True):
        super().__init__()
        self.conv = Conv2d(cin, cout, kernel_size, 1, kernel_size // 2, bias=not use_norm)
        self.bn = BatchNorm(cout) if use_norm else None
        self.use_act = use_act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x) if self.use_act else x


class TorchMHA(nn.Module):
    """Multi-head attention with ``nn.MultiheadAttention`` semantics as plain
    matmul + softmax: separate q/k/v projections, scale 1/sqrt(head_dim),
    boolean masks (True = attend) -> -inf logits, fully masked rows -> 0."""

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def forward(self, q, k, v, key_mask=None, attn_mask=None):
        b, l, e = q.shape
        s = k.shape[1]
        h = self.num_heads
        hd = e // h
        qp = self.q_proj(q).reshape(b, l, h, hd)
        kp = self.k_proj(k).reshape(b, s, h, hd)
        vp = self.v_proj(v).reshape(b, s, h, hd)
        logits = torch.einsum("blhd,bshd->bhls", qp, kp) / math.sqrt(hd)
        ninf = logits.new_full((), float("-inf"))
        if key_mask is not None:  # [B, S]
            logits = torch.where(key_mask[:, None, None, :], logits, ninf)
        if attn_mask is not None:  # [B, L, S]
            logits = torch.where(attn_mask[:, None, :, :], logits, ninf)
        attn = torch.softmax(logits, dim=-1)
        attn = torch.nan_to_num(attn, nan=0.0)
        out = torch.einsum("bhls,bshd->blhd", attn, vp).reshape(b, l, e)
        return self.out_proj(out)


class MLP1d(nn.Module):
    """Per-element Dense stack of the prediction heads: (fc, BN, ReLU) x
    (num_layers - 1), then ``out``."""

    def __init__(self, cin: int, hidden: int, cout: int, num_layers: int = 2):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers - 1):
            self.add_module(f"fc{i}", nn.Linear(cin if i == 0 else hidden, hidden))
            self.add_module(f"bn{i}", BatchNorm(hidden))
        self.out = nn.Linear(hidden if num_layers > 1 else cin, cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers - 1):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"fc{i}")(x)))
        return self.out(x)


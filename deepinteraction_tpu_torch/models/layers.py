"""Shared building blocks, channels-last (NHWC / [..., C]) like the JAX
package (``deepinteraction_tpu/models/layers.py``).

Convolutions keep torch weight layouts and run ``F.conv2d`` on an NCHW view
of the NHWC tensor (a ``permute``, no copy: cuDNN takes the channels-last
strides as they are). Normalisation uses Flax's arithmetic ``(x - mean) *
(rsqrt(var + eps) * scale) + bias``: in eval with the running statistics, in
train (``train=True``) with the batch's, whose running averages are updated
in place at torch momentum ``m`` (``running = (1 - m) * running + m * stat``).

- ``BatchNorm`` is Flax ``nn.BatchNorm``: the batch variance is its fast
  form ``E[x^2] - E[x]^2`` (clipped at 0) and the running variance takes
  that **biased** value. ``torch.nn.BatchNorm*`` would store the unbiased
  one; the JAX package is followed.
- ``MaskedBatchNorm`` is the JAX ``MaskedBatchNorm``: statistics over the
  valid rows, two-pass variance, and an **unbiased** running variance.

Dropout masks are drawn from the ``torch.Generator`` the caller passes.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.dropout import apply_dropout


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
    """BatchNorm over the last dim (Flax ``nn.BatchNorm``); ``momentum`` in
    the torch convention."""

    def __init__(self, c: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def _normalize(self, x, mean, var):
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias

    @torch.no_grad()
    def _update(self, mean, var):
        m = self.momentum
        self.running_mean.mul_(1.0 - m).add_(m * mean)
        self.running_var.mul_(1.0 - m).add_(m * var)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if not train:
            return self._normalize(x, self.running_mean, self.running_var)
        dims = tuple(range(x.dim() - 1))
        mean = x.mean(dims)
        var = torch.clamp((x * x).mean(dims) - mean * mean, min=0.0)
        self._update(mean, var)
        return self._normalize(x, mean, var)


class MaskedBatchNorm(BatchNorm):
    """BatchNorm over the valid rows of a masked set [..., N, C]; invalid
    rows are 0. In train mode the statistics span every valid row of every
    leading index (all samples of a batch)."""

    def forward(self, x: torch.Tensor, mask: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            dims = tuple(range(x.dim() - 1))
            m = mask[..., None].to(x.dtype)
            cnt = torch.clamp(m.sum(), min=1.0)
            mean = (x * m).sum(dims) / cnt
            var = (m * (x - mean) ** 2).sum(dims) / cnt
            self._update(mean, var * cnt / torch.clamp(cnt - 1.0, min=1.0))
            y = self._normalize(x, mean, var)
        else:
            y = self._normalize(x, self.running_mean, self.running_var)
        return torch.where(mask[..., None], y, y.new_zeros(()))


class ConvBNReLU(nn.Module):
    """Conv2d + optional BN + optional ReLU; bias iff no norm."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3,
                 use_norm: bool = True, use_act: bool = True):
        super().__init__()
        self.conv = Conv2d(cin, cout, kernel_size, 1, kernel_size // 2, bias=not use_norm)
        self.bn = BatchNorm(cout) if use_norm else None
        self.use_act = use_act

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x, train)
        return F.relu(x) if self.use_act else x


class TorchMHA(nn.Module):
    """Multi-head attention with ``nn.MultiheadAttention`` semantics as plain
    matmul + softmax: separate q/k/v projections, scale 1/sqrt(head_dim),
    boolean masks (True = attend) -> -inf logits, fully masked rows -> 0.
    In train mode, dropout at rate ``dropout`` on the attention weights,
    as the JAX ``TorchMHA`` applies it."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.dropout = dropout
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def forward(self, q, k, v, key_mask=None, attn_mask=None, train: bool = False,
                generator: torch.Generator | None = None):
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
        attn = apply_dropout(attn, self.dropout, train, generator)
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

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        for i in range(self.num_layers - 1):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"fc{i}")(x), train))
        return self.out(x)


class DropPath(nn.Module):
    """Stochastic depth (JAX ``DropPath``): in train mode each sample's
    residual branch is kept with probability ``1 - rate`` and scaled by
    ``1 / (1 - rate)``, the draw taken from the caller's generator; in eval
    the identity."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if self.rate == 0.0 or not train:
            return x
        keep = 1.0 - self.rate
        mask = torch.empty((x.shape[0],) + (1,) * (x.dim() - 1), device=x.device)
        mask = mask.bernoulli_(keep, generator=generator).bool()
        return torch.where(mask, x / keep, x.new_zeros(()))


class TransFFN(nn.Module):
    """mmcv FFN with its residual (JAX ``fusion_transformer.TransFFN``):
    ``x + fc1(dropout(relu(fc0(x))))``, dropout in train mode only."""

    def __init__(self, c: int, feedforward: int, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.fc0 = nn.Linear(c, feedforward)
        self.fc1 = nn.Linear(feedforward, c)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        y = F.relu(self.fc0(x))
        y = apply_dropout(y, self.dropout, train, generator)
        return x + apply_dropout(self.fc1(y), self.dropout, train, generator)

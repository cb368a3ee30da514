"""Swin Transformer image backbone of DeepInteraction++ (port of
``deepinteraction_tpu/models/swin.py``), channels last.

A 4x4 patch embedding, then four stages of window attention blocks (every
second block on windows shifted by half a window) with patch merging
between stages, and a LayerNorm on each output stage (strides 4, 8, 16,
32). The window attention is plain matmul + softmax over dense
[windows, heads, ws*ws, ws*ws] logits, as the JAX package computes it
outside any Pallas kernel.

- Each block pads its input with zeros *after* ``norm1`` up to a multiple
  of the window, rolls it by -ws//2 when shifted, builds the -100 mask over
  the padded grid, rolls back and crops.
- ``PatchMerging`` pads odd sizes and takes its quarters in the order
  [0::2, 0::2], [1::2, 0::2], [0::2, 1::2], [1::2, 1::2]; its reduction has
  no bias.
- GELU is the exact erf form (torch's default, which the JAX module pins).
- ``rel_pos_bias`` is a raw parameter [(2ws-1)^2, heads].
- In train mode, stochastic depth (``DropPath``) and dropout draw from the
  caller's generator; in eval both are the identity.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.dropout import apply_dropout
from .layers import Conv2d, DropPath


def _rel_pos_index(ws: int) -> np.ndarray:
    """[ws*ws, ws*ws] index of each (query, key) offset into the bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0) + ws - 1
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int64)


def _shift_mask(hp: int, wp: int, ws: int, shift: int, device) -> torch.Tensor:
    """Additive mask [windows, ws*ws, ws*ws] of a shifted block: -100 between
    pixels of the padded, rolled grid that come from different regions."""
    img = torch.zeros(hp, wp, device=device)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    m = img.reshape(hp // ws, ws, wp // ws, ws).permute(0, 2, 1, 3).reshape(-1, ws * ws)
    return torch.where(m[:, None, :] != m[:, :, None], -100.0, 0.0)


class WindowMSA(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int,
                 attn_drop_rate: float = 0.0, proj_drop_rate: float = 0.0):
        super().__init__()
        self.num_heads, self.window_size = num_heads, window_size
        self.attn_drop_rate, self.proj_drop_rate = attn_drop_rate, proj_drop_rate
        self.qkv = nn.Linear(dim, 3 * dim)
        self.rel_pos_bias = nn.Parameter(torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.proj = nn.Linear(dim, dim)
        self.register_buffer("rel_pos_index", torch.from_numpy(_rel_pos_index(window_size)),
                             persistent=False)

    def forward(self, x, mask=None, train: bool = False, generator=None):
        """x [nW, N, C]; mask [nW0, N, N] additive (nW a multiple of nW0) or None."""
        nw, n, c = x.shape
        h = self.num_heads
        hd = c // h
        q, k, v = self.qkv(x).reshape(nw, n, 3, h, hd).permute(2, 0, 3, 1, 4)  # each [nW, h, N, hd]
        attn = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
        bias = self.rel_pos_bias[self.rel_pos_index.reshape(-1)].reshape(n, n, h).permute(2, 0, 1)
        attn = attn + bias[None]
        if mask is not None:
            g = mask.shape[0]
            attn = (attn.reshape(nw // g, g, h, n, n) + mask[None, :, None]).reshape(nw, h, n, n)
        attn = apply_dropout(torch.softmax(attn, -1), self.attn_drop_rate, train, generator)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(nw, n, c)
        return apply_dropout(self.proj(out), self.proj_drop_rate, train, generator)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int, shift: bool,
                 drop_path_rate: float = 0.0, drop_rate: float = 0.0, attn_drop_rate: float = 0.0):
        super().__init__()
        self.window_size, self.shift, self.drop_rate = window_size, shift, drop_rate
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowMSA(dim, num_heads, window_size, attn_drop_rate, drop_rate)
        self.drop_path1 = DropPath(drop_path_rate)
        self.norm2 = nn.LayerNorm(dim)
        self.fc1 = nn.Linear(dim, 4 * dim)
        self.fc2 = nn.Linear(4 * dim, dim)
        self.drop_path2 = DropPath(drop_path_rate)

    def forward(self, x, train: bool = False, generator=None):
        """x [B, H, W, C]."""
        b, h, w, c = x.shape
        ws = self.window_size
        shortcut = x
        pad_h, pad_w = (ws - h % ws) % ws, (ws - w % ws) % ws
        x = F.pad(self.norm1(x), (0, 0, 0, pad_w, 0, pad_h))
        hp, wp = h + pad_h, w + pad_w
        shift = ws // 2 if self.shift else 0
        mask = None
        if shift:
            x = torch.roll(x, (-shift, -shift), (1, 2))
            mask = _shift_mask(hp, wp, ws, shift, x.device)
        win = x.reshape(b, hp // ws, ws, wp // ws, ws, c).permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)
        y = self.attn(win, mask, train, generator)
        x = y.reshape(b, hp // ws, wp // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, c)
        if shift:
            x = torch.roll(x, (shift, shift), (1, 2))
        x = shortcut + self.drop_path1(x[:, :h, :w], train, generator)
        y = apply_dropout(F.gelu(self.fc1(self.norm2(x))), self.drop_rate, train, generator)
        y = apply_dropout(self.fc2(y), self.drop_rate, train, generator)
        return x + self.drop_path2(y, train, generator)


class PatchMerging(nn.Module):
    def __init__(self, dim: int, out_dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim)
        self.reduction = nn.Linear(4 * dim, out_dim, bias=False)

    def forward(self, x):
        b, h, w, c = x.shape
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
        return self.reduction(self.norm(x))


class SwinTransformer(nn.Module):
    """Images [N, H, W, 3] -> the LayerNormed outputs of the stages in
    ``out_indices``; ``out_channels[i]`` is stage i's width."""

    def __init__(self, embed_dims: int = 96, depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window_size: int = 7,
                 out_indices: Sequence[int] = (0, 1, 2, 3), drop_path_rate: float = 0.0,
                 drop_rate: float = 0.0, attn_drop_rate: float = 0.0):
        super().__init__()
        self.depths, self.out_indices = tuple(depths), tuple(out_indices)
        self.out_channels = tuple(embed_dims * 2 ** i for i in range(len(depths)))
        self.patch_embed = Conv2d(3, embed_dims, 4, 4, 0)
        self.patch_norm = nn.LayerNorm(embed_dims)
        total = sum(depths)
        # drop_path_rate ramps linearly from 0 over all blocks
        dprs = [drop_path_rate * k / max(total - 1, 1) for k in range(total)]
        blk = 0
        for i, (depth, heads) in enumerate(zip(depths, num_heads)):
            dim = self.out_channels[i]
            for j in range(depth):
                self.add_module(f"stage{i}_block{j}", SwinBlock(
                    dim, heads, window_size, j % 2 == 1, dprs[blk], drop_rate, attn_drop_rate))
                blk += 1
            if i in self.out_indices:
                self.add_module(f"out_norm{i}", nn.LayerNorm(dim))
            if i < len(depths) - 1:
                self.add_module(f"merge{i}", PatchMerging(dim, 2 * dim))

    def forward(self, x, train: bool = False, generator=None) -> List[torch.Tensor]:
        x = self.patch_norm(self.patch_embed(x))
        outs = []
        for i, depth in enumerate(self.depths):
            for j in range(depth):
                x = getattr(self, f"stage{i}_block{j}")(x, train, generator)
            if i in self.out_indices:
                outs.append(getattr(self, f"out_norm{i}")(x))
            if i < len(self.depths) - 1:
                x = getattr(self, f"merge{i}")(x)
        return outs

"""Sparse 3D middle encoder (port of
``deepinteraction_tpu/models/sparse_encoder.py``), on kernel K1.

    conv_input: SubM(5->16) + BN + ReLU
    stage0: Basic(16) Basic(16) SparseConv s2 16->32  (pad 1)
    stage1: Basic(32) Basic(32) SparseConv s2 32->64  (pad 1)
    stage2: Basic(64) Basic(64) SparseConv s2 64->128 (pad z0 y1 x1)
    stage3: Basic(128) Basic(128)
    conv_out: SparseConv k(3,1,1) s(2,1,1) pad 0, 128->128 + BN + ReLU
    -> dense BEV [ny/8, nx/8, 128*2]

17 submanifold convs per frame, plus the 3 strided convs and ``conv_out``;
all 21 run on ``subm_conv_gemm`` (the tap count comes from the table). One
implementation only: the JAX ``dense``/``s2d``/``sgather``/``banded``
variants are TPU experiments.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from deepinteraction_tpu.configs import SparseEncoderConfig

from ..ops import sparse_conv as sc
from ..ops.subm_conv import subm_conv_gemm
from .layers import MaskedBatchNorm

BN_EPS = 1e-3


def _weight(*shape) -> nn.Parameter:
    return nn.Parameter(torch.zeros(*shape))


class SubMConvBNReLU(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.w = _weight(27, cin, cout)
        self.bn = MaskedBatchNorm(cout, BN_EPS)

    def forward(self, x, nbr, valid):
        return F.relu(self.bn(subm_conv_gemm(x, nbr, self.w, valid), valid))


class SparseBasicBlock(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.w1 = _weight(27, ch, ch)
        self.w2 = _weight(27, ch, ch)
        self.bn1 = MaskedBatchNorm(ch, BN_EPS)
        self.bn2 = MaskedBatchNorm(ch, BN_EPS)

    def forward(self, x, nbr, valid):
        y = F.relu(self.bn1(subm_conv_gemm(x, nbr, self.w1, valid), valid))
        y = self.bn2(subm_conv_gemm(y, nbr, self.w2, valid), valid)
        return F.relu(y + x)


class SparseEncoder(nn.Module):
    STRIDED_PADS = ((1, 1, 1), (1, 1, 1), (0, 1, 1))

    def __init__(self, cfg: SparseEncoderConfig):
        super().__init__()
        self.cfg = cfg
        specs = cfg.encoder_channels
        self.conv_input = SubMConvBNReLU(cfg.in_channels, cfg.base_channels)
        for i, blocks in enumerate(specs):
            ch = blocks[0]
            last = i == len(specs) - 1
            n_basic = len(blocks) if last else len(blocks) - 1
            for j in range(n_basic):
                self.add_module(f"stage{i}_block{j}", SparseBasicBlock(ch))
            if not last:
                self.register_parameter(f"down{i}_w", _weight(27, ch, blocks[-1]))
                self.add_module(f"down{i}_bn", MaskedBatchNorm(blocks[-1], BN_EPS))
        self.conv_out_w = _weight(3, specs[-1][-1], cfg.output_channels)
        self.conv_out_bn = MaskedBatchNorm(cfg.output_channels, BN_EPS)

    def out_shape(self):
        """(nz, ny, nx) of the last sparse tensor before the BEV fold."""
        shape = tuple(self.cfg.sparse_shape)
        for pad in self.STRIDED_PADS[: len(self.cfg.encoder_channels) - 1]:
            shape = sc.out_shape(shape, (3, 3, 3), (2, 2, 2), pad)
        return sc.out_shape(shape, (3, 1, 1), (2, 1, 1), (0, 0, 0))

    def forward(self, voxel_feats, coords, valid):
        """voxel_feats [B, K, Cin], coords [B, K, 3] (z, y, x) sorted by id,
        valid [B, K] -> BEV [B, ny/8, nx/8, C*nz]."""
        return torch.stack(
            [self._one(voxel_feats[i], coords[i], valid[i]) for i in range(voxel_feats.shape[0])]
        )

    def _one(self, feats, coords, valid):
        cfg = self.cfg
        shape = tuple(cfg.sparse_shape)
        specs = cfg.encoder_channels
        nbr = sc.subm_neighbor_table(sc.SparseTensor(feats, coords, valid, shape))
        feats = self.conv_input(feats, nbr, valid)
        for i, blocks in enumerate(specs):
            last = i == len(specs) - 1
            n_basic = len(blocks) if last else len(blocks) - 1
            for j in range(n_basic):
                feats = getattr(self, f"stage{i}_block{j}")(feats, nbr, valid)
            if last:
                break
            st = sc.SparseTensor(feats, coords, valid, shape)
            kernel, stride, pad = (3, 3, 3), (2, 2, 2), self.STRIDED_PADS[i]
            coords, valid, shape = sc.downsample_sites(
                coords, valid, shape, kernel, stride, pad, cfg.stage_capacities[i + 1]
            )
            snbr = sc.strided_neighbor_table(st, coords, valid, kernel, stride, pad)
            feats = subm_conv_gemm(feats, snbr, getattr(self, f"down{i}_w"), valid)
            feats = F.relu(getattr(self, f"down{i}_bn")(feats, valid))
            nbr = sc.subm_neighbor_table(sc.SparseTensor(feats, coords, valid, shape))

        st = sc.SparseTensor(feats, coords, valid, shape)
        kernel, stride, pad = (3, 1, 1), (2, 1, 1), (0, 0, 0)
        coords, valid, shape = sc.downsample_sites(
            coords, valid, shape, kernel, stride, pad, feats.shape[0]
        )
        snbr = sc.strided_neighbor_table(st, coords, valid, kernel, stride, pad)
        feats = subm_conv_gemm(feats, snbr, self.conv_out_w, valid)
        feats = F.relu(self.conv_out_bn(feats, valid))
        return sc.to_dense_bev(sc.SparseTensor(feats, coords, valid, shape))

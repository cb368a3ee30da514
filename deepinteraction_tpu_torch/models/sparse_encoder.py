"""Sparse 3D middle encoder (port of
``deepinteraction_tpu/models/sparse_encoder.py``), on kernel K1.

    conv_input: SubM(5->16) + BN + ReLU
    stage0: Basic(16) Basic(16) SparseConv s2 16->32  (pad 1)
    stage1: Basic(32) Basic(32) SparseConv s2 32->64  (pad 1)
    stage2: Basic(64) Basic(64) SparseConv s2 64->128 (pad z0 y1 x1)
    stage3: Basic(128) Basic(128)
    conv_out: SparseConv k(3,1,1) s(2,1,1) pad 0, 128->128 + BN + ReLU
    -> dense BEV [ny/8, nx/8, 128*2]

17 submanifold convs per sample, plus the 3 strided convs and ``conv_out``;
all 21 run on ``subm_conv_gemm`` (the tap count comes from the table), one
sample at a time. The BatchNorms run on the stacked batch: in train mode
their statistics span every sample's valid voxels, as torch's BN1d over the
concatenated voxel list does (JAX ``sparse_encoder.py:28-29``). Where
gradients are on, each table's inverse is built once (by the tap mirror for
a submanifold table, by one scatter for a strided one) and shared by the
convs over it for K1's d/dfeat.

``bf16=True`` runs the 17 submanifold convs on K1's bf16 variant
(``subm_conv_gemm(..., bf16=True)``), as the JAX package's default
``DI_SPARSE_IMPL=banded`` runs them on its bf16 Pallas kernel on a TPU
(``sparse_encoder.py:109-125``); the 3 strided convs and ``conv_out`` stay
fp32, as JAX leaves them on the gather (``:143-167``). Each sample-stage's
banded plan (``banded_t`` rows a tile, the stage's window from
``banded_w``, JAX's ``DI_BANDED_T`` / ``DI_BANDED_W``) gives an overflow
flag on the device (``ops/sparse_conv.py::banded_overflow``), and where it
is set that sample-stage's convs compute fp32, as JAX's ``_banded_apply``
falls back to the fp32 gather. In train, d/dfeat is then the same conv over
the inverse table (flag included) and d/dW takes the features rounded to
bf16 (JAX's ``_banded_bwd``). ``s2d=True`` runs the 17 on bf16 operands
with one fp32 sum (``per_tap=False``), JAX's ``DI_SPARSE_IMPL=s2d``
numerics, d/dfeat and d/dW likewise. The caller decides (``levers.py::
EvalLevers.k1_numerics``). JAX's other layouts (``dense``, ``sgather``)
compute fp32, as the gather.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..configs import SparseEncoderConfig

from ..ops import sparse_conv as sc
from ..ops.subm_conv import subm_conv_gemm
from ..utils.spans import span
from .layers import MaskedBatchNorm

BN_EPS = 1e-3
BN_MOM = 0.01  # torch momentum (mmdet3d SparseEncoder default)


def _weight(*shape) -> nn.Parameter:
    return nn.Parameter(torch.zeros(*shape))


def _bn(c: int) -> MaskedBatchNorm:
    return MaskedBatchNorm(c, BN_EPS, BN_MOM)


def _conv(x, w, tables, valid, bf16: bool, s2d: bool = False):
    """K1 over each sample (its bf16 variant with ``bf16`` or ``s2d``): x
    [B, K, Cin], tables [(nbr, inv, ovf)] per sample, valid [B, Ko] -> [B,
    Ko, Cout]."""
    return torch.stack([
        subm_conv_gemm(x[i], nbr, w, valid[i], inv, bf16=bf16 or s2d, per_tap=not s2d, ovf=ovf)
        for i, (nbr, inv, ovf) in enumerate(tables)
    ])


def _subm_tables(coords, valid, shape, with_inverse: bool, plan=None):
    """Per sample (nbr, inv or None, ovf or None): with ``plan`` = (T, W),
    the banded plan's overflow flag on the device."""
    out = []
    with span("di.sparse.tables"):
        for c, v in zip(coords, valid):
            nbr = sc.subm_neighbor_table(sc.SparseTensor(None, c, v, shape))
            ovf = None if plan is None else sc.banded_overflow(nbr, v, *plan)
            out.append((nbr, sc.mirror_table(nbr) if with_inverse else None, ovf))
    return out


class SubMConvBNReLU(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.w = _weight(27, cin, cout)
        self.bn = _bn(cout)

    def forward(self, x, tables, valid, train: bool = False, bf16: bool = False, s2d: bool = False):
        return F.relu(self.bn(_conv(x, self.w, tables, valid, bf16, s2d), valid, train))


class SparseBasicBlock(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.w1 = _weight(27, ch, ch)
        self.w2 = _weight(27, ch, ch)
        self.bn1 = _bn(ch)
        self.bn2 = _bn(ch)

    def forward(self, x, tables, valid, train: bool = False, bf16: bool = False, s2d: bool = False):
        y = F.relu(self.bn1(_conv(x, self.w1, tables, valid, bf16, s2d), valid, train))
        y = self.bn2(_conv(y, self.w2, tables, valid, bf16, s2d), valid, train)
        return F.relu(y + x)


class SparseEncoder(nn.Module):
    STRIDED_PADS = ((1, 1, 1), (1, 1, 1), (0, 1, 1))

    def __init__(self, cfg: SparseEncoderConfig, banded_t: int = 128, banded_w=(512,)):
        super().__init__()
        self.cfg = cfg
        self.banded_t, self.banded_w = banded_t, tuple(banded_w)
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
                self.add_module(f"down{i}_bn", _bn(blocks[-1]))
        self.conv_out_w = _weight(3, specs[-1][-1], cfg.output_channels)
        self.conv_out_bn = _bn(cfg.output_channels)

    def out_shape(self):
        """(nz, ny, nx) of the last sparse tensor before the BEV fold."""
        shape = tuple(self.cfg.sparse_shape)
        for pad in self.STRIDED_PADS[: len(self.cfg.encoder_channels) - 1]:
            shape = sc.out_shape(shape, (3, 3, 3), (2, 2, 2), pad)
        return sc.out_shape(shape, (3, 1, 1), (2, 1, 1), (0, 0, 0))

    def _down(self, feats, coords, valid, shape, kernel, stride, pad, capacity, w, with_inverse):
        """Strided sparse conv of every sample -> (feats [B, Ko, Cout],
        coords, valid [B, Ko], out shape)."""
        outs, ocoords, ovalids = [], [], []
        for i in range(feats.shape[0]):
            with span("di.sparse.tables"):
                oc, ov, oshape = sc.downsample_sites(coords[i], valid[i], shape, kernel, stride, pad, capacity)
                st = sc.SparseTensor(feats[i], coords[i], valid[i], shape)
                snbr = sc.strided_neighbor_table(st, oc, ov, kernel, stride, pad)
                inv = sc.inverse_table(snbr, feats.shape[1]) if with_inverse else None
            outs.append(subm_conv_gemm(feats[i], snbr, w, ov, inv))
            ocoords.append(oc)
            ovalids.append(ov)
        return torch.stack(outs), ocoords, torch.stack(ovalids), oshape

    def plan(self, stage: int):
        """(T, W) of the banded plan at ``stage`` (JAX's ``banded_w``)."""
        return self.banded_t, self.banded_w[min(stage, len(self.banded_w) - 1)]

    def forward(self, voxel_feats, coords, valid, train: bool = False, bf16: bool = False, s2d: bool = False):
        """voxel_feats [B, K, Cin], coords [B, K, 3] (z, y, x) sorted by id,
        valid [B, K] -> BEV [B, ny/8, nx/8, C*nz]. ``train`` normalises
        with the batch's statistics and updates the running ones; ``bf16``
        runs the submanifold convs on K1's bf16 variant with the banded
        plan's overflow fallback, ``s2d`` on bf16 operands with one fp32
        sum."""
        cfg = self.cfg
        shape = tuple(cfg.sparse_shape)
        specs = cfg.encoder_channels
        grad = torch.is_grad_enabled()
        coords = list(coords)
        tables = _subm_tables(coords, valid, shape, grad, self.plan(0) if bf16 else None)
        feats = self.conv_input(voxel_feats, tables, valid, train, bf16, s2d)
        for i, blocks in enumerate(specs):
            last = i == len(specs) - 1
            n_basic = len(blocks) if last else len(blocks) - 1
            for j in range(n_basic):
                feats = getattr(self, f"stage{i}_block{j}")(feats, tables, valid, train, bf16, s2d)
            if last:
                break
            feats, coords, valid, shape = self._down(
                feats, coords, valid, shape, (3, 3, 3), (2, 2, 2), self.STRIDED_PADS[i],
                cfg.stage_capacities[i + 1], getattr(self, f"down{i}_w"), grad,
            )
            feats = F.relu(getattr(self, f"down{i}_bn")(feats, valid, train))
            tables = _subm_tables(coords, valid, shape, grad, self.plan(i + 1) if bf16 else None)

        feats, coords, valid, shape = self._down(
            feats, coords, valid, shape, (3, 1, 1), (2, 1, 1), (0, 0, 0), feats.shape[1],
            self.conv_out_w, grad,
        )
        feats = F.relu(self.conv_out_bn(feats, valid, train))
        return torch.stack([
            sc.to_dense_bev(sc.SparseTensor(feats[i], coords[i], valid[i], shape))
            for i in range(feats.shape[0])
        ])

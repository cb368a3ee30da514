"""The eval-time settings the JAX package reads from ``DI_*`` variables,
under its own names and with its shipped defaults.

With no ``DI_*`` variable set, the JAX package does not compute the
reference's exact math: its ``tools/test.py``, ``tools/train.py`` and
``bench.py`` run with these defaults (``deepinteraction_tpu/models/
mmri_encoder.py``, ``ops/deform_attn.py``, ``models/detector.py``).
``EvalLevers.from_env()`` reads them as the JAX package does, once, when
:class:`~deepinteraction_tpu_torch.models.detector.DeepInteraction` is
built; the modules take plain constructor arguments and read no variable
themselves. ``EvalLevers.parity()`` is the strict-parity set of
``tools/gate_eval.py`` (every deviation off).

=====================  ==========  ========================================
variable               default     what it does (train / eval)
=====================  ==========  ========================================
DI_I2P_SAMPLE          nearest     I2P keys sampled nearest, not bilinear
                                   (eval; train samples bilinear)
DI_I2P_VIEWS           2           each pillar keeps the keys of its 2
                                   views with the most hits (both; 0 = all)
DI_WARP_VIEWS          2           the BEVWarp depth scatter keeps each
                                   point's 2 best views (both; 0 = all)
DI_I2P_DEDUPE          0           gather the first N unique pixels a
                                   (pillar, view), log-count logit bias
                                   (eval, nearest with top views only)
DI_MSDA_JOINT_POINTS   4           MSDA keeps its top-k points over
                                   levels x points (eval, when k < l*p)
DI_MSDA_EVAL_POINTS    2           MSDA keeps its top-k points a level
                                   (eval, when the joint one does not apply)
DI_DEPTH_FILL_LITE     0           2 dilation rounds, no median or
                                   bilateral pass (eval)
DI_DENSE_BF16          0           ResNet, FPN, SECOND and SECONDFPN with
                                   bf16 activations (eval)
DI_I2P_DTYPE           float32     I2P keys, their projections and the
                                   attention's products in bf16, fp32
                                   accumulation and softmax (both;
                                   ``bfloat16`` is the other value)
DI_SPARSE_IMPL         banded      the 17 submanifold convs of the sparse
                                   encoder (K1) on bf16 operands, each
                                   tap's fp32 product rounded to bf16,
                                   fp32 sum over taps, fp32 for a sample-
                                   stage whose banded plan overflows
                                   (eval); ``s2d``: bf16 operands, one
                                   fp32 sum (both, on every device); any
                                   other value: fp32, as ``gather``
DI_SPARSE_TRAIN_IMPL   gather      the value train takes while
                                   DI_SPARSE_IMPL is ``banded``:
                                   ``banded`` puts the same K1 forward,
                                   and its mirror for d/dfeat, into train
DI_BANDED_T            128         the banded plan's tile rows
DI_BANDED_W            512         its window: one value, or one a stage
                                   (``512,384,320,256``; the last repeats)
DI_PALLAS_LOCATT       1           local attention (K2) at the precision
                                   DI_LOCATT_MXU names (eval); ``0``: fp32
DI_PALLAS_LOCATT_TRAIN 0           ``1`` puts that K2 forward into train;
                                   the backward stays fp32
DI_LOCATT_MXU          bf16        K2's q, k, v and its normalised
                                   probabilities in bf16, fp32 sums and
                                   softmax; ``f32``: fp32
=====================  ==========  ========================================

``DI_SPARSE_IMPL`` ... ``DI_LOCATT_MXU`` are the precisions of the two
Pallas kernels. The JAX package applies ``banded`` and K2's settings only on
its TPU (``models/sparse_encoder.py::_resolve_impl``,
``ops/local_attention_pallas.py::local_attention_auto``); off it, it
computes fp32. The port applies them only where the model's tensors are on
CUDA (:meth:`EvalLevers.k1_numerics`, :meth:`EvalLevers.bf16_kernels`), so
on the CPU it computes fp32 too; ``s2d`` it applies everywhere, as JAX does.
The fp32 kernels on the card: ``DI_SPARSE_IMPL=gather DI_LOCATT_MXU=f32``.
``DI_BANDED_T`` and ``DI_BANDED_W`` set the plan whose overflow flag
(``ops/sparse_conv.py::banded_overflow``) sends a sample-stage's convs to
fp32, as JAX's ``_banded_apply`` does; they change no other number.

The JAX package's other ``DI_*`` names choose among TPU implementations of
the same math and have no counterpart here (ROADMAP.md lists them).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Mapping, Optional

# name -> (EvalLevers field, the JAX package's default)
ENV = {
    "DI_I2P_SAMPLE": ("i2p_sample", "nearest"),
    "DI_I2P_VIEWS": ("i2p_views", "2"),
    "DI_WARP_VIEWS": ("warp_views", "2"),
    "DI_I2P_DEDUPE": ("i2p_dedupe", "0"),
    "DI_MSDA_JOINT_POINTS": ("msda_joint_points", "4"),
    "DI_MSDA_EVAL_POINTS": ("msda_eval_points", "2"),
    "DI_DEPTH_FILL_LITE": ("depth_fill_lite", "0"),
    "DI_DENSE_BF16": ("dense_bf16", "0"),
    "DI_I2P_DTYPE": ("i2p_dtype", "float32"),
    "DI_SPARSE_IMPL": ("sparse_impl", "banded"),
    "DI_SPARSE_TRAIN_IMPL": ("sparse_train_impl", "gather"),
    "DI_BANDED_T": ("banded_t", "128"),
    "DI_BANDED_W": ("banded_w", "512"),
    "DI_PALLAS_LOCATT": ("pallas_locatt", "1"),
    "DI_PALLAS_LOCATT_TRAIN": ("pallas_locatt_train", "0"),
    "DI_LOCATT_MXU": ("locatt_mxu", "bf16"),
}

# the JAX gate tool's strict-parity set (``tools/gate_eval.py::PARITY``)
PARITY = {
    "DI_MSDA_JOINT_POINTS": "0",
    "DI_MSDA_EVAL_POINTS": "0",
    "DI_I2P_SAMPLE": "bilinear",
    "DI_I2P_VIEWS": "0",
    "DI_WARP_VIEWS": "0",
    "DI_SPARSE_IMPL": "gather",
    "DI_DEPTH_FILL_LITE": "0",
    "DI_DENSE_BF16": "0",
}


@dataclasses.dataclass(frozen=True)
class EvalLevers:
    i2p_sample: str = "nearest"
    i2p_views: int = 2
    warp_views: int = 2
    i2p_dedupe: int = 0
    msda_joint_points: int = 4
    msda_eval_points: int = 2
    depth_fill_lite: bool = False
    dense_bf16: bool = False
    i2p_dtype: str = "float32"
    sparse_impl: str = "banded"
    sparse_train_impl: str = "gather"
    banded_t: int = 128
    banded_w: str = "512"
    pallas_locatt: bool = True
    pallas_locatt_train: bool = False
    locatt_mxu: str = "bf16"

    def __post_init__(self):
        if self.i2p_sample not in ("nearest", "bilinear"):
            raise ValueError(f"i2p_sample must be 'nearest' or 'bilinear', not {self.i2p_sample!r}")
        if self.i2p_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"i2p_dtype must be 'float32' or 'bfloat16', not {self.i2p_dtype!r}")
        if self.banded_t < 1 or min(self.banded_windows()) < 1:
            raise ValueError(f"banded_t and banded_w must be positive, not {self.banded_t}, {self.banded_w!r}")

    def banded_windows(self) -> tuple:
        """DI_BANDED_W as JAX reads it (``models/sparse_encoder.py:58-62``):
        the window of stage i is the i-th value, the last one repeating."""
        return tuple(int(x) for x in self.banded_w.split(","))

    @classmethod
    def from_env(cls, environ: Optional[Mapping[str, str]] = None) -> "EvalLevers":
        """The settings as the JAX package reads them from ``environ``
        (``os.environ`` by default): a flag is on only when it is ``1``."""
        env = os.environ if environ is None else environ
        kw = {}
        for name, (field, default) in ENV.items():
            raw = env.get(name, default)
            kind = cls.__dataclass_fields__[field].type
            if kind == "bool":
                kw[field] = raw == "1"
            elif kind == "int":
                kw[field] = int(raw)
            else:
                kw[field] = raw
        return cls(**kw)

    @classmethod
    def parity(cls) -> "EvalLevers":
        """The gate tool's ``PARITY`` set over the defaults: the reference's
        math but K2's bf16 operands."""
        return cls.from_env(PARITY)

    def k1_numerics(self, train: bool, cuda: bool) -> str:
        """The sparse encoder's submanifold convs in this mode, as JAX's
        ``SparseEncoder`` resolves its implementation (train takes
        DI_SPARSE_TRAIN_IMPL while DI_SPARSE_IMPL is ``banded``): ``banded``
        (K1's bf16 variant, each tap's product rounded, the overflow
        fallback) where the tensors are on CUDA (``cuda``), fp32 elsewhere,
        as JAX runs it only on its TPU; ``s2d`` (bf16 operands, one fp32
        sum) on every device; otherwise ``fp32``."""
        impl = self.sparse_train_impl if train and self.sparse_impl == "banded" else self.sparse_impl
        if impl == "banded":
            return "banded" if cuda else "fp32"
        return "s2d" if impl == "s2d" else "fp32"

    def bf16_kernels(self, train: bool, cuda: bool) -> tuple:
        """(K1, K2): whether the sparse encoder's submanifold convs run K1's
        banded numerics (:meth:`k1_numerics`) and the local attention K2's
        bf16 variant in this mode, where the model's tensors are on CUDA
        (``cuda``); fp32 elsewhere, as the JAX package computes fp32 off its
        TPU."""
        k2 = cuda and self.pallas_locatt and (not train or self.pallas_locatt_train) and self.locatt_mxu != "f32"
        return self.k1_numerics(train, cuda) == "banded", k2

    def as_env(self) -> dict:
        """The ``DI_*`` variables that give these settings."""
        out = {}
        for name, (field, _) in ENV.items():
            val = getattr(self, field)
            out[name] = ("1" if val else "0") if isinstance(val, bool) else str(val)
        return out

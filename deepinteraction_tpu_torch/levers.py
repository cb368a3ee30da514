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
=====================  ==========  ========================================

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

    def __post_init__(self):
        if self.i2p_sample not in ("nearest", "bilinear"):
            raise ValueError(f"i2p_sample must be 'nearest' or 'bilinear', not {self.i2p_sample!r}")
        if self.i2p_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"i2p_dtype must be 'float32' or 'bfloat16', not {self.i2p_dtype!r}")

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
        """Every deviation off: the reference's math (the gate tool's
        ``PARITY`` set)."""
        return cls(i2p_sample="bilinear", i2p_views=0, warp_views=0, i2p_dedupe=0, msda_joint_points=0,
                   msda_eval_points=0, depth_fill_lite=False, dense_bf16=False, i2p_dtype="float32")

    def as_env(self) -> dict:
        """The ``DI_*`` variables that give these settings."""
        out = {}
        for name, (field, _) in ENV.items():
            val = getattr(self, field)
            out[name] = ("1" if val else "0") if isinstance(val, bool) else str(val)
        return out

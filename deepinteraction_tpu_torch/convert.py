"""Weight bridge: JAX package variables -> the port's ``state_dict``.

The port names its submodules after the Flax module tree
(``img_backbone.layer1_0.conv1``, ``pts_middle_encoder.stage0_block0``,
``imgpts_neck.layer0.p_iml.q0``, ...), so one generic rule set maps every
leaf. A Flax variable path is ``<collection>/<module path>/<leaf>``, with the
module path of torch module ``a.b.c`` being ``a/b/c``:

- ``Conv2d``: ``kernel [kh, kw, I, O]`` -> ``weight [O, I, kh, kw]``; ``bias``.
- ``ConvTranspose2d`` (Flax ``transpose_kernel=True``): ``kernel
  [kh, kw, O, I]`` -> ``weight [I, O, kh, kw]``.
- ``Linear``: ``kernel [I, O]`` -> ``weight [O, I]``; ``bias``.
- ``LayerNorm``: ``scale``, ``bias`` -> ``weight``, ``bias``.
- ``BatchNorm``: ``params/scale``, ``params/bias``, ``batch_stats/mean``,
  ``batch_stats/var`` -> ``weight``, ``bias``, ``running_mean``,
  ``running_var``.
- any other parameter (the sparse conv weights ``[27, I, O]``): as it is,
  under its own name.

Flax leaves whose names hold a literal slash (``MMRI_I2P``'s
``"q_proj/kernel"``) flatten to the same path as a nested ``q_proj`` Dense,
so they need no rule of their own. The bridge is strict: it raises on any
leaf it does not consume, any parameter or buffer it does not fill, and any
shape mismatch.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from .models.layers import BatchNorm

# (torch key, flax path, flax array -> torch array, torch shape -> flax shape)
_Rule = Tuple[str, str, Callable[[np.ndarray], np.ndarray], Callable[[tuple], tuple]]


def _same(a):
    return a


def _conv_from_flax(a):
    return a.transpose(3, 2, 0, 1)


def _conv_shape(s):
    return (s[2], s[3], s[1], s[0])


def _dense_from_flax(a):
    return a.T


def _dense_shape(s):
    return (s[1], s[0])


def flatten_variables(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested ``{"params": ..., "batch_stats": ...}`` -> ``{"a/b/c": array}``.
    An already-flat mapping passes through."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(flatten_variables(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _rules(model: nn.Module) -> List[_Rule]:
    rules: List[_Rule] = []
    for name, mod in model.named_modules():
        p = name.replace(".", "/")
        key = f"{name}." if name else ""
        pp = f"params/{p}/" if p else "params/"
        if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
            rules.append((key + "weight", pp + "kernel", _conv_from_flax, _conv_shape))
            if mod.bias is not None:
                rules.append((key + "bias", pp + "bias", _same, _same))
        elif isinstance(mod, nn.Linear):
            rules.append((key + "weight", pp + "kernel", _dense_from_flax, _dense_shape))
            if mod.bias is not None:
                rules.append((key + "bias", pp + "bias", _same, _same))
        elif isinstance(mod, nn.LayerNorm):
            rules.append((key + "weight", pp + "scale", _same, _same))
            rules.append((key + "bias", pp + "bias", _same, _same))
        elif isinstance(mod, BatchNorm):
            rules.append((key + "weight", pp + "scale", _same, _same))
            rules.append((key + "bias", pp + "bias", _same, _same))
            rules.append((key + "running_mean", f"batch_stats/{p}/mean", _same, _same))
            rules.append((key + "running_var", f"batch_stats/{p}/var", _same, _same))
        else:
            for pname, _ in mod.named_parameters(recurse=False):
                rules.append((key + pname, pp + pname, _same, _same))
    return rules


def flax_leaf_shapes(model: nn.Module) -> Dict[str, tuple]:
    """The Flax variable paths and shapes that ``model`` corresponds to."""
    sd = model.state_dict()
    return {fpath: tuple(shape_fn(tuple(sd[tkey].shape))) for tkey, fpath, _, shape_fn in _rules(model)}


def params_from_flax(variables, model: nn.Module) -> Dict[str, torch.Tensor]:
    """Map JAX variables (nested or flat, as numpy) onto ``model``'s
    ``state_dict`` keys. Strict: raises ``KeyError`` on a missing or an
    unconsumed leaf and ``ValueError`` on a shape mismatch."""
    flat = flatten_variables(variables)
    want = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    consumed = set()
    for tkey, fpath, from_flax, _ in _rules(model):
        if fpath not in flat:
            raise KeyError(f"flax leaf {fpath!r} (for {tkey!r}) is missing")
        arr = np.ascontiguousarray(from_flax(flat[fpath]))
        if tuple(arr.shape) != tuple(want[tkey].shape):
            raise ValueError(
                f"{fpath!r} -> {tkey!r}: shape {arr.shape} != {tuple(want[tkey].shape)}"
            )
        out[tkey] = torch.from_numpy(arr.astype(np.float32))
        consumed.add(fpath)
    extra = sorted(set(flat) - consumed)
    if extra:
        raise KeyError(f"flax leaves not consumed by the port: {extra[:10]}")
    unfilled = sorted(set(want) - set(out))
    if unfilled:
        raise KeyError(f"port parameters/buffers not filled: {unfilled[:10]}")
    return out


def load_flax(model: nn.Module, variables) -> nn.Module:
    """``params_from_flax`` + ``load_state_dict(strict=True)``."""
    model.load_state_dict(params_from_flax(variables, model), strict=True)
    return model

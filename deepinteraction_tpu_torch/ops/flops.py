"""Useful operations of the port's kernels, and the switch that shows them
to ``torch.utils.flop_counter.FlopCounterMode``.

The kernels launch through ctypes, which a dispatch mode cannot see, and
on the CPU their plain versions would be counted by their own arithmetic
(a gathered matmul over every tap, misses included). So each kernel has
one formula, the operations its work needs on these inputs, used alike by
the FLOP count (``tools/get_flops.py``) and by the bounds of
``chip_smoke.py``:

- K1 (forward, d/dfeat and d/dW): 2 * Cin * Cout for each hit of the table
  the kernel walks (for the forward, on a valid output row);
- K2 forward: 4 * k^2 * C a pixel (the q.k dot and the weighted sum of v
  over the k x k window);
- K2 backward: 10 * k^2 * C a pixel (q.k, dO.v, dS k, dS q and P dO).

While :func:`counting_kernels` is active, each kernel wrapper calls its
kernel (or, on a CPU tensor, its plain version) through a custom operator
whose FLOP formula is the one above; the dispatch mode is off while that
operator runs, so the plain version's own matmuls are not counted. Outside
it the wrappers read one Python bool and launch exactly as before.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Sequence

import torch

counting = False


def k1_hits(table: torch.Tensor, kin: int, valid: Optional[torch.Tensor] = None) -> int:
    """Hits of a K1 table [Ko, D] over ``kin`` input rows (``kin`` marks a
    miss), on valid output rows only where ``valid`` [Ko] is given."""
    hit = table < kin
    if valid is not None:
        hit = hit & valid[:, None]
    return int(hit.sum().item())


def k1_ops(hits: int, cin: int, cout: int) -> int:
    return 2 * hits * cin * cout


def k2_ops(shape: Sequence[int], kernel: int, backward: bool = False) -> int:
    """Operations of K2 (or its backward) on [B, H, W, C] maps."""
    b, h, w, c = shape
    return (10 if backward else 4) * kernel * kernel * c * b * h * w


@contextlib.contextmanager
def counting_kernels() -> Iterator[None]:
    """Route the kernel wrappers through their counted operators."""
    global counting
    from . import local_attention, subm_conv

    subm_conv.counted_ops()
    local_attention.counted_ops()
    saved, counting = counting, True
    try:
        yield
    finally:
        counting = saved


def count_flops(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` under ``FlopCounterMode`` with the kernels
    counted by their formulas: returns (its result, total operations, the
    operations by operator name)."""
    from torch.utils.flop_counter import FlopCounterMode

    with counting_kernels(), FlopCounterMode(display=False) as mode:
        out = fn(*args, **kwargs)
    by_op = {str(op): n for op, n in mode.get_flop_counts().get("Global", {}).items()}
    return out, mode.get_total_flops(), by_op

"""The tile geometry of K2's bf16 kernel (``csrc/local_attention_bf16.cu``)
on the CPU: a numpy model of its decomposition against the plain version
``local_attention(..., bf16=True)`` and, at one shape, JAX's Pallas kernel
in interpret mode.

The model reads the kernel's tile and halo constants (``kTH``, ``kTW``,
``kNCol``) from the source and computes what its blocks and warps compute:
each ``kTH x kTW`` query tile stages a halo of ``kTH + 2R`` rows and
``kNCol`` columns from ``(y0 - R, x0 - R)``, zero outside the map; each
warp takes 8 columns of two adjacent query rows (its 16 mma rows) against
its band of ``k + 1`` halo rows of 16 columns, block-dense, from q and k
rounded to bf16; the geometric window mask; the fp32 softmax over the taps
it keeps; P rounded to bf16 after ``p / den``; ``P V`` over the band with v
rounded to bf16. So a tile, halo or band that misses a tap, or a mask that
keeps a wrong one, shows here, at shapes that straddle the tiles' edges,
for every kernel size the kernel takes.

Tolerance: 1e-4 of scale, and at most 1 % of the outputs more than 1e-6 of
scale apart. A probability whose fp32 quotient p / den lies next to a bf16
rounding boundary rounds to one side or the other depending on the order
of the sums before it (the note of ``test_torch_port_bf16_kernels.py::
test_k2_bf16_plain_matches_pallas_kernel``), and one such flip moves an
output by up to ~2e-3 of scale. So the model takes each kept tap's logit,
its exp and each query's sum with the plain version's torch operations on
the same lengths (the logit a sum over C, the softmax over the k^2 taps in
window order): where its geometry is right its P is the plain version's,
bit for bit, and only P V's order differs. JAX's kernel sums in XLA's
order: it is compared at ``test_k2_bf16_plain_matches_pallas_kernel``'s
inputs at k = 9, [1, 16, 24, 128], which straddle the tiles' columns.
"""

import math
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepinteraction_tpu.ops.local_attention_pallas import _pallas_forward
from deepinteraction_tpu_torch.ops import cuda_lib
from deepinteraction_tpu_torch.ops import local_attention as la

SOURCE = os.path.join(cuda_lib.CSRC_DIR, "local_attention_bf16.cu")
TOL = 1e-4
MOVED = 1e-2


def kernel_constants() -> dict:
    """The ``constexpr int`` constants of the kernel's source."""
    with open(SOURCE) as f:
        return {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", f.read())}


def round_bf16(x: np.ndarray) -> np.ndarray:
    """float32 rounded to the nearest bf16 (ties to even), as float32."""
    b = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    b = (b + np.uint32(0x7FFF) + ((b >> 16) & np.uint32(1))) & np.uint32(0xFFFF0000)
    return b.view(np.float32)


def tile_model(q: np.ndarray, k: np.ndarray, v: np.ndarray, kernel: int) -> np.ndarray:
    """K2's bf16 forward computed tile by tile and warp by warp as the kernel
    decomposes it."""
    cst = kernel_constants()
    th, tw, ncol = cst["kTH"], cst["kTW"], cst["kNCol"]
    b, h, w, c = q.shape
    r = kernel // 2
    hr, nh = th + 2 * r, kernel + 1
    assert tw % 8 == 0 and th % 2 == 0 and tw + 2 * r <= ncol
    scale = 1.0 / math.sqrt(c)  # as the plain version multiplies
    qb, kb, vb = round_bf16(q), round_bf16(k), round_bf16(v)
    ty, tx = -(-h // th), -(-w // tw)
    # zero fill: R rows and columns before the map, enough after it for
    # every tile's halo
    pad = ((0, 0), (r, ty * th + hr - h), (r, tx * tw + ncol - w), (0, 0))
    kp, vp = np.pad(kb, pad), np.pad(vb, pad)
    qp = np.pad(qb, ((0, 0), (0, ty * th - h), (0, tx * tw - w), (0, 0)))
    out = np.zeros((b, ty * th, tx * tw, c), np.float32)
    # a warp's mma row m: query column m % 8 of its upper (m < 8) or lower
    # row; its key j: halo row j // 16 of its band, column j % 16
    m = np.arange(16)[:, None]
    j = np.arange(nh * 16)[None, :]
    d, dy = j % 16 - m % 8, j // 16 - m // 8
    inside = torch.from_numpy((d >= 0) & (d < kernel) & (dy >= 0) & (dy < kernel))
    for n in range(b):
        for by in range(ty):
            for bx in range(tx):
                y0, x0 = by * th, bx * tw
                # the tile's halo: rows y0 - R .., columns x0 - R .. (padded coordinates y0, x0)
                khalo = kp[n, y0:y0 + hr, x0:x0 + ncol]
                vhalo = vp[n, y0:y0 + hr, x0:x0 + ncol]
                for pr in range(th // 2):
                    for cw in range(tw // 8):
                        rows = slice(y0 + 2 * pr, y0 + 2 * pr + 2)
                        cols = slice(x0 + 8 * cw, x0 + 8 * cw + 8)
                        qw = qp[n, rows, cols].reshape(16, c)
                        band = (slice(2 * pr, 2 * pr + nh), slice(8 * cw, 8 * cw + 16))
                        kw, vw = khalo[band].reshape(-1, c), vhalo[band].reshape(-1, c)
                        s = (torch.from_numpy(qw)[:, None] * torch.from_numpy(kw)[None]).sum(-1) * scale
                        # the kept taps of each row in window order (row-major in the band)
                        x = s[inside].view(16, kernel * kernel)
                        p = torch.exp(x - x.amax(-1, keepdim=True))
                        pband = torch.zeros_like(s)
                        pband[inside] = (p / p.sum(-1, keepdim=True)).flatten()
                        pn = round_bf16(pband.numpy())
                        out[n, rows, cols] = (pn @ vw).astype(np.float32).reshape(2, 8, c)
    return out[:, :h, :w]


def _check(got: np.ndarray, ref: np.ndarray) -> None:
    scale = np.abs(ref).max()
    diff = np.abs(got - ref)
    assert diff.max() <= TOL * scale, diff.max() / scale
    assert (diff > 1e-6 * scale).mean() <= MOVED


# shapes straddling the 8 x 16 query tiles: one row or column past a tile,
# one short of it, and a map smaller than the window; C not a multiple of
# the kernel's 32-channel stages
@pytest.mark.parametrize("shape,kernel,pallas", [
    ((1, 9, 17, 24), 1, False), ((2, 16, 33, 8), 1, False),
    ((1, 9, 17, 24), 3, False), ((1, 15, 31, 40), 3, False),
    ((1, 17, 15, 40), 5, False), ((2, 8, 16, 8), 5, False),
    ((1, 9, 33, 24), 7, False), ((1, 23, 17, 8), 7, False),
    ((1, 17, 33, 40), 9, False), ((1, 5, 7, 16), 9, False),
    ((1, 16, 24, 128), 9, True),
])
def test_k2_bf16_tile_model(shape, kernel, pallas):
    # the Pallas case: test_torch_port_bf16_kernels.py's K2 inputs (seeded sum(shape))
    rng = np.random.default_rng(sum(shape) + (0 if pallas else kernel))
    q, k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    got = tile_model(q, k, v, kernel)
    ref = la.local_attention(*(torch.from_numpy(a) for a in (q, k, v)), kernel, bf16=True).numpy()
    _check(got, ref)
    if pallas:
        _check(got, np.asarray(_pallas_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kernel, interpret=True)))

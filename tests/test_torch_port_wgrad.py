"""K1's weight gradient as the port's kernel takes it (``subm_conv_wgrad``,
``deepinteraction_tpu_torch/csrc/subm_conv.cu``), emulated in plain torch on
the CPU, against the float64 result, the port's plain ``gathered_wgrad`` and
``jax.vjp`` of the JAX package's ``ops/sparse_conv.py::gathered_matmul`` with
respect to the weights.

The kernel computes ``dW[d] = sum_i feat[nbr[i, d]]^T dy[i]`` (a table entry
outside ``[0, K)`` is a miss, a zero row) per chunk of rows and tap:

- the chunk's rows in order, 8 at a time (the depth of one ``mma.sync``
  m16n8k8), each step in split TF32 (emulated as in
  ``tests/test_torch_port_split_tf32.py``): lo_a hi_b, hi_a lo_b, hi_a hi_b,
  each product added to the fp32 accumulator in that order;
- for the 16-wide output tile, four warps each take every fourth step of a
  32-row tile and are summed in warp order at the end;
- one partial per chunk, the partials summed in chunk order.

Skipped tiles and steps (every row a miss) add exact zeros, so the emulation
takes them. Each case is held to 1e-4 of the reference's scale, the kernel's
tolerance on the card (``K1_TOL``), with the chunk size a parameter so that a
few thousand rows make several chunks.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepinteraction_tpu.ops import sparse_conv as jsc
from deepinteraction_tpu_torch.ops import subm_conv as tsm

from test_torch_port_split_tf32 import rna_tf32, split

torch.set_num_threads(1)

K1_TOL = 1e-4  # max|d| / max|ref|, as on the card
TILE_ROWS = 32  # rows of one kernel tile: 4 steps of 8


def kernel_wgrad(features, nbr, dy, rows_per_chunk: int, split=split) -> torch.Tensor:
    """dW by the kernel's order of operations; ``rows_per_chunk`` is a
    multiple of the 32-row tile; ``split`` takes x to its TF32 (hi, lo)."""
    assert rows_per_chunk % TILE_ROWS == 0
    kin, cin = features.shape
    ko, taps = nbr.shape
    cout = dy.shape[1]
    warps_k = 4 if max(cin, cout) <= 16 else 1
    table = torch.cat([features, features.new_zeros(1, cin)])
    idx = nbr.long()
    idx = torch.where((idx < 0) | (idx >= kin), kin, idx)
    out = torch.zeros(taps, cin, cout)
    for r0 in range(0, ko, rows_per_chunk):
        rows = min(rows_per_chunk, ko - r0)
        pad = -rows % 8
        steps = (rows + pad) // 8
        g_dy = torch.cat([dy[r0 : r0 + rows], dy.new_zeros(pad, cout)]).reshape(steps, 8, cout)
        bh, bl = split(g_dy)
        ids = torch.cat([idx[r0 : r0 + rows], idx.new_full((pad, taps), kin)])
        for d in range(taps):
            a = table[ids[:, d]].reshape(steps, 8, cin)
            ah, al = split(a)
            prods = [al.transpose(1, 2) @ bh, ah.transpose(1, 2) @ bl, ah.transpose(1, 2) @ bh]
            acc = [torch.zeros(cin, cout) for _ in range(warps_k)]
            for s in range(steps):
                w = (s % (TILE_ROWS // 8)) % warps_k
                for p in prods:
                    acc[w] = acc[w] + p[s]
            part = acc[0]
            for w in range(1, warps_k):
                part = part + acc[w]
            out[d] = out[d] + part
    return out


def _case(seed, ko, cin, cout, taps, hits, empty=()):
    """A table with about ``hits`` hits per row, some of them negative
    indices, taps ``empty`` missing everywhere, 10 % of the rows invalid
    (their dy zeroed, as the wrapper's backward does)."""
    rng = np.random.default_rng(seed)
    k = ko + 17
    feats = rng.normal(size=(k, cin)).astype(np.float32)
    nbr = rng.integers(0, k, size=(ko, taps)).astype(np.int32)
    miss = rng.uniform(size=nbr.shape) >= hits / taps
    nbr[miss] = np.where(rng.uniform(size=nbr.shape) < 0.5, k, -1)[miss]
    nbr[:, list(empty)] = k
    valid = rng.uniform(size=ko) >= 0.1
    dy = np.where(valid[:, None], rng.normal(size=(ko, cout)), 0.0).astype(np.float32)
    return feats, nbr, dy, valid


@pytest.mark.parametrize(
    "ko,cin,cout,taps,hits,rows_per_chunk,empty",
    [
        (3_000, 16, 16, 27, 1.1, 1024, ()),  # stage 0: ~1.1 hits per row
        (1_500, 128, 128, 27, 11.4, 512, ()),  # stage 3: ~11 hits per row
        (1_000, 128, 128, 3, 2.0, 256, ()),  # conv_out's 3-tap table
        (2_000, 5, 16, 27, 2.0, 512, ()),  # conv_input, Cin 5
        (1_037, 40, 72, 27, 8.0, 320, ()),  # ragged: rows past a tile and a chunk
        (777, 32, 64, 27, 6.0, 256, (3, 20)),  # two taps no row hits
    ],
)
def test_kernel_wgrad_within_tolerance(ko, cin, cout, taps, hits, rows_per_chunk, empty):
    feats, nbr, dy, valid = _case(ko + cin + taps, ko, cin, cout, taps, hits, empty)
    f, n, g = (torch.from_numpy(a) for a in (feats, nbr, dy))
    got = kernel_wgrad(f, n, g, rows_per_chunk)
    w = np.zeros((taps, cin, cout), np.float32)
    _, vjp = jax.vjp(lambda w: jsc.gathered_matmul(jnp.asarray(feats), jnp.asarray(nbr), w, jnp.asarray(valid)),
                     jnp.asarray(w))
    refs = {
        "float64": tsm.gathered_wgrad(f.double(), n, g.double()).float(),
        "plain": tsm.gathered_wgrad(f, n, g),
        "jax": torch.from_numpy(np.array(vjp(jnp.asarray(dy))[0])),
    }
    for name, ref in refs.items():
        rel = (got - ref).abs().max().item() / ref.abs().max().item()
        assert rel <= K1_TOL, (name, rel)
    for d in empty:
        assert torch.all(got[d] == 0) and torch.all(refs["plain"][d] == 0)


def test_one_tf32_pass_breaks_wgrad_tolerance():
    """hi_a hi_b alone misses the float64 result by more than 1e-4 of its
    scale at the stage-3-like case (sums of ~640 products of 128-wide rows),
    which is why the kernel splits."""
    feats, nbr, dy, _ = _case(1, 1_500, 128, 128, 27, 11.4)
    f, n, g = (torch.from_numpy(a) for a in (feats, nbr, dy))
    ref = tsm.gathered_wgrad(f.double(), n, g.double()).float()

    def err(got):
        return (got - ref).abs().max().item() / ref.abs().max().item()

    one = err(kernel_wgrad(f, n, g, 512, split=lambda x: (rna_tf32(x), torch.zeros_like(x))))
    three = err(kernel_wgrad(f, n, g, 512))
    assert one > K1_TOL > three, (one, three)

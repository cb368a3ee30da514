"""Split TF32 ("3xTF32"), the arithmetic of the port's tensor-core kernels
(K1 ``subm_conv_gemm`` and K2 ``local_attn_fwd``, ``deepinteraction_tpu_torch/
csrc/``), emulated in plain torch on the CPU.

A kernel splits each fp32 operand as ``hi = rna_tf32(x)``, ``lo =
rna_tf32(x - hi)`` (PTX ``cvt.rna.tf32.f32``: 10 mantissa bits, nearest, ties
away from zero) and takes a product as ``lo_a hi_b + hi_a lo_b + hi_a hi_b``,
the small terms first, summed in fp32. A product of two TF32 values is exact
in fp32, so fp32 matmuls of the split parts emulate the tensor cores' sums.

At small K1 stage-3-like and K2-like sizes, the split results stay within the
kernels' tolerances (K1: 1e-4 of the output's scale; K2: 2e-5 absolute and
relative) of fp32 arithmetic: of the exact result rounded to fp32, of the
port's plain versions and of the JAX package's XLA forms. One TF32 pass
(``hi_a hi_b``) breaks K2's 2e-5 at C=128, which is why the kernels split.
Nothing on the main path calls this emulation.
"""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from deepinteraction_tpu.ops import local_attention as jla
from deepinteraction_tpu.ops import sparse_conv as jsc
from deepinteraction_tpu_torch.ops import local_attention as tla
from deepinteraction_tpu_torch.ops import subm_conv as tsm

torch.set_num_threads(1)

K1_TOL = 1e-4  # max|d| / max|ref|, as tests/test_torch_port_kernels.py
K2_TOL = 2e-5  # absolute and relative, as tests/test_torch_port_kernels.py


def rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest TF32 value, ties away from zero (finite x): add
    half of the 13 dropped mantissa bits' range to the sign-magnitude bit
    pattern, then clear them."""
    u = x.contiguous().view(torch.int32)
    return ((u + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor) -> tuple:
    hi = rna_tf32(x)
    return hi, rna_tf32(x - hi)


def split_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernels take it: three TF32 products, small terms first."""
    ah, al = split(a)
    bh, bl = split(b)
    return (al @ bh + ah @ bl) + ah @ bh


def tf32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in one TF32 pass."""
    return rna_tf32(a) @ rna_tf32(b)


def exact_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.double() @ b.double()).float()


def gathered(features, nbr, weights, valid_out, mm):
    """K1's function with the matmul ``mm``."""
    kin, cin = features.shape
    table = torch.cat([features, features.new_zeros(1, cin)], 0)
    g = table[nbr.clamp(max=kin).long()]
    out = mm(g.reshape(g.shape[0], -1), weights.reshape(-1, weights.shape[-1]))
    return torch.where(valid_out[:, None], out, out.new_zeros(()))


def attention(q, k, v, kernel, mm):
    """K2's function with the matmul ``mm`` (logits and weighted sum); the
    softmax is fp32 as in the kernel."""
    _, h, w, c = q.shape
    r = kernel // 2

    def windows(x):  # [B, H, W, k*k, C], zero outside the map
        xp = F.pad(x, (0, 0, r, r, r, r))
        return torch.stack([xp[:, dh : dh + h, dw : dw + w] for dh in range(kernel) for dw in range(kernel)], -2)

    logits = mm(q[..., None, :], windows(k).transpose(-1, -2))[..., 0, :]
    p = torch.softmax(logits * (1.0 / math.sqrt(c)), -1)
    return mm(p[..., None, :], windows(v))[..., 0, :]


def _k1_case(rng, ko, cin, cout, taps, miss):
    feats = rng.normal(size=(ko, cin)).astype(np.float32)
    nbr = rng.integers(0, ko, size=(ko, taps)).astype(np.int32)
    nbr[rng.uniform(size=nbr.shape) < miss] = ko
    w = (rng.normal(size=(taps, cin, cout)) / np.sqrt(taps * cin)).astype(np.float32)
    valid = np.arange(ko) < ko - ko // 10
    return [torch.from_numpy(a) for a in (feats, nbr, w, valid)]


def test_rna_tf32_rounds_as_ptx():
    one = torch.tensor([1.0])
    ulp = 2.0**-10  # TF32's unit in the last place at 1
    x = torch.tensor([1 + ulp / 2, 1 + ulp / 4, 1 + 3 * ulp / 4, -(1 + ulp / 2), 3.0, 0.0, -1e-30])
    want = torch.tensor([1 + ulp, 1.0, 1 + ulp, -(1 + ulp), 3.0, 0.0, -1e-30])
    got = rna_tf32(x)
    assert torch.equal(got[:6], want[:6])  # ties go away from zero
    assert torch.equal(got[6:], rna_tf32(want[6:]))
    assert rna_tf32(one * (2 - ulp / 2)).item() == 2.0  # carries into the exponent
    r = torch.from_numpy(np.random.default_rng(0).normal(size=10_000).astype(np.float32)) * 1e3
    hi, lo = split(r)
    assert torch.all((hi.view(torch.int32) & 0x1FFF) == 0) and torch.all((lo.view(torch.int32) & 0x1FFF) == 0)
    assert torch.all((r - hi).abs() <= 2.0**-11 * r.abs())
    # hi + lo keeps 22 of fp32's 24 bits: the split loses about 2^-22 of |x|
    assert torch.all((r - (hi + lo)).abs() <= 2.0**-21 * r.abs())


@pytest.mark.parametrize(
    "ko,cin,cout,taps,miss",
    [
        (600, 128, 128, 27, 0.58),  # stage 3: ~11 hits per row
        (600, 128, 128, 3, 0.3),  # conv_out's 3-tap table
        (900, 16, 16, 27, 0.96),  # stage 0: ~1.1 hits per row
        (700, 5, 16, 27, 0.9),  # conv_input
    ],
)
def test_split_k1_within_tolerance(ko, cin, cout, taps, miss):
    args = _k1_case(np.random.default_rng(cin + taps), ko, cin, cout, taps, miss)
    got = gathered(*args, split_matmul)
    feats, nbr, w, valid = args
    refs = {
        "exact": gathered(*args, exact_matmul),
        "plain": tsm.gathered_matmul(*args),
        "xla": torch.from_numpy(np.array(jsc.gathered_matmul(jnp.asarray(feats.numpy()), jnp.asarray(nbr.numpy()),
                                                               jnp.asarray(w.numpy()), jnp.asarray(valid.numpy())))),
    }
    for name, ref in refs.items():
        rel = (got - ref).abs().max().item() / ref.abs().max().item()
        assert rel <= K1_TOL, (name, rel)


@pytest.mark.parametrize(
    "shape,kernel,sharp",
    [
        ((1, 12, 14, 128), 9, False),  # p2i_local / i_iml / p_iml width
        ((2, 9, 11, 40), 5, False),
        ((1, 37, 45, 128), 9, True),  # q and k x8: sharp softmax
    ],
)
def test_split_k2_within_tolerance(shape, kernel, sharp):
    """``sharp``: q and k are +-8, as in the card test of the sharp softmax.
    Their logits are exact; with normal entries x8 the fp32 rounding of the
    logits alone moves the output by about the tolerance (an fp32 matmul in
    this emulation misses the exact result by 1.1 times it at this shape)."""
    rng = np.random.default_rng(sum(shape) + kernel)
    q, k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    if sharp:
        q, k = 8 * np.sign(q), 8 * np.sign(k)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = attention(tq, tk, tv, kernel, split_matmul)
    refs = {
        "exact": attention(tq.double(), tk.double(), tv.double(), kernel, torch.matmul).float(),
        "plain": tla.local_attention(tq, tk, tv, kernel),
        "xla": torch.from_numpy(np.array(jla.local_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                                               kernel))),
    }
    for name, ref in refs.items():
        torch.testing.assert_close(got, ref, atol=K2_TOL, rtol=K2_TOL, msg=name)


def test_one_tf32_pass_breaks_k2_tolerance():
    """hi_a hi_b alone keeps about 3 decimal digits: at C=128 the logits and
    the weighted sum miss the fp32 result by far more than 2e-5, so the
    kernels take the three products."""
    rng = np.random.default_rng(128)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 12, 14, 128)).astype(np.float32)) for _ in range(3))
    exact = attention(q.double(), k.double(), v.double(), 9, torch.matmul).float()
    split_err = (attention(q, k, v, 9, split_matmul) - exact).abs().max().item()
    one_err = (attention(q, k, v, 9, tf32_matmul) - exact).abs().max().item()
    with pytest.raises(AssertionError):
        torch.testing.assert_close(attention(q, k, v, 9, tf32_matmul), exact, atol=K2_TOL, rtol=K2_TOL)
    assert one_err > 10 * split_err, (one_err, split_err)

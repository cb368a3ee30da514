"""K2's backward as the port's kernel takes it (``local_attn_bwd``,
``deepinteraction_tpu_torch/csrc/local_attention.cu``), emulated in plain
torch on the CPU, against ``jax.vjp`` of the JAX package's XLA form and the
port's plain backward.

The kernel runs two passes, each product in split TF32 (emulated as in
``tests/test_torch_port_split_tf32.py``):

- pass A, per query p over its k*k taps t (keys p + off_t, a key outside the
  map a zero key whose logit 0 counts in the softmax): S, the softmax, the
  log-sum-exp LSE_p, dP, D_p = sum_t P_t dP_t, dS = P (dP - D) / sqrt(C) and
  dq = sum_t dS_t k_t;
- pass B, per key j over the mirrored band, the queries i = j - off_t: P and
  dS again from S^T = k_j . q_i, LSE_i and D_i, a query outside the map
  taking no part (its LSE is +inf, so P = 0); dv = sum P dO_i and
  dk = sum dS q_i.

Each of dq, dk, dv is held to 1e-4 of its scale, the kernel's tolerance on
the card (``K2_BWD_TOL``), at k in {1, 3, 5, 9}, maps of 1x1, 3x7 (shorter
and narrower than most windows) and 12x17, and C in {3, 16, 20}.
"""

import functools
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from deepinteraction_tpu.ops import local_attention as jla
from deepinteraction_tpu_torch.ops import local_attention as tla

from test_torch_port_split_tf32 import split_matmul

torch.set_num_threads(1)

K2_BWD_TOL = 1e-4  # max|d| / max|ref| for each of dq, dk, dv, as on the card


def windows(x: torch.Tensor, kernel: int, sign: int, fill: float = 0.0) -> torch.Tensor:
    """[B, H, W, ...] -> [B, H, W, k*k, ...]: x[p + sign * off_t] at tap t,
    ``fill`` outside the map."""
    _, h, w = x.shape[:3]
    r = kernel // 2
    xp = F.pad(x.movedim((1, 2), (-2, -1)), (r, r, r, r), value=fill).movedim((-2, -1), (1, 2))
    taps = []
    for dy in range(kernel):
        for dx in range(kernel):
            oy, ox = (dy, dx) if sign > 0 else (2 * r - dy, 2 * r - dx)
            taps.append(xp[:, oy : oy + h, ox : ox + w])
    return torch.stack(taps, 3)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., C] . [..., T, C] -> [..., T] in split TF32."""
    return split_matmul(a[..., None, :], b.transpose(-1, -2))[..., 0, :]


def weigh(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """[..., T] weights of [..., T, C] rows -> [..., C] in split TF32."""
    return split_matmul(p[..., None, :], x)[..., 0, :]


def two_pass_bwd(q, k, v, dout, kernel: int):
    """dq, dk, dv by the kernel's two passes."""
    scale = torch.tensor(1.0 / math.sqrt(q.shape[-1]), dtype=torch.float32)
    # pass A, per query
    kw, vw = windows(k, kernel, +1), windows(v, kernel, +1)
    z = dot(q, kw) * scale
    m = z.amax(-1, keepdim=True)
    e = torch.exp(z - m)
    l = e.sum(-1, keepdim=True)
    p = e * (1.0 / l)
    lse = (m + torch.log(l))[..., 0]
    dp = dot(dout, vw)
    d = (p * dp).sum(-1)
    dq = weigh(p * (dp - d[..., None]) * scale, kw)
    # pass B, per key j: the queries j - off_t, masked outside the map
    qw, gw = windows(q, kernel, -1), windows(dout, kernel, -1)
    lse_w = windows(lse[..., None], kernel, -1, fill=math.inf)[..., 0]
    d_w = windows(d[..., None], kernel, -1)[..., 0]
    pt = torch.exp(dot(k, qw) * scale - lse_w)
    dst = pt * (dot(v, gw) - d_w) * scale
    return dq, weigh(dst, qw), weigh(pt, gw)


@functools.lru_cache(maxsize=None)
def jax_vjp(kernel: int):
    """(q, k, v, dO) -> (dq, dk, dv): ``jax.vjp`` of the XLA form, jitted
    (op by op it takes several times longer on the CPU)."""
    def grads(q, k, v, g):
        return jax.vjp(lambda a, b, x: jla.local_attention(a, b, x, kernel), q, k, v)[1](g)

    return jax.jit(grads)


def _close(got, want, what):
    for name, a, b in zip("qkv", got, want):
        b = torch.from_numpy(np.array(b))
        err = (a - b).abs().max().item()
        scale = b.abs().max().item()
        assert err <= K2_BWD_TOL * scale, f"d{name} vs {what}: {err:.3e} of scale {scale:.3e}"


@pytest.mark.parametrize("c", [3, 16, 20])
@pytest.mark.parametrize("hw", [(1, 1), (3, 7), (12, 17)])
@pytest.mark.parametrize("kernel", [1, 3, 5, 9])
def test_two_pass_backward_vs_jax_vjp_and_plain(kernel, hw, c):
    shape = (2, *hw, c)
    rng = np.random.default_rng(kernel * 1000 + hw[0] * 100 + hw[1] * 10 + c)
    q, k, v, g = (rng.normal(size=shape).astype(np.float32) for _ in range(4))
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    got = two_pass_bwd(tq, tk, tv, tg, kernel)
    _close(got, jax_vjp(kernel)(*(jnp.asarray(a) for a in (q, k, v, g))), "jax.vjp of the XLA local_attention")
    _close(got, tla.local_attention_bwd(tq, tk, tv, tg, kernel), "the plain backward")


def test_mirrored_band_pairs_each_query_and_key_once():
    """Pass B's mirrored windows pair key j with query i exactly where pass A's
    windows pair query i with key j: the pair counts agree pixel for pixel,
    and a query outside the map is never paired."""
    h, w, kernel = 5, 6, 5
    ids = torch.arange(1, h * w + 1, dtype=torch.float32).reshape(1, h, w, 1)
    fwd = windows(ids, kernel, +1)[0, ..., 0]  # key id read by query p at tap t (0: outside)
    back = windows(ids, kernel, -1)[0, ..., 0]  # query id that reads key j at tap t
    pairs_a = {(int(i), int(j)) for i, row in zip(ids.flatten(), fwd.reshape(h * w, -1)) for j in row if j > 0}
    pairs_b = {(int(i), int(j)) for j, row in zip(ids.flatten(), back.reshape(h * w, -1)) for i in row if i > 0}
    assert pairs_a == pairs_b
    assert len(pairs_a) == sum(min(y + 2, h - 1) - max(y - 2, 0) + 1 for y in range(h)) * sum(
        min(x + 2, w - 1) - max(x - 2, 0) + 1 for x in range(w))

"""The port's CUDA kernels (K1 subm_conv_gemm with its backward, d/dfeat
over the inverse table and subm_conv_wgrad; K2 local_attn_fwd and its
backward local_attn_bwd; the bf16 variants subm_conv_gemm_bf16 and
local_attn_fwd_bf16; the auction LAP, auction_lap, exactly) against their
plain PyTorch versions, on the card, alone and inside the tiny slices
(``fusion_base`` and DeepInteraction++; card against CPU with the fp32
kernels, and at the defaults the bf16 variants' launches).

Marked ``gpu``: each test skips where ``torch.cuda.is_available()`` is false
(the decision is taken inside the fixture, never at import). On a machine
with a card and no JAX, run them without the JAX test harness:

    python -m pytest --noconftest -q -m gpu tests/test_torch_port_kernels.py
"""

import numpy as np
import pytest
import torch

from deepinteraction_tpu_torch.configs import tiny_config, tiny_pp_config
from deepinteraction_tpu_torch.levers import EvalLevers
from deepinteraction_tpu_torch.models.detector import DeepInteraction
from deepinteraction_tpu_torch.ops import cuda_lib
from deepinteraction_tpu_torch.ops import local_attention as la
from deepinteraction_tpu_torch.ops import sparse_conv as sc
from deepinteraction_tpu_torch.ops import subm_conv as smc
from deepinteraction_tpu_torch.utils.synthetic import init_weights, make_synthetic_batch, to_torch

pytestmark = pytest.mark.gpu

# K1 keeps fp32 accuracy (split TF32 on the tensor cores, d/dW too): only
# the summation order differs from the plain version, so the max error is
# held to 1e-4 of the output's scale
K1_TOL = 1e-4
# K2 keeps fp32 accuracy throughout (split TF32 products, fp32 softmax)
K2_TOL = 2e-5
# K2's backward keeps fp32 accuracy (split TF32 products, fp32 softmax), but
# it recomputes P in its second pass from each query's log-sum-exp and its
# sums run in another order than autograd's, so each of dq, dk, dv is held to
# 1e-4 of its scale, as K1's
K2_BWD_TOL = 1e-4
# The bf16 variants multiply the same bf16-rounded operands as their plain
# versions but sum in fp32 in the tensor cores' order: where the two sums
# straddle a bf16 rounding boundary, a tap's product (K1) or a probability
# (K2) moves by one bf16 ulp. Held as chip_smoke.py holds them (phase 29):
# at most BF16_TOL of scale, and at most BF16_MOVED of the outputs moved by
# more than 1e-6 of scale (a variant that skipped a rounding moves nearly all)
BF16_TOL = 4e-3
BF16_MOVED = 1e-2
# the fp32 kernels: the settings' other values (levers.py)
FP32 = EvalLevers(sparse_impl="gather", locatt_mxu="f32")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    cuda_lib.fp32_numerics()
    return torch.device("cuda")


def _sparse_case(rng, k, cin, cout, taps, miss=0.7):
    feats = rng.normal(size=(k, cin)).astype(np.float32)
    nbr = rng.integers(0, k, size=(k, taps)).astype(np.int32)
    nbr[rng.uniform(size=nbr.shape) < miss] = k
    w = (rng.normal(size=(taps, cin, cout)) / np.sqrt(taps * cin)).astype(np.float32)
    valid = np.arange(k) < k - k // 10
    nbr[~valid] = k
    return feats, nbr, w, valid


@pytest.mark.parametrize(
    "k,cin,cout,taps",
    [
        (160_000, 5, 16, 27),  # conv_input
        (160_000, 16, 16, 27),  # stage 0
        (90_000, 32, 32, 27),  # stage 1
        (60_000, 64, 64, 27),  # stage 2
        (30_000, 128, 128, 27),  # stage 3
        (30_000, 128, 128, 3),  # conv_out's 3-tap table
        (1_000, 40, 72, 27),  # ragged widths
        (2_999, 72, 40, 27),  # ragged widths, rows not a multiple of any tile
        (1_003, 5, 16, 27),  # Cin=5 padded to the MMA depth, ragged rows
        (4_097, 16, 5, 27),  # Cout=5: conv_input's d/dfeat shape
    ],
)
def test_subm_conv_gemm_matches_plain(cuda, k, cin, cout, taps):
    rng = np.random.default_rng(k + cin + cout + taps)
    args = [torch.from_numpy(a).to(cuda) for a in _sparse_case(rng, k, cin, cout, taps)]
    before = smc.subm_conv_gemm.launches
    out = smc.subm_conv_gemm(*args)
    torch.cuda.synchronize()
    assert smc.subm_conv_gemm.launches == before + 1
    ref = smc.gathered_matmul(*args)
    err = (out - ref).abs().max().item()
    assert err <= K1_TOL * ref.abs().max().item(), err
    assert torch.all(out[~args[3]] == 0)


@pytest.mark.parametrize("table", ["tiles_miss", "taps_miss", "dense"])
@pytest.mark.parametrize("cin,cout", [(16, 16), (128, 128)])
def test_subm_conv_gemm_skips_and_dense(cuda, table, cin, cout):
    """Tables where whole row tiles or whole taps miss (the kernel skips
    them) and a dense table where every tap of every row hits."""
    rng = np.random.default_rng(cin + len(table))
    k, taps = 5_000, 27
    feats, nbr, w, valid = _sparse_case(rng, k, cin, cout, taps, miss=0.0 if table == "dense" else 0.5)
    if table == "tiles_miss":
        nbr[64:1_000] = k  # rows 64..999: whole 64-row tiles miss every tap
        nbr[3_000:3_070] = -1  # negative indices miss too
    elif table == "taps_miss":
        nbr[:, ::2] = k  # every even tap misses everywhere
    else:
        valid[:] = True
    args = [torch.from_numpy(a).to(cuda) for a in (feats, nbr, w, valid)]
    out = smc.subm_conv_gemm(*args)
    ref = smc.gathered_matmul(*args)
    err = (out - ref).abs().max().item()
    assert err <= K1_TOL * ref.abs().max().item(), err
    if table == "tiles_miss":
        assert torch.all(out[64:1_000] == 0)


@pytest.mark.parametrize("kernel", [3, 5, 7, 9])
@pytest.mark.parametrize("c", [40, 64, 128])
def test_local_attn_fwd_ragged_tiles(cuda, kernel, c):
    """H and W not multiples of the 4 x 16 query tile, every window size the
    kernel takes, channel counts that are and are not multiples of its
    16-channel slab."""
    g = torch.Generator(device="cpu").manual_seed(kernel * c)
    q, k, v = (torch.randn((2, 13, 21, c), generator=g).to(cuda) for _ in range(3))
    torch.testing.assert_close(la.local_attn_fwd(q, k, v, kernel), la.local_attention(q, k, v, kernel),
                               atol=K2_TOL, rtol=K2_TOL)


@pytest.mark.parametrize("c", [40, 128])
def test_local_attn_fwd_sharp_softmax(cuda, c):
    """q and k scaled x8: the scaled logits spread over hundreds, so a wrong
    running max overflows exp, and the softmax is sharp. Their entries are
    +-8, so every logit is exact in both versions: with normal entries at
    this gain two fp32 summation orders already differ by more than 2e-5
    (tests/test_torch_port_split_tf32.py). The split of q.k is held by the
    other cases, where one TF32 pass would miss 2e-5."""
    g = torch.Generator(device="cpu").manual_seed(c)
    q, k, v = (torch.randn((1, 37, 45, c), generator=g).to(cuda) for _ in range(3))
    q, k = 8 * torch.sign(q), 8 * torch.sign(k)
    torch.testing.assert_close(la.local_attn_fwd(q, k, v, 9), la.local_attention(q, k, v, 9),
                               atol=K2_TOL, rtol=K2_TOL)


@pytest.mark.parametrize(
    "shape,kernel",
    [
        ((6, 112, 200, 128), 9),  # p2i_local / i_iml image maps
        ((1, 180, 180, 128), 9),  # p_iml BEV map
        ((2, 13, 21, 64), 5),
        ((1, 7, 9, 40), 3),  # channels not a multiple of the 16-wide slab
        ((1, 9, 11, 6), 3),  # channels not a multiple of 4: 4-byte copies
    ],
)
def test_local_attn_fwd_matches_plain(cuda, shape, kernel):
    g = torch.Generator(device="cpu").manual_seed(sum(shape) + kernel)
    q, k, v = (torch.randn(shape, generator=g).to(cuda) for _ in range(3))
    before = la.local_attn_fwd.launches
    out = la.local_attn_fwd(q, k, v, kernel)
    torch.cuda.synchronize()
    assert la.local_attn_fwd.launches == before + 1
    ref = la.local_attention(q, k, v, kernel)
    torch.testing.assert_close(out, ref, atol=K2_TOL, rtol=K2_TOL)


def _bf16_close(out, ref):
    scale = ref.abs().max().item()
    d = (out - ref).abs()
    assert d.max().item() <= BF16_TOL * scale, d.max().item() / scale
    assert (d > 1e-6 * scale).float().mean().item() <= BF16_MOVED


@pytest.mark.parametrize("k,cin,cout", [(160_000, 5, 16), (160_000, 16, 16), (90_000, 32, 32), (60_000, 64, 64),
                                        (30_000, 128, 128), (2_999, 72, 40), (1_003, 5, 16), (4_097, 16, 5)])
def test_subm_conv_gemm_bf16_matches_plain(cuda, k, cin, cout):
    rng = np.random.default_rng(k + cin + cout)
    args = [torch.from_numpy(a).to(cuda) for a in _sparse_case(rng, k, cin, cout, 27)]
    before = smc.subm_conv_gemm_bf16.launches
    out = smc.subm_conv_gemm_bf16(*args)
    torch.cuda.synchronize()
    assert smc.subm_conv_gemm_bf16.launches == before + 1
    _bf16_close(out, smc.gathered_matmul(*args, bf16=True))
    assert torch.all(out[~args[3]] == 0)


@pytest.mark.parametrize("k,cin,cout", [(160_000, 16, 16), (90_000, 32, 32), (60_000, 64, 64), (30_000, 128, 128),
                                        (1_003, 5, 16), (2_999, 72, 40)])
def test_subm_conv_s2d_matches_plain(cuda, k, cin, cout):
    """``per_tap=False`` (DI_SPARSE_IMPL=s2d): bf16 operands, one fp32 sum."""
    rng = np.random.default_rng(k + cin + cout + 1)
    args = [torch.from_numpy(a).to(cuda) for a in _sparse_case(rng, k, cin, cout, 27)]
    out = smc.subm_conv_gemm_bf16(*args, per_tap=False)
    ref = smc.gathered_matmul(*args, bf16=True, per_tap=False)
    assert (out - ref).abs().max().item() <= K1_TOL * ref.abs().max().item()


@pytest.mark.parametrize("overflow", [False, True])
def test_subm_conv_gemm_bf16_gated(cuda, overflow):
    """With the overflow flag both kernels launch and read it: set, the fp32
    kernel computes the conv (its bits) and d/dfeat; clear, the bf16 one.
    ``taken`` counts which ran, on the card."""
    rng = np.random.default_rng(7)
    feats, nbr, w, valid = (torch.from_numpy(a).to(cuda) for a in _sparse_case(rng, 20_000, 32, 32, 27))
    ovf = torch.tensor(overflow, device=cuda)
    inv = sc.inverse_table(nbr, feats.shape[0])
    smc.taken(cuda).zero_()
    before = smc.subm_conv_gemm.launches, smc.subm_conv_gemm_bf16.launches, smc.subm_conv_dgrad.launches
    f = feats.clone().requires_grad_(True)
    out = smc.subm_conv_gemm_bf16(f, nbr, w, valid, inv, ovf=ovf)
    out.sum().backward()
    torch.cuda.synchronize()
    after = smc.subm_conv_gemm.launches, smc.subm_conv_gemm_bf16.launches, smc.subm_conv_dgrad.launches
    assert [a - b for a, b in zip(after, before)] == [1, 2, 1]
    assert smc.taken(cuda).tolist() == ([2, 0] if overflow else [0, 2])
    want = smc.subm_conv_gemm(feats, nbr, w, valid) if overflow else smc.subm_conv_gemm_bf16(feats, nbr, w, valid)
    assert torch.equal(out.detach(), want)


def test_subm_conv_gemm_bf16_backward_route(cuda):
    """With gradients on, d/dfeat is the bf16 variant over the inverse table
    with W^T (one more bf16 launch) and d/dW the fp32 kernel on the features
    rounded to bf16."""
    rng = np.random.default_rng(4)
    feats, nbr, w, valid = (torch.from_numpy(a).to(cuda) for a in _sparse_case(rng, 5_000, 32, 64, 27))
    inv = sc.inverse_table(nbr, feats.shape[0])
    dy = torch.where(valid[:, None], torch.randn(5_000, 64, device=cuda), 0.0)
    f, ww = feats.clone().requires_grad_(True), w.clone().requires_grad_(True)
    before = smc.subm_conv_gemm_bf16.launches
    (smc.subm_conv_gemm_bf16(f, nbr, ww, valid, inv) * dy).sum().backward()
    assert smc.subm_conv_gemm_bf16.launches == before + 2
    every = torch.ones(5_000, dtype=torch.bool, device=cuda)
    _bf16_close(f.grad, smc.gathered_matmul(dy, inv, w.transpose(1, 2), every, bf16=True))
    ref = smc.gathered_wgrad(smc.round_bf16(feats), nbr, dy)
    assert (ww.grad - ref).abs().max().item() <= K1_TOL * ref.abs().max().item()


# the last seven straddle the bf16 kernel's 8 x 16 query tiles in H and W
# (one tile, one past, one short) and its 32-channel stages (C = 8, 40)
@pytest.mark.parametrize("shape,kernel", [((6, 112, 200, 128), 9), ((1, 180, 180, 128), 9), ((2, 13, 21, 64), 5),
                                          ((1, 3, 14, 128), 9), ((1, 7, 9, 40), 3), ((1, 9, 11, 6), 3),
                                          ((1, 8, 16, 40), 9), ((1, 17, 33, 8), 9), ((2, 9, 31, 40), 7),
                                          ((1, 15, 17, 8), 5), ((3, 23, 47, 40), 3), ((1, 16, 32, 8), 1),
                                          ((1, 25, 15, 40), 9)])
def test_local_attn_fwd_bf16_matches_plain(cuda, shape, kernel):
    g = torch.Generator(device="cpu").manual_seed(sum(shape) + kernel)
    q, k, v = (torch.randn(shape, generator=g).to(cuda) for _ in range(3))
    before = la.local_attn_fwd_bf16.launches
    out = la.local_attn_fwd_bf16(q, k, v, kernel)
    torch.cuda.synchronize()
    assert la.local_attn_fwd_bf16.launches == before + 1
    _bf16_close(out, la.local_attention(q, k, v, kernel, bf16=True))


@pytest.mark.parametrize("c", [40, 128])
def test_local_attn_fwd_bf16_sharp_softmax(cuda, c):
    """q and k +-8, as in ``test_local_attn_fwd_sharp_softmax`` (exact in
    bf16): the softmax is sharp, so probabilities fall below e^-60, into
    fp32's denormals and to 0, where the bf16 kernel divides by the IEEE
    division's full path."""
    g = torch.Generator(device="cpu").manual_seed(c)
    q, k, v = (torch.randn((1, 37, 45, c), generator=g).to(cuda) for _ in range(3))
    q, k = 8 * torch.sign(q), 8 * torch.sign(k)
    _bf16_close(la.local_attn_fwd_bf16(q, k, v, 9), la.local_attention(q, k, v, 9, bf16=True))


def test_local_attn_fwd_bf16_unaligned(cuda):
    """Contiguous maps whose storage starts 4 bytes past a 16-byte boundary,
    at C = 128: the kernel's 4-byte loads (VEC = 1) at a channel count that
    otherwise takes its 16-byte ones."""
    shape = (1, 19, 35, 128)
    n = shape[0] * shape[1] * shape[2] * shape[3]
    g = torch.Generator(device="cpu").manual_seed(7)
    q, k, v = (torch.empty(n + 1, device=cuda)[1:].view(shape).copy_(torch.randn(shape, generator=g))
               for _ in range(3))
    assert all(t.is_contiguous() and t.data_ptr() % 16 == 4 for t in (q, k, v))
    before = la.local_attn_fwd_bf16.launches
    out = la.local_attn_fwd_bf16(q, k, v, 9)
    torch.cuda.synchronize()
    assert la.local_attn_fwd_bf16.launches == before + 1
    _bf16_close(out, la.local_attention(q, k, v, 9, bf16=True))


def test_wrappers_reject_bad_inputs(cuda):
    f = torch.zeros(4, 8, device=cuda)
    nbr = torch.zeros(4, 27, dtype=torch.int64, device=cuda)
    w = torch.zeros(27, 8, 8, device=cuda)
    valid = torch.ones(4, dtype=torch.bool, device=cuda)
    with pytest.raises(TypeError):
        smc.subm_conv_gemm(f, nbr, w, valid)
    with pytest.raises(RuntimeError):
        smc.subm_conv_gemm(f, nbr.int(), w.cpu(), valid)
    q = torch.zeros(1, 4, 4, 8, device=cuda)
    with pytest.raises(ValueError):
        la.local_attn_fwd(q, q, q, 4)
    with pytest.raises(ValueError):
        la.local_attn_fwd(q, q, q, la.MAX_KERNEL + 2)
    with pytest.raises(ValueError):
        la.local_attn_bwd(q, q, q, q[:, :3], 3)
    with pytest.raises(RuntimeError):
        la.local_attn_bwd(q, q, q, q.cpu(), 3)


@pytest.mark.parametrize(
    "shape,kernel",
    [
        ((12, 112, 200, 128), 9),  # p2i_local / i_iml image maps of a B=2 train step
        ((2, 180, 180, 128), 9),  # p_iml BEV maps
        ((2, 13, 21, 128), 1),
        ((2, 13, 21, 64), 3),
        ((1, 17, 30, 40), 5),  # channels not a multiple of 128
        ((1, 9, 11, 6), 3),  # channels not a multiple of 4: 4-byte loads
        ((1, 3, 40, 32), 9),  # a map shorter than the window
        ((2, 30, 4, 32), 9),  # a map narrower than the window
        ((1, 2, 2, 16), 5),
    ],
)
def test_local_attn_bwd_matches_plain(cuda, shape, kernel):
    """dq, dk, dv of the kernel against autograd of the plain version, and
    through ``local_attn_fwd``'s autograd (one backward launch)."""
    g = torch.Generator(device="cpu").manual_seed(sum(shape) * kernel)
    q, k, v, dout = (torch.randn(shape, generator=g).to(cuda) for _ in range(4))
    want = la.local_attention_bwd(q, k, v, dout, kernel)
    qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = la.local_attn_bwd.launches
    la.local_attn_fwd(*qkv, kernel).backward(dout)
    got = la.local_attn_bwd(q, k, v, dout, kernel)
    torch.cuda.synchronize()
    assert la.local_attn_bwd.launches == before + 2
    for name, a, through_fwd, ref in zip("qkv", got, qkv, want):
        scale = ref.abs().max().item()
        assert torch.equal(a, through_fwd.grad), name
        err = (a - ref).abs().max().item()
        assert err <= K2_BWD_TOL * scale, f"d{name}: {err:.3e} of scale {scale:.3e}"


def _bwd_close(got, want):
    for name, a, ref in zip("qkv", got, want):
        scale = ref.abs().max().item()
        err = (a - ref).abs().max().item()
        assert err <= K2_BWD_TOL * scale, f"d{name}: {err:.3e} of scale {scale:.3e}"


@pytest.mark.parametrize("c", [40, 128])
def test_local_attn_bwd_sharp_softmax(cuda, c):
    """q and k +-8, as in ``test_local_attn_fwd_sharp_softmax``: the scaled
    logits spread over hundreds (x30 and more against normal inputs), P is
    nearly one-hot and every logit is exact in both versions, so the
    log-sum-exp that pass B recomputes P from is tested where it is largest."""
    g = torch.Generator(device="cpu").manual_seed(c)
    q, k, v, dout = (torch.randn((1, 37, 45, c), generator=g).to(cuda) for _ in range(4))
    q, k = 8 * torch.sign(q), 8 * torch.sign(k)
    _bwd_close(la.local_attn_bwd(q, k, v, dout, 9), la.local_attention_bwd(q, k, v, dout, 9))


@pytest.mark.parametrize("shape,kernel", [((2, 180, 180, 128), 9), ((1, 13, 21, 6), 5)])
def test_local_attn_bwd_deterministic(cuda, shape, kernel):
    """No atomics: two calls on the same inputs give the same bits."""
    g = torch.Generator(device="cpu").manual_seed(sum(shape))
    q, k, v, dout = (torch.randn(shape, generator=g).to(cuda) for _ in range(4))
    first = la.local_attn_bwd(q, k, v, dout, kernel)
    second = la.local_attn_bwd(q, k, v, dout, kernel)
    for name, a, b in zip("qkv", first, second):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("kernel", [1, 3, 5, 7, 9])
@pytest.mark.parametrize("hw", [(5, 17), (13, 33), (4, 16), (1, 31)])
def test_local_attn_bwd_ragged_tiles(cuda, kernel, hw):
    """H and W not multiples of the 4 x 16 tile (and one that is), every
    window size: the edge tiles of both passes, and queries and keys outside
    the map in the halo."""
    g = torch.Generator(device="cpu").manual_seed(kernel * 100 + hw[0] * hw[1])
    q, k, v, dout = (torch.randn((2, *hw, 48), generator=g).to(cuda) for _ in range(4))
    _bwd_close(la.local_attn_bwd(q, k, v, dout, kernel), la.local_attention_bwd(q, k, v, dout, kernel))


def test_backward_not_ported(cuda):
    """K1's backward needs the inverse table (K2's backward is ported:
    ``test_local_attn_bwd_matches_plain``)."""
    f = torch.randn(4, 8, device=cuda, requires_grad=True)
    nbr = torch.full((4, 27), 4, dtype=torch.int32, device=cuda)
    w = torch.randn(27, 8, 8, device=cuda)
    with pytest.raises(ValueError, match="inverse table"):
        smc.subm_conv_gemm(f, nbr, w, torch.ones(4, dtype=torch.bool, device=cuda))


def _sites(k, grid, dev, seed):
    """K random active sites in ``grid`` (z, y, x), sorted by linear id."""
    g = torch.Generator().manual_seed(seed)
    ids = torch.randperm(grid[0] * grid[1] * grid[2], generator=g)[:k].sort().values
    coords = torch.stack([ids // (grid[1] * grid[2]), (ids // grid[2]) % grid[1], ids % grid[2]], 1)
    return coords.int().to(dev), torch.ones(k, dtype=torch.bool, device=dev)


@pytest.mark.parametrize(
    "k,cin,cout,table",
    [
        (120_000, 5, 16, "subm"),  # conv_input: d/dW only
        (120_000, 16, 16, "subm"),  # stage 0
        (120_000, 16, 32, "down"),  # down0
        (90_000, 32, 32, "subm"),
        (90_000, 32, 64, "down"),
        (60_000, 64, 64, "subm"),
        (60_000, 64, 128, "down"),
        (30_000, 128, 128, "subm"),  # stage 3
        (30_000, 128, 128, "conv_out"),  # 3 taps
        (7_001, 32, 64, "down"),  # ragged rows through a strided inverse table
    ],
)
def test_subm_conv_backward_matches_plain(cuda, k, cin, cout, table):
    """dfeat (K1 over the inverse table) and dW (subm_conv_wgrad) against
    autograd of the plain version, on tables made like the encoder's, at a
    density of about 8 hits per row."""
    shape = (41, 100, 100)
    coords, valid = _sites(k, shape, cuda, seed=k + cin + cout)
    st = sc.SparseTensor(None, coords, valid, shape)
    if table == "subm":
        nbr, valid_out = sc.subm_neighbor_table(st), valid
        inv = sc.mirror_table(nbr)
    else:
        kernel, stride, pad = ((3, 1, 1), (2, 1, 1), (0, 0, 0)) if table == "conv_out" else ((3, 3, 3), (2, 2, 2), (1, 1, 1))
        oc, valid_out, _ = sc.downsample_sites(coords, valid, shape, kernel, stride, pad, k)
        nbr = sc.strided_neighbor_table(st, oc, valid_out, kernel, stride, pad)
        inv = sc.inverse_table(nbr, k)
    g = torch.Generator().manual_seed(cin * cout)
    f0 = torch.randn(k, cin, generator=g).to(cuda)
    w0 = (torch.randn(nbr.shape[1], cin, cout, generator=g) / (nbr.shape[1] * cin) ** 0.5).to(cuda)
    r = torch.randn(nbr.shape[0], cout, generator=g).to(cuda)
    want_dfeat = cin != 5
    grads = []
    for kernel in (True, False):
        f = f0.clone().requires_grad_(want_dfeat)
        w = w0.clone().requires_grad_(True)
        before = (smc.subm_conv_dgrad.launches, smc.subm_conv_wgrad.launches)
        out = smc.subm_conv_gemm(f, nbr, w, valid_out, inv) if kernel else smc.gathered_matmul(f, nbr, w, valid_out)
        (out * r).sum().backward()
        torch.cuda.synchronize()
        if kernel:
            assert smc.subm_conv_dgrad.launches - before[0] == int(want_dfeat)
            assert smc.subm_conv_wgrad.launches - before[1] == 1
        grads.append((f.grad, w.grad))
    for got, ref in zip(*grads):
        if ref is None:
            assert got is None
            continue
        err = (got - ref).abs().max().item()
        assert err <= K1_TOL * ref.abs().max().item(), err


def _wgrad_close(feats, nbr, dy):
    got = smc.subm_conv_wgrad(feats, nbr, dy)
    ref = smc.gathered_wgrad(feats, nbr, dy)
    err = (got - ref).abs().max().item()
    assert err <= K1_TOL * ref.abs().max().item(), err
    return got


@pytest.mark.parametrize("ko", [1, 63, 1_025])
@pytest.mark.parametrize("cin,cout", [(5, 40), (5, 72), (72, 40), (72, 72), (16, 16), (32, 32)])
def test_subm_conv_wgrad_tiles(cuda, ko, cin, cout):
    """d/dW through each output tile (16, 32, 64 and 128 wide), channel
    counts that are not multiples of 4 or of the tile, and row counts below,
    at and past a 32-row tile and a 1024-row chunk."""
    rng = np.random.default_rng(ko * cin + cout)
    k = max(ko, 40)
    feats = rng.normal(size=(k, cin)).astype(np.float32)
    nbr = rng.integers(0, k, size=(ko, 27)).astype(np.int32)
    nbr[rng.uniform(size=nbr.shape) < 0.6] = k
    dy = rng.normal(size=(ko, cout)).astype(np.float32)
    f, n, g = (torch.from_numpy(a).to(cuda) for a in (feats, nbr, dy))
    before = smc.subm_conv_wgrad.launches
    _wgrad_close(f, n, g)
    assert smc.subm_conv_wgrad.launches == before + 1


@pytest.mark.parametrize("cin,cout", [(16, 16), (64, 64), (128, 128)])
def test_subm_conv_wgrad_tiles_miss(cuda, cin, cout):
    """Whole 32-row tiles that miss every tap (the kernel skips them), a tap
    that misses everywhere (its dW is exactly 0) and negative indices."""
    rng = np.random.default_rng(cin)
    k = 5_000
    feats, nbr, _, _ = _sparse_case(rng, k, cin, cout, 27, miss=0.5)
    nbr[64:1_000] = k
    nbr[3_000:3_070] = -1
    nbr[:, 7] = k
    dy = rng.normal(size=(k, cout)).astype(np.float32)
    got = _wgrad_close(*(torch.from_numpy(a).to(cuda) for a in (feats, nbr, dy)))
    assert torch.all(got[7] == 0)


def test_subm_conv_wgrad_no_rows(cuda):
    """An empty table gives dW = 0."""
    f = torch.randn(10, 16, device=cuda)
    got = smc.subm_conv_wgrad(f, torch.zeros(0, 27, dtype=torch.int32, device=cuda), torch.zeros(0, 32, device=cuda))
    assert got.shape == (27, 16, 32) and torch.all(got == 0)


def test_subm_conv_wgrad_deterministic(cuda):
    """No atomics: two calls at a stage-3 table (30 000 sites, 128 -> 128)
    give the same bits."""
    coords, valid = _sites(30_000, (41, 100, 100), cuda, seed=3)
    nbr = sc.subm_neighbor_table(sc.SparseTensor(None, coords, valid, (41, 100, 100)))
    g = torch.Generator().manual_seed(3)
    f = torch.randn(30_000, 128, generator=g).to(cuda)
    dy = torch.randn(30_000, 128, generator=g).to(cuda)
    first = _wgrad_close(f, nbr, dy)
    assert torch.equal(first, smc.subm_conv_wgrad(f, nbr, dy))


def test_tiny_slice_on_card_matches_cpu_path(cuda):
    """The tiny_config slice through the kernels equals the CPU path (which
    tests/test_torch_port_model.py holds to JAX) at the golden tolerance."""
    cfg = tiny_config()
    model = DeepInteraction(cfg.model, cfg.data.padded_img_shape, cfg.test_num_proposals, levers=FP32).eval()
    init_weights(model, seed=7)
    np_batch = make_synthetic_batch(cfg, b=1, seed=7)
    ref = model(to_torch(np_batch, "cpu"))
    k1, k2 = smc.subm_conv_gemm.launches, la.local_attn_fwd.launches
    got = model.to(cuda)(to_torch(np_batch, cuda))
    assert smc.subm_conv_gemm.launches - k1 == 21
    assert la.local_attn_fwd.launches - k2 == 3 * cfg.model.imgpts_neck.num_layers
    for key, want in ref.items():
        if key in ("query_labels", "on_image_masks"):
            assert torch.equal(got[key].cpu(), want), key
        else:
            torch.testing.assert_close(got[key].cpu(), want, rtol=2e-3, atol=5e-4, msg=key)


def test_tiny_pp_on_card_matches_cpu_path(cuda):
    """The tiny_pp_config (DeepInteraction++) forward on the card, through
    K1 and no K2, equals the CPU path (which tests/test_torch_port_pp.py
    holds to JAX) at the golden tolerance."""
    cfg = tiny_pp_config()
    model = DeepInteraction(cfg.model, cfg.data.padded_img_shape, cfg.test_num_proposals, levers=FP32).eval()
    init_weights(model, seed=7)
    np_batch = make_synthetic_batch(cfg, b=1, seed=7)
    ref = model(to_torch(np_batch, "cpu"))
    k1, k2 = smc.subm_conv_gemm.launches, la.local_attn_fwd.launches
    got = model.to(cuda)(to_torch(np_batch, cuda))
    assert smc.subm_conv_gemm.launches - k1 == 21
    assert la.local_attn_fwd.launches == k2
    for key, want in ref.items():
        if key in ("query_labels", "on_image_masks"):
            assert torch.equal(got[key].cpu(), want), key
        else:
            torch.testing.assert_close(got[key].cpu(), want, rtol=2e-3, atol=5e-4, msg=key)


def test_tiny_slice_at_the_defaults_runs_the_bf16_variants(cuda):
    """With the JAX package's defaults (no DI_* variable), eval on the card
    runs K1's bf16 variant for the 17 submanifold convs (the 4 strided ones
    stay fp32; beside each of the 17 the fp32 kernel launches gated by the
    banded plan's overflow flag, which the tiny frame's plans leave clear)
    and K2's for every local attention; on the CPU, fp32."""
    cfg = tiny_config()
    model = DeepInteraction(cfg.model, cfg.data.padded_img_shape, cfg.test_num_proposals,
                            levers=EvalLevers()).eval()
    init_weights(model, seed=7)
    batch = to_torch(make_synthetic_batch(cfg, b=1, seed=7), cuda)
    counters = (smc.subm_conv_gemm, smc.subm_conv_gemm_bf16, la.local_attn_fwd, la.local_attn_fwd_bf16)
    before = [c.launches for c in counters]
    smc.taken(cuda).zero_()
    preds = model.to(cuda)(batch)
    torch.cuda.synchronize()
    k2 = 3 * cfg.model.imgpts_neck.num_layers
    assert [c.launches - b for c, b in zip(counters, before)] == [4 + 17, 17, 0, k2]
    assert smc.taken(cuda).tolist() == [0, 17]
    assert all(torch.isfinite(v.float()).all() for v in preds.values())


# the card's decode (nvJPEG's YCbCr planes, libjpeg's upsampling and colour
# conversion) against libjpeg on the committed fixtures: chip_smoke.py phase
# 18's bounds (measured on an H100: max abs 2-3 levels, mean abs 0.026-0.033,
# the two IDCTs' rounding; the flat-block fixture exactly)
JPEG_BOUNDS = {"jpeg_96x64": (4, 0.1), "jpeg_97x65": (4, 0.1), "jpeg_97x65_444": (4, 0.1),
               "jpeg_flat_97x65": (0, 0.0)}


def test_nvjpeg_decode_matches_libjpeg(cuda):
    import os

    from deepinteraction_tpu_torch.ops import jpeg

    fixtures = os.path.join(os.path.dirname(jpeg.__file__), "..", "fixtures")
    want = np.load(os.path.join(fixtures, "jpeg_pixels.npz"))
    names = sorted(JPEG_BOUNDS)
    got = jpeg.decode([np.fromfile(os.path.join(fixtures, n + ".jpg"), np.uint8) for n in names], cuda)
    for n, g in zip(names, got):
        assert g.device.type == "cuda" and g.dtype == torch.uint8
        d = (g.cpu().int() - torch.from_numpy(want[n]).int()).abs()
        max_abs, mean_abs = JPEG_BOUNDS[n]
        assert d.max().item() <= max_abs and d.float().mean().item() <= mean_abs, n
    # one encode and decode on the card (the synthetic writer's path)
    back = jpeg.decode([jpeg.encode(got[1].contiguous(), quality=95)], cuda)[0]
    mse = (back.float() - got[1].float()).pow(2).mean().item()
    assert 10 * np.log10(255.0**2 / mse) > 35


def test_image_stage_and_nms_on_card_match_cpu(cuda):
    """The image stage (resize, flip, normalise, pad) and both NMS kinds
    give the CPU path's results on the same inputs."""
    from deepinteraction_tpu_torch.configs import fusion_base_config
    from deepinteraction_tpu_torch.ops.nms import nms_keep
    from deepinteraction_tpu_torch.ops.images import prepare_images

    rng = np.random.default_rng(0)
    pixels = [torch.from_numpy(rng.integers(0, 256, (900, 1600, 3), dtype=np.uint8)) for _ in range(3)]
    flips = [False, True, False]
    d = fusion_base_config().data
    card = prepare_images([p.to(cuda) for p in pixels], flips, d)
    torch.testing.assert_close(card.cpu(), prepare_images(pixels, flips, d), rtol=0, atol=1e-5)

    b, n = 2, 400
    boxes = torch.from_numpy(np.concatenate([
        rng.integers(0, 20, (b, n, 2)) * 0.3, rng.uniform(-1, 1, (b, n, 1)), rng.uniform(0.3, 2.5, (b, n, 3)),
        rng.uniform(-3, 3, (b, n, 1)), rng.normal(size=(b, n, 2))], -1).astype(np.float32))
    scores = torch.from_numpy(rng.uniform(size=(b, n)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(6, 10, (b, n)).astype(np.int32))
    valid = torch.from_numpy(rng.uniform(size=(b, n)) > 0.1)
    for kind in ("circle", "rotate"):
        want = nms_keep(boxes, scores, labels, valid, kind, 1000)
        got = nms_keep(boxes.to(cuda), scores.to(cuda), labels.to(cuda), valid.to(cuda), kind, 1000)
        assert torch.equal(got.cpu(), want), kind
        assert want.sum() < valid.sum()


AUCTION_CASES = {  # name: (cost [n, P, G], num_gt [n], eps phases)
    "model_scale": lambda r: (r.uniform(0, 10, (1, 200, 200)), [30], (1e-3,)),
    "train_step_shape": lambda r: (r.uniform(0, 3, (8, 200, 200)), [17, 17, 17, 17, 44, 44, 44, 44], (1e-3,)),
    "ragged": lambda r: (r.uniform(0, 5, (3, 37, 20)), [20, 11, 0], (1e-3,)),
    "integer_ties": lambda r: (r.integers(0, 4, (2, 100, 60)), [60, 33], (1e-3,)),
    "constant": lambda r: (np.full((1, 50, 20), 2.5), [20], (1e-3,)),
    "one_row": lambda r: (np.array([[[3.0]]]), [1], (1e-3,)),
    "two_phases": lambda r: (r.uniform(0, 10, (2, 30, 30)), [25, 30], (1e-2, 1e-3)),
    # too large to stage in shared memory: the benefits are read from L2
    "l2_branch": lambda r: (r.uniform(0, 5, (2, 1024, 600)), [600, 150], (1e-3,)),
    # from 199 dummy columns to none: the one shared dummy scan and its churn
    "dummy_churn": lambda r: (r.uniform(0, 3, (4, 200, 200)), [1, 5, 100, 200], (1e-3,)),
}


@pytest.mark.parametrize("case", list(AUCTION_CASES))
def test_auction_lap_equals_plain(cuda, case):
    """The auction kernel computes the plain version's float32 operations in
    its order with no contracted adds: assignments and rounds exactly
    equal, and two calls give the same bits."""
    from deepinteraction_tpu_torch.ops import hungarian

    cost, num_gt, phases = AUCTION_CASES[case](np.random.default_rng(len(case)))
    cost = torch.from_numpy(np.asarray(cost, np.float32)).to(cuda)
    num_gt = torch.tensor(num_gt, dtype=torch.int32, device=cuda)
    want, want_rounds = hungarian.auction_assign_plain(cost, num_gt, phases, with_rounds=True)
    before = hungarian.auction_lap.launches
    got, rounds = hungarian.auction_lap(cost, num_gt, phases)
    again, _ = hungarian.auction_lap(cost, num_gt, phases)
    torch.cuda.synchronize()
    assert hungarian.auction_lap.launches == before + 2
    assert torch.equal(got, want) and torch.equal(rounds, want_rounds) and torch.equal(again, got)
    assert torch.equal(hungarian.auction_assign(cost, num_gt, phases), got)
    for a, ng in zip(got.cpu(), num_gt.tolist()):
        assert sorted(a[a >= 0].tolist()) == list(range(ng))


def test_auction_lap_branches(cuda):
    """The main path's [200, 200] problems stage their benefits in shared
    memory; ``l2_branch``'s [1024, 600] ones do not fit and read L2."""
    lib = cuda_lib.library()
    assert lib.di_auction_lap_staged(200, 200) == 1
    assert lib.di_auction_lap_staged(1024, 600) == 0


def test_auction_lap_refuses_more_columns_than_rows(cuda):
    from deepinteraction_tpu_torch.ops import hungarian

    with pytest.raises(ValueError, match="G=6 > P=5"):
        hungarian.auction_lap(torch.ones(2, 5, 6, device=cuda), torch.tensor([3, 3], dtype=torch.int32, device=cuda))

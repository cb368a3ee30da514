"""The port's CUDA kernels (K1 subm_conv_gemm, K2 local_attn_fwd) against
their plain PyTorch versions, on the card, alone and inside the tiny slice.

Marked ``gpu``: each test skips where ``torch.cuda.is_available()`` is false
(the decision is taken inside the fixture, never at import). On a machine
with a card and no JAX, run them without the JAX test harness:

    python -m pytest --noconftest -q -m gpu tests/test_torch_port_kernels.py
"""

import numpy as np
import pytest
import torch

from deepinteraction_tpu.configs import tiny_config
from deepinteraction_tpu_torch.models.detector import DeepInteraction
from deepinteraction_tpu_torch.ops import local_attention as la
from deepinteraction_tpu_torch.ops import subm_conv as smc
from deepinteraction_tpu_torch.utils.synthetic import init_weights, make_synthetic_batch, to_torch

pytestmark = pytest.mark.gpu

# K1 multiplies in fp32: only the summation order differs from the plain
# version, so the max error is held to 1e-4 of the output's scale
K1_TOL = 1e-4
# K2 computes in fp32 throughout
K2_TOL = 2e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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


@pytest.mark.parametrize(
    "shape,kernel",
    [
        ((6, 112, 200, 128), 9),  # p2i_local / i_iml image maps
        ((1, 180, 180, 128), 9),  # p_iml BEV map
        ((2, 13, 21, 64), 5),
        ((1, 7, 9, 40), 3),  # channels not a multiple of the 32-wide slab
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


def test_backward_not_ported(cuda):
    q = torch.randn(1, 4, 4, 32, device=cuda, requires_grad=True)
    out = la.local_attn_fwd(q, q.detach(), q.detach(), 3)
    with pytest.raises(NotImplementedError):
        out.sum().backward()
    f = torch.randn(4, 8, device=cuda, requires_grad=True)
    nbr = torch.full((4, 27), 4, dtype=torch.int32, device=cuda)
    w = torch.randn(27, 8, 8, device=cuda)
    out = smc.subm_conv_gemm(f, nbr, w, torch.ones(4, dtype=torch.bool, device=cuda))
    with pytest.raises(NotImplementedError):
        out.sum().backward()


def test_tiny_slice_on_card_matches_cpu_path(cuda):
    """The tiny_config slice through the kernels equals the CPU path (which
    tests/test_torch_port_model.py holds to JAX) at the golden tolerance."""
    cfg = tiny_config()
    model = DeepInteraction(cfg.model, cfg.data.padded_img_shape, cfg.test_num_proposals).eval()
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

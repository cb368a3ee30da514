"""The JAX banded plan's overflow fallback and ``DI_SPARSE_IMPL=s2d``'s
numerics in the port, against the JAX package on the CPU, on inputs made
from numpy seeds.

- ``ops/sparse_conv.py::banded_overflow`` equals ``make_banded_plan(...).ovf``
  exactly, over seeds, windows of 8, 64 and 512 rows, tiles of 64 and 128
  and several active-set sizes, and on one frame of the JAX writer's
  realistic LiDAR cloud at ``fusion_base``'s stage-0 grid, where it is set.
- One conv with an overflowing plan (``subm_conv_gemm_bf16(..., ovf=)``)
  against ``banded_subm_conv`` in interpret mode, its output and
  ``jax.grad`` (d/dfeat fp32 over the inverse table, d/dW on the features
  rounded to bf16) within 1e-4 of scale; the flag also counted in
  ``subm_conv.taken``.
- The tiny sparse encoder with ``DI_BANDED_W=8,512`` (stage 0's plan
  overflows, the others do not) against the Flax encoder on its banded path
  (JAX's ``_BANDED_WS`` patched to the same windows), within ENCODER_TOL of
  scale; the same port with the flag ignored misses it.
- ``s2d``: one conv's bf16 plain version against JAX's ``subm_conv_s2d``
  (1e-6 of scale), and the tiny encoder (eval and train-mode forward)
  against ``SparseEncoder(impl="s2d")`` within ENCODER_TOL (eval) and
  S2D_TRAIN_TOL (train, whose batch statistics amplify one-ulp bf16 moves;
  see there). JAX's s2d has no gradient at this JAX version (``jax.grad``
  through its mixed-precision ``conv_general_dilated`` raises TypeError), so
  the port's s2d backward (the same conv over the inverse table for
  d/dfeat, d/dW on bf16 features) is held to ``jax.vjp`` of the gather on
  bf16-rounded operands, 1e-5 of scale.
- ``EvalLevers.k1_numerics``: ``s2d`` on every device, in train too.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepinteraction_tpu.models.sparse_encoder as jse
from deepinteraction_tpu.configs import tiny_config as jtiny
from deepinteraction_tpu.ops import sparse_conv as jsc
from deepinteraction_tpu.ops import sparse_conv_banded as scb
from deepinteraction_tpu.utils import synthetic_nuscenes as jsn
from deepinteraction_tpu_torch.configs import fusion_base_config, tiny_config
from deepinteraction_tpu_torch.convert import load_flax
from deepinteraction_tpu_torch.levers import EvalLevers
from deepinteraction_tpu_torch.models.sparse_encoder import SparseEncoder
from deepinteraction_tpu_torch.ops import sparse_conv as tsc
from deepinteraction_tpu_torch.ops import subm_conv as tsm
from deepinteraction_tpu_torch.ops.voxelize import voxelize_batched

from test_torch_port_bf16_kernels import ENCODER_TOL, K1_TOL, SHAPE, _rms, _sparse, _t, _voxels

torch.set_num_threads(1)

S2D_CONV_TOL = 1e-6  # of scale: the same exact products, summed in another order
S2D_GRAD_TOL = 1e-5  # of scale
# The tiny encoder's train-mode forward under s2d: each conv rounds its
# input to bf16, so an fp32 sum that the two sides take in different orders
# and that straddles a rounding boundary moves an activation by one bf16 ulp,
# and the BatchNorms' batch statistics then divide by small channel spreads:
# 5.4e-3 of scale at these inputs (rms 3.1e-4; the fp32 port 1.5e-2, rms
# 7.8e-4), against 8.6e-4 in eval, where the running statistics are 0 and 1
S2D_TRAIN_TOL = 1e-2


def _sites(seed, n_active, capacity, shape=SHAPE):
    rng = np.random.default_rng(seed)
    ids = np.sort(rng.permutation(np.prod(shape))[:n_active])
    coords = np.stack([ids // (shape[1] * shape[2]), (ids // shape[2]) % shape[1], ids % shape[2]], 1)
    coords = np.concatenate([coords, np.zeros((capacity - n_active, 3))]).astype(np.int32)
    return coords, np.arange(capacity) < n_active


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("w", [8, 64, 512])
def test_overflow_flag_equals_jax(seed, w):
    """The flag, exactly, at tiles of 128 and 64 rows, on sparse and dense
    active sets (and a full capacity), with the port's own table, which
    equals JAX's (its miss value K included)."""
    for n_active, capacity in ((500, 640), (3_000, 3_100), (300, 300), (10_000, 10_368)):
        coords, valid = _sites(seed, n_active, capacity)
        st = jsc.SparseTensor(jnp.zeros((capacity, 1)), jnp.asarray(coords), jnp.asarray(valid), SHAPE)
        want_nbr = np.asarray(jsc.subm_neighbor_table(st))
        nbr = tsc.subm_neighbor_table(tsc.SparseTensor(None, _t(coords), _t(valid), SHAPE))
        assert np.array_equal(nbr.numpy(), want_nbr)
        for t in (128, 64):
            want = bool(scb.make_banded_plan(jnp.asarray(want_nbr), jnp.asarray(valid), T=t, W=w).ovf)
            got = tsc.banded_overflow(nbr, _t(valid), t, w)
            assert got.dtype == torch.bool and got.shape == () and bool(got) == want, (n_active, t, w)


def test_overflow_flag_on_a_realistic_frame():
    """One frame of the JAX writer's realistic cloud (9 spins of 32 beams,
    40 boxes, 2 walls) voxelized at ``fusion_base``'s size: the stage-0
    plan at the JAX defaults (T 128, W 512) overflows, in both packages."""
    rng = np.random.default_rng(0)
    walls = [{"base": [20.0, 5.0, 0.0], "along": [10.0, 3.0, 0.0], "height": 5.0},
             {"base": [-30.0, -10.0, 0.0], "along": [0.0, 15.0, 0.0], "height": 6.0}]
    objs = []
    for _ in range(40):
        _, dims, _, _ = jsn._REAL_CLASSES[rng.integers(len(jsn._REAL_CLASSES))]
        r, th = rng.uniform(4, 50), rng.uniform(0, 2 * np.pi)
        dims = np.asarray(dims) * rng.uniform(0.85, 1.15, 3)
        objs.append({"dims": dims, "ctr_g": np.array([r * np.cos(th), r * np.sin(th), dims[2] / 2]),
                     "yaw": rng.uniform(0, 2 * np.pi), "inten": 20.0, "walls": walls})
    pts = np.concatenate([jsn._lidar_cloud(rng, objs, -0.3 * s, 32, 1080)[0] for s in range(9)])
    vl = fusion_base_config().model.pts_voxel_layer
    cap = vl.max_voxels[1]
    vo = voxelize_batched(torch.from_numpy(pts)[None], torch.ones(1, len(pts), dtype=torch.bool),
                          voxel_size=vl.voxel_size, point_cloud_range=vl.point_cloud_range,
                          max_num_points=vl.max_num_points, max_voxels=cap)
    valid = torch.arange(cap) < vo.num_voxels[0]
    shape = tuple(fusion_base_config().model.pts_middle_encoder.sparse_shape)
    nbr = tsc.subm_neighbor_table(tsc.SparseTensor(None, vo.coords[0], valid, shape))
    assert int(valid.sum()) > 100_000
    want = bool(scb.make_banded_plan(jnp.asarray(nbr.numpy()), jnp.asarray(valid.numpy()), T=128, W=512).ovf)
    assert want and bool(tsc.banded_overflow(nbr, valid)) == want


@pytest.mark.parametrize("cin,cout", [(8, 8), (16, 32)])
def test_conv_overflow_falls_back_to_fp32(cin, cout):
    """A plan with an 8-row window overflows: JAX computes the conv and
    d/dfeat with the fp32 gather, d/dW on the bf16-rounded features; the
    port, given the flag, the same (and counts both convs as fp32)."""
    rng, st, nbr, _ = _sparse(1, cin)
    plan = scb.make_banded_plan(nbr, st.valid, T=128, W=8)
    assert bool(plan.ovf)
    w = (rng.normal(size=(27, cin, cout)) * 0.2).astype(np.float32)
    dy = rng.normal(size=(st.features.shape[0], cout)).astype(np.float32)

    def loss(f, ww):
        return jnp.sum(scb.banded_subm_conv(128, 8, True, f, ww, st.valid, nbr, plan) * dy)

    want_out = np.asarray(scb.banded_subm_conv(128, 8, True, st.features, jnp.asarray(w), st.valid, nbr, plan))
    want = [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1))(st.features, jnp.asarray(w))]
    tn, tv = _t(nbr), _t(st.valid)
    ovf = tsc.banded_overflow(tn, tv, 128, 8)
    f, ww = _t(st.features).requires_grad_(True), _t(w).requires_grad_(True)
    tsm.taken("cpu").zero_()
    out = tsm.subm_conv_gemm_bf16(f, tn, ww, tv, tsc.mirror_table(tn), ovf=ovf)
    (out * _t(dy)).sum().backward()
    assert tsm.taken("cpu").tolist() == [2, 0]
    for got, ref in ((out.detach(), want_out), (f.grad, want[0]), (ww.grad, want[1])):
        got = got.numpy()
        assert np.abs(got - ref).max() <= K1_TOL * np.abs(ref).max(), np.abs(got - ref).max() / np.abs(ref).max()
    # without the flag the port's bf16 output is off JAX's fp32 by bf16 rounding
    bf16 = tsm.subm_conv_gemm_bf16(_t(st.features), tn, _t(w), tv).numpy()
    assert np.abs(bf16 - want_out).max() > 10 * K1_TOL * np.abs(want_out).max()


@functools.lru_cache(maxsize=None)
def _encoder_setup():
    """``_voxels()``, the same as JAX arrays, and the tiny Flax encoder's
    variables (initialised once for the file's tests)."""
    cfg, feats, coords, valid = _voxels()
    jcfg = jtiny().model.pts_middle_encoder
    jargs = (jnp.asarray(feats.numpy()), jnp.asarray(coords.numpy()), jnp.asarray(valid.numpy()))
    variables = jax.jit(lambda r, *a: jse.SparseEncoder(jcfg, impl="gather").init(r, *a, False))(
        jax.random.PRNGKey(3), *jargs)
    return (cfg, feats, coords, valid), jargs, variables


def _flax_encoder(monkeypatch, impl, train=False):
    """The tiny Flax sparse encoder's output on ``_voxels()`` at ``impl``
    (banded in interpret mode, with each conv's plan flag recorded), its
    variables, and the port's inputs."""
    inputs, jargs, variables = _encoder_setup()
    ovf = []
    banded = scb.banded_subm_conv

    def interpreted(t, w, _interpret, *args):
        jax.debug.callback(lambda o: ovf.append(bool(o)), args[-1].ovf)
        return banded(t, w, True, *args)

    monkeypatch.setattr(jse, "_resolve_impl", lambda impl: impl)
    monkeypatch.setattr(scb, "banded_subm_conv", interpreted)
    enc = jse.SparseEncoder(jtiny().model.pts_middle_encoder, impl=impl)
    if train:
        ref, _ = jax.jit(lambda v, *a: enc.apply(v, *a, True, mutable=["batch_stats"]))(variables, *jargs)
    else:
        ref = jax.jit(lambda v, *a: enc.apply(v, *a, False))(variables, *jargs)
    jax.effects_barrier()
    return np.asarray(ref), variables, ovf, inputs


def _port_encoder(variables, cfg, windows=(512,)):
    enc = SparseEncoder(cfg.model.pts_middle_encoder, 128, windows)
    load_flax(enc, jax.tree_util.tree_map(np.asarray, variables))
    return enc


def test_sparse_encoder_overflow_matches_flax_banded(monkeypatch):
    """Stage 0's plan overflows at an 8-row window, the later stages' do not
    at 512: JAX computes stage 0's 5 convs with the fp32 gather and the other
    12 on the bf16 kernel; so does the port, and it counts them so."""
    monkeypatch.setattr(jse, "_BANDED_WS", [8, 512])
    ref, variables, ovf, (cfg, feats, coords, valid) = _flax_encoder(monkeypatch, "banded")
    b = feats.shape[0]
    assert len(ovf) == 17 * b and ovf == [True] * 5 * b + [False] * 12 * b, ovf
    levers = EvalLevers.from_env({"DI_BANDED_W": "8,512"})
    assert (levers.banded_t, levers.banded_windows()) == (jse.BANDED_T, (8, 512))
    enc = _port_encoder(variables, cfg, levers.banded_windows()).eval()
    tsm.taken("cpu").zero_()
    with torch.no_grad():
        got = enc(feats, coords, valid, bf16=True).numpy()
        assert tsm.taken("cpu").tolist() == [5 * b, 12 * b]
        ignored = _port_encoder(variables, cfg, (10**6,)).eval()(feats, coords, valid, bf16=True).numpy()
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= ENCODER_TOL * scale, np.abs(got - ref).max() / scale
    # the test's reach: the port that ignored the flag misses the tolerance
    assert np.abs(ignored - ref).max() > ENCODER_TOL * scale, np.abs(ignored - ref).max() / scale


@pytest.mark.parametrize("cin,cout", [(16, 16), (5, 16), (32, 8)])
def test_s2d_conv_plain_matches_jax(cin, cout):
    """One conv: the port's s2d numerics (bf16 operands, one fp32 sum)
    against ``subm_conv_s2d`` (bf16 by default), and nowhere near fp32."""
    rng, st, nbr, _ = _sparse(2, cin)
    w = (rng.normal(size=(27, cin, cout)) * 0.2).astype(np.float32)
    ref = np.asarray(jsc.subm_conv_s2d(st, jnp.asarray(w)))
    args = (_t(st.features), _t(nbr), _t(w), _t(st.valid))
    got = tsm.subm_conv_gemm_bf16(*args, per_tap=False).numpy()
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= S2D_CONV_TOL * scale, np.abs(got - ref).max() / scale
    fp32 = tsm.subm_conv_gemm(*args).numpy()
    per_tap = tsm.subm_conv_gemm_bf16(*args).numpy()
    assert _rms(fp32 - ref) > 100 * _rms(got - ref) and _rms(per_tap - ref) > 100 * _rms(got - ref)


def test_s2d_conv_gradients():
    """JAX's s2d has no gradient here; the port's s2d backward against
    ``jax.vjp`` of the gather on bf16-rounded operands: d/dfeat at the
    cotangent rounded to bf16 (the bf16 conv over the inverse table), d/dW
    at the cotangent as it is (fp32 over the bf16 features)."""
    rng, st, nbr, _ = _sparse(3, 16)
    w = (rng.normal(size=(27, 16, 24)) * 0.2).astype(np.float32)
    dy = rng.normal(size=(st.features.shape[0], 24)).astype(np.float32)
    with pytest.raises(TypeError, match="conv_general_dilated"):
        jax.grad(lambda f: jnp.sum(jsc.subm_conv_s2d(st._replace(features=f), jnp.asarray(w))))(st.features)

    def bf(a):
        return jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32)

    _, vjp = jax.vjp(lambda f, ww: jsc.gathered_matmul(f, nbr, ww.reshape(27 * 16, 24), st.valid),
                     bf(st.features), bf(w))
    want_f = np.asarray(vjp(bf(dy))[0])
    want_w = np.asarray(vjp(jnp.asarray(dy))[1])
    tn = _t(nbr)
    f, ww = _t(st.features).requires_grad_(True), _t(w).requires_grad_(True)
    (tsm.subm_conv_gemm_bf16(f, tn, ww, _t(st.valid), tsc.mirror_table(tn), per_tap=False) * _t(dy)).sum().backward()
    for got, ref in ((f.grad, want_f), (ww.grad, want_w)):
        got = got.numpy()
        assert np.abs(got - ref).max() <= S2D_GRAD_TOL * np.abs(ref).max(), np.abs(got - ref).max()


@pytest.mark.parametrize("train", [False, True])
def test_sparse_encoder_s2d_matches_flax(monkeypatch, train):
    """The tiny encoder with ``s2d=True`` against the Flax encoder at
    ``impl="s2d"`` (eval, and the train-mode forward with batch
    statistics), within ENCODER_TOL (eval) and S2D_TRAIN_TOL (train) of
    scale and closer than fp32."""
    ref, variables, _, (cfg, feats, coords, valid) = _flax_encoder(monkeypatch, "s2d", train)
    enc = _port_encoder(variables, cfg).train(train)
    with torch.no_grad():
        got = enc(feats, coords, valid, train, s2d=True).numpy()
        fp32 = _port_encoder(variables, cfg).train(train)(feats, coords, valid, train).numpy()
    scale = np.abs(ref).max()
    tol = S2D_TRAIN_TOL if train else ENCODER_TOL
    assert np.abs(got - ref).max() <= tol * scale, np.abs(got - ref).max() / scale
    assert _rms(got - ref) < _rms(fp32 - ref), (_rms(got - ref), _rms(fp32 - ref))


def test_k1_numerics_follow_jax_resolution():
    """JAX's ``SparseEncoder``: train takes DI_SPARSE_TRAIN_IMPL while
    DI_SPARSE_IMPL is ``banded``; ``banded`` runs only on the TPU
    (``_resolve_impl``), ``s2d`` everywhere; the rest is fp32."""
    cases = [
        ({}, False, "banded", "fp32"),
        ({}, True, "fp32", "fp32"),
        ({"DI_SPARSE_TRAIN_IMPL": "banded"}, True, "banded", "fp32"),
        ({"DI_SPARSE_TRAIN_IMPL": "s2d"}, True, "s2d", "s2d"),
        ({"DI_SPARSE_IMPL": "s2d"}, False, "s2d", "s2d"),
        ({"DI_SPARSE_IMPL": "s2d", "DI_SPARSE_TRAIN_IMPL": "banded"}, True, "s2d", "s2d"),
        ({"DI_SPARSE_IMPL": "dense"}, False, "fp32", "fp32"),
        ({"DI_SPARSE_IMPL": "gather"}, False, "fp32", "fp32"),
    ]
    for env, train, on_cuda, on_cpu in cases:
        lv = EvalLevers.from_env(env)
        assert (lv.k1_numerics(train, True), lv.k1_numerics(train, False)) == (on_cuda, on_cpu), env
        assert lv.bf16_kernels(train, True)[0] == (on_cuda == "banded")
    with pytest.raises(ValueError):
        EvalLevers.from_env({"DI_BANDED_W": "0"})
    assert EvalLevers.from_env({"DI_BANDED_W": "512,384,320,256"}).banded_windows() == (512, 384, 320, 256)

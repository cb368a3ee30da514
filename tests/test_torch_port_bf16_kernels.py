"""The two Pallas kernels' bf16 numerics in the port (K1's and K2's bf16
variants, ``levers.py``'s ``DI_SPARSE_IMPL`` ... ``DI_LOCATT_MXU``) against
the JAX package on the CPU, on inputs made from numpy seeds.

- K1's bf16 plain version (``subm_conv_gemm_bf16`` on CPU tensors) against
  ``banded_subm_conv(..., interpret=True)``: within 1e-4 of scale and at
  least 100x closer in RMS than the fp32 version, at 16->16, 64->64 and
  5->16 (the inputs of ``tests/test_sparse_conv_banded.py``, no window
  overflow); d/dfeat and d/dW against ``jax.grad`` through it the same way.
  What is left is a tap's product whose two fp32 sums over Cin, taken in
  different orders, round to neighbouring bf16 values.
- K2's bf16 plain version (``local_attn_fwd_bf16``) against
  ``_pallas_forward(..., interpret=True)``: within 1e-5 of scale at k = 5
  and 9, a map smaller than the window included, 100x closer in RMS than
  fp32; its gradients are the fp32 ones, as JAX's custom VJP.
- The port's ``SparseEncoder`` and MMRI encoder (its one layer) with the
  bf16 flags forced on the CPU, against the Flax modules on their banded
  and Pallas paths (``_resolve_impl`` and ``local_attention`` patched in the
  test, the banded kernel in interpret mode): within 2e-3 (encoder, see
  ENCODER_TOL) and 1e-3 (MMRI) of scale and closer in RMS than the fp32
  port.
- The FLOP count of the bf16 variants: the fp32 kernels' formulas.
- ``EvalLevers`` for the five names, ``parity()`` = the JAX gate tool's
  ``PARITY``, and where the detector applies the flags: on CUDA tensors
  (simulated by the resolution, as the CPU has no card) the 17 submanifold
  convs and the local attentions get ``bf16=True``, on CPU tensors none.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepinteraction_tpu.models.mmri_encoder as jmmri
import deepinteraction_tpu.models.sparse_encoder as jse
from deepinteraction_tpu.configs import tiny_config as jtiny
from deepinteraction_tpu.ops import sparse_conv as jsc
from deepinteraction_tpu.ops import sparse_conv_banded as scb
from deepinteraction_tpu.ops.local_attention_pallas import _pallas_forward, local_attention_fused
from deepinteraction_tpu.utils.testing import make_synthetic_batch as jax_batch
from deepinteraction_tpu_torch.configs import tiny_config
from deepinteraction_tpu_torch.convert import load_flax
from deepinteraction_tpu_torch.levers import PARITY, EvalLevers
from deepinteraction_tpu_torch.models import mmri_encoder, sparse_encoder
from deepinteraction_tpu_torch.models.detector import DeepInteraction
from deepinteraction_tpu_torch.models.mmri_encoder import MMRIEncoder
from deepinteraction_tpu_torch.models.sparse_encoder import SparseEncoder
from deepinteraction_tpu_torch.ops import flops as flops_mod
from deepinteraction_tpu_torch.ops import local_attention as tla
from deepinteraction_tpu_torch.ops import sparse_conv as tsc
from deepinteraction_tpu_torch.ops import subm_conv as tsm
from deepinteraction_tpu_torch.ops.voxelize import hard_simple_vfe, voxelize_batched
from deepinteraction_tpu_torch.utils.synthetic import init_weights, to_torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (9, 48, 48)
K1_TOL = 1e-4  # of scale
K2_TOL = 1e-5  # of scale
MODULE_TOL = 1e-3  # of scale
# The sparse encoder's output: a tap's product that the two sides round to
# neighbouring bf16 values (1e-4 of a conv's scale, above) feeds 16 more
# convs, each rounding its input to bf16, and their BatchNorms: 1.29e-3 of
# scale at these inputs (the fp32 port: 3.74e-3), so 2e-3
ENCODER_TOL = 2e-3
CLOSER = 100  # the bf16 version's RMS distance at least this many times below fp32's


def _t(a):
    return torch.from_numpy(np.array(a))


def _rms(d):
    return float(np.sqrt(np.mean(np.square(d))))


def _check_closer(bf16, fp32, ref, tol, closer=CLOSER):
    """``bf16`` within ``tol`` of ``ref``'s scale and ``closer`` times nearer
    in RMS than ``fp32``."""
    scale = np.abs(ref).max()
    assert np.abs(bf16 - ref).max() <= tol * scale, np.abs(bf16 - ref).max() / scale
    assert _rms(fp32 - ref) >= closer * _rms(bf16 - ref), (_rms(fp32 - ref), _rms(bf16 - ref))


def _sparse(seed, c, n_active=500, capacity=640):
    """``tests/test_sparse_conv_banded.py::_make``'s inputs: sorted random
    sites in a 9x48x48 grid, features normal, invalid rows zero."""
    rng = np.random.default_rng(seed)
    ids = np.sort(rng.permutation(np.prod(SHAPE))[:n_active])
    coords = np.stack([ids // (SHAPE[1] * SHAPE[2]), (ids // SHAPE[2]) % SHAPE[1], ids % SHAPE[2]], 1)
    coords = np.concatenate([coords, np.zeros((capacity - n_active, 3))]).astype(np.int32)
    feats = rng.normal(size=(capacity, c)).astype(np.float32)
    valid = np.arange(capacity) < n_active
    feats[~valid] = 0
    st = jsc.SparseTensor(jnp.asarray(feats), jnp.asarray(coords), jnp.asarray(valid), SHAPE)
    nbr = jsc.subm_neighbor_table(st)
    plan = scb.make_banded_plan(nbr, st.valid, T=128, W=512)
    assert not bool(plan.ovf)  # bf16 here; the fallback's own inputs: test_torch_port_banded_plan.py
    return rng, st, nbr, plan


@pytest.mark.parametrize("cin,cout", [(16, 16), (64, 64), (5, 16)])
def test_k1_bf16_plain_matches_banded_kernel(cin, cout):
    rng, st, nbr, plan = _sparse(0, cin)
    w = (rng.normal(size=(27, cin, cout)) * 0.2).astype(np.float32)
    ref = np.asarray(scb.banded_subm_conv(128, 512, True, st.features, jnp.asarray(w), st.valid, nbr, plan))
    args = (_t(st.features), _t(nbr), _t(w), _t(st.valid))
    bf16 = tsm.subm_conv_gemm_bf16(*args).numpy()
    assert np.array_equal(bf16, tsm.gathered_matmul(*args, bf16=True).numpy())
    _check_closer(bf16, tsm.subm_conv_gemm(*args).numpy(), ref, K1_TOL)


@pytest.mark.parametrize("cin,cout", [(16, 16), (64, 64), (5, 16)])
def test_k1_bf16_gradients_match_banded_kernel(cin, cout):
    """d/dfeat (the bf16 conv over the inverse table with W^T) and d/dW (on
    the features rounded to bf16) against ``jax.grad`` through the banded
    kernel's custom VJP."""
    rng, st, nbr, plan = _sparse(1, cin)
    w = (rng.normal(size=(27, cin, cout)) * 0.2).astype(np.float32)
    dy = rng.normal(size=(st.features.shape[0], cout)).astype(np.float32)

    def loss(f, ww):
        return jnp.sum(scb.banded_subm_conv(128, 512, True, f, ww, st.valid, nbr, plan) * dy)

    want = [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1))(st.features, jnp.asarray(w))]
    tn = _t(nbr)
    inv = tsc.mirror_table(tn)

    def grads(fn):
        f, ww = _t(st.features).requires_grad_(True), _t(w).requires_grad_(True)
        (fn(f, tn, ww, _t(st.valid), inv) * _t(dy)).sum().backward()
        return f.grad.numpy(), ww.grad.numpy()

    got, fp32 = grads(tsm.subm_conv_gemm_bf16), grads(tsm.subm_conv_gemm)
    for g, f, r in zip(got, fp32, want):
        _check_closer(g, f, r, K1_TOL)


@pytest.mark.parametrize("shape,kernel", [
    ((1, 16, 24, 128), 9), ((2, 16, 24, 128), 5),
    ((1, 5, 7, 128), 9),  # smaller than the window both ways
])
def test_k2_bf16_plain_matches_pallas_kernel(shape, kernel):
    """The inputs of ``tests/test_torch_port_ops.py`` (seeded by the shape).
    With other seeds a probability near a bf16 rounding boundary can round
    the other way in one of the two: at [2,16,24,128], k = 5, seeded
    sum(shape) + 5, one such flip moves an output by 9.2e-5 of scale (the
    card's tolerance covers it, ``chip_smoke.py`` K2_BF16_TOL)."""
    rng = np.random.default_rng(sum(shape))
    q, k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    ref = np.asarray(_pallas_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kernel, interpret=True))
    bf16 = tla.local_attn_fwd_bf16(_t(q), _t(k), _t(v), kernel).numpy()
    assert np.array_equal(bf16, tla.local_attention(_t(q), _t(k), _t(v), kernel, bf16=True).numpy())
    _check_closer(bf16, tla.local_attn_fwd(_t(q), _t(k), _t(v), kernel).numpy(), ref, K2_TOL)


def test_k2_bf16_gradients_are_the_fp32_ones():
    """JAX's custom VJP differentiates its fp32 oracle; so does the port's
    bf16 forward (``local_attn_bwd``, on CPU tensors autograd of the fp32
    plain version), to the bit."""
    rng = np.random.default_rng(5)
    q, k, v, g = (rng.normal(size=(1, 9, 12, 32)).astype(np.float32) for _ in range(4))
    vjp = jax.jit(lambda a, b, c, d: jax.vjp(lambda x, y, z: local_attention_fused(x, y, z, 5), a, b, c)[1](d))
    want = [np.asarray(x) for x in vjp(*map(jnp.asarray, (q, k, v, g)))]
    got = []
    for fn in (tla.local_attn_fwd_bf16, tla.local_attn_fwd):
        qkv = [_t(a).requires_grad_(True) for a in (q, k, v)]
        fn(*qkv, 5).backward(_t(g))
        got.append([a.grad.numpy() for a in qkv])
    for b, f, w in zip(*got, want):
        assert np.array_equal(b, f)
        np.testing.assert_allclose(b, w, rtol=1e-4, atol=1e-4 * np.abs(w).max())


def _voxels():
    cfg = tiny_config()
    vl = cfg.model.pts_voxel_layer
    batch = to_torch(jax_batch(jtiny(), b=1, seed=7), "cpu")
    vo = voxelize_batched(batch["points"], batch["points_mask"], voxel_size=vl.voxel_size,
                          point_cloud_range=vl.point_cloud_range, max_num_points=vl.max_num_points,
                          max_voxels=vl.max_voxels[1])
    valid = torch.arange(vl.max_voxels[1])[None] < vo.num_voxels[:, None]
    return cfg, hard_simple_vfe(vo.voxels, vo.num_points), vo.coords, valid


def test_sparse_encoder_bf16_matches_flax_banded(monkeypatch):
    """The tiny sparse encoder with ``bf16=True`` on the CPU against
    the Flax encoder on JAX's banded path (the kernel in interpret mode,
    every stage's plan without overflow)."""
    cfg, feats, coords, valid = _voxels()
    ovf = []
    banded = scb.banded_subm_conv

    def interpreted(t, w, _interpret, *args):
        jax.debug.callback(lambda o: ovf.append(bool(o)), args[-1].ovf)
        return banded(t, w, True, *args)

    monkeypatch.setattr(jse, "_resolve_impl", lambda impl: impl)
    monkeypatch.setattr(scb, "banded_subm_conv", interpreted)
    jcfg = jtiny().model.pts_middle_encoder
    jargs = (jnp.asarray(feats.numpy()), jnp.asarray(coords.numpy()), jnp.asarray(valid.numpy()))
    # the same parameters under either implementation
    variables = jax.jit(lambda r, *a: jse.SparseEncoder(jcfg, impl="gather").init(r, *a, False))(
        jax.random.PRNGKey(3), *jargs)
    ref = np.asarray(jax.jit(lambda v, *a: jse.SparseEncoder(jcfg, impl="banded").apply(v, *a, False))(
        variables, *jargs))
    jax.effects_barrier()
    assert len(ovf) == feats.shape[0] * 17 and not any(ovf), ovf
    enc = SparseEncoder(cfg.model.pts_middle_encoder).eval()
    load_flax(enc, jax.tree_util.tree_map(np.asarray, variables))
    with torch.no_grad():
        got = enc(feats, coords, valid, bf16=True).numpy()
        fp32 = enc(feats, coords, valid).numpy()
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= ENCODER_TOL * scale, np.abs(got - ref).max() / scale
    assert _rms(got - ref) < _rms(fp32 - ref), (_rms(got - ref), _rms(fp32 - ref))


def _mmri_inputs(cfg, seed=4):
    """Random image and BEV features at the tiny widths and the tiny batch's
    points and pillars."""
    rng = np.random.default_rng(seed)
    nc = cfg.model.imgpts_neck
    batch = to_torch(jax_batch(jtiny(), b=1, seed=7), "cpu")
    pl = cfg.model.pts_pillar_layer
    po = voxelize_batched(batch["points"], batch["points_mask"], voxel_size=pl.voxel_size,
                          point_cloud_range=pl.point_cloud_range, max_num_points=pl.max_num_points,
                          max_voxels=pl.max_voxels[1])
    batch.update(pillars=po.voxels, pillar_counts=po.num_points, pillar_coords=po.coords,
                 pillar_valid=torch.arange(pl.max_voxels[1])[None] < po.num_voxels[:, None])
    h, w = cfg.data.padded_img_shape
    img = rng.normal(size=(1, cfg.data.num_views, h // 4, w // 4, nc.in_channels_img)).astype(np.float32)
    pts = rng.normal(size=(1, 16, 16, nc.in_channels_pts)).astype(np.float32)
    return img, pts, batch


def test_mmri_encoder_bf16_matches_flax_pallas(monkeypatch):
    """The tiny MMRI encoder (one layer, k = 5) with ``bf16=True`` on the
    CPU against the Flax encoder with its local attentions on the Pallas
    kernel (interpret mode, bf16 by default)."""
    cfg = tiny_config()
    img, pts, batch = _mmri_inputs(cfg)
    monkeypatch.setattr(jmmri, "local_attention", lambda q, k, v, kernel, train=False:
                        local_attention_fused(q, k, v, kernel))
    jcfg = jtiny()
    jenc = jmmri.MMRIEncoder(jcfg.model.imgpts_neck, jcfg.model.pts_voxel_layer.point_cloud_range,
                             jcfg.data.padded_img_shape)
    jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    variables = jax.jit(lambda r, i, p, b: jenc.init(r, i, p, b, False))(jax.random.PRNGKey(5), img, pts, jb)
    want_img, (_, want_pts) = jax.jit(lambda v, i, p, b: jenc.apply(v, i, p, b, False))(variables, img, pts, jb)
    enc = MMRIEncoder(cfg.model.imgpts_neck, cfg.model.img_neck.out_channels, sum(cfg.model.pts_neck.out_channels),
                      cfg.model.pts_voxel_layer.point_cloud_range, cfg.data.padded_img_shape).eval()
    load_flax(enc, jax.tree_util.tree_map(np.asarray, variables))
    with torch.no_grad():
        got_img, (_, got_pts) = enc(_t(img), _t(pts), batch, bf16=True)
        fp_img, (_, fp_pts) = enc(_t(img), _t(pts), batch)
    for g, f, w in ((got_img, fp_img, want_img), (got_pts, fp_pts, want_pts)):
        g, f, w = g.numpy(), f.numpy(), np.asarray(w)
        scale = np.abs(w).max()
        assert np.abs(g - w).max() <= MODULE_TOL * scale, np.abs(g - w).max() / scale
        assert _rms(g - w) < _rms(f - w), (_rms(g - w), _rms(f - w))


def _jax_gate_tool():
    spec = importlib.util.spec_from_file_location("jax_gate_eval", os.path.join(REPO, "tools", "gate_eval.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_levers_read_the_five_names_and_resolve_by_device():
    assert PARITY == _jax_gate_tool().PARITY
    assert EvalLevers.parity() == EvalLevers.from_env(PARITY)
    assert EvalLevers.parity().sparse_impl == "gather" and EvalLevers.parity().locatt_mxu == "bf16"
    d = EvalLevers.from_env({})
    assert (d.sparse_impl, d.sparse_train_impl, d.pallas_locatt, d.pallas_locatt_train, d.locatt_mxu) == (
        "banded", "gather", True, False, "bf16")
    got = EvalLevers.from_env({"DI_SPARSE_IMPL": "s2d", "DI_SPARSE_TRAIN_IMPL": "banded", "DI_PALLAS_LOCATT": "0",
                               "DI_PALLAS_LOCATT_TRAIN": "1", "DI_LOCATT_MXU": "f32"})
    assert got == EvalLevers(sparse_impl="s2d", sparse_train_impl="banded", pallas_locatt=False,
                             pallas_locatt_train=True, locatt_mxu="f32")
    assert EvalLevers.from_env(got.as_env()) == got
    # (environment, train) -> (K1, K2) on CUDA; always fp32 on the CPU
    cases = [
        ({}, False, (True, True)),
        ({}, True, (False, False)),
        ({"DI_SPARSE_TRAIN_IMPL": "banded"}, True, (True, False)),
        ({"DI_SPARSE_IMPL": "gather", "DI_SPARSE_TRAIN_IMPL": "banded"}, True, (False, False)),
        ({"DI_SPARSE_IMPL": "dense"}, False, (False, True)),
        ({"DI_PALLAS_LOCATT": "0"}, False, (True, False)),
        ({"DI_LOCATT_MXU": "f32"}, False, (True, False)),
        ({"DI_LOCATT_MXU": "f32", "DI_SPARSE_IMPL": "gather"}, False, (False, False)),
        ({"DI_PALLAS_LOCATT_TRAIN": "1"}, True, (False, True)),
        ({"DI_PALLAS_LOCATT_TRAIN": "1", "DI_LOCATT_MXU": "f32"}, True, (False, False)),
        (PARITY, False, (False, True)),
    ]
    for env, train, want in cases:
        lv = EvalLevers.from_env(env)
        assert lv.bf16_kernels(train, cuda=True) == want, (env, train)
        assert lv.bf16_kernels(train, cuda=False) == (False, False), (env, train)


@pytest.mark.parametrize("cuda,env,want", [
    (True, {}, (17, 4, 3)),
    (True, {"DI_SPARSE_IMPL": "gather"}, (0, 21, 3)),
    (True, {"DI_LOCATT_MXU": "f32"}, (17, 4, 0)),
    (True, {"DI_PALLAS_LOCATT": "0"}, (17, 4, 0)),
    (False, {}, (0, 21, 0)),
])
def test_detector_applies_the_flags_where_the_batch_is_on_cuda(cuda, env, want, monkeypatch):
    """The tiny detector's eval forward: (K1 calls with ``bf16``, without,
    K2 calls with ``bf16``). ``cuda=True`` resolves the settings as for a
    batch on CUDA; the wrappers' plain versions then run the bf16 math on
    the CPU tensors, which is what the card's kernels compute."""
    calls = {"k1": [], "k2": []}
    k1, k2 = sparse_encoder.subm_conv_gemm, mmri_encoder.local_attn_fwd

    def rec_k1(*a, bf16=False, **k):
        calls["k1"].append(bf16)
        return k1(*a, bf16=bf16, **k)

    def rec_k2(*a, bf16=False, **k):
        calls["k2"].append(bf16)
        return k2(*a, bf16=bf16, **k)

    monkeypatch.setattr(sparse_encoder, "subm_conv_gemm", rec_k1)
    monkeypatch.setattr(mmri_encoder, "local_attn_fwd", rec_k2)
    resolve = EvalLevers.bf16_kernels
    monkeypatch.setattr(EvalLevers, "bf16_kernels", lambda self, train, _cuda: resolve(self, train, cuda))
    cfg = tiny_config()
    model = DeepInteraction(cfg.model, cfg.data.padded_img_shape, cfg.test_num_proposals,
                            levers=EvalLevers.from_env(env)).eval()
    init_weights(model, seed=7)
    preds = model(to_torch(jax_batch(jtiny(), b=1, seed=7), "cpu"))
    assert all(torch.isfinite(v.float()).all() for v in preds.values())
    assert (sum(calls["k1"]), len(calls["k1"]) - sum(calls["k1"]), sum(calls["k2"])) == want
    assert len(calls["k2"]) == 3 * cfg.model.imgpts_neck.num_layers


def test_bf16_variants_counted_as_the_fp32_kernels():
    """``FlopCounterMode`` counts the bf16 variants (forward and backward)
    by the fp32 kernels' formulas, under the same operator names, and the
    counted route gives the plain route's outputs and gradients."""
    rng = np.random.default_rng(2)
    kin, taps, cin, cout = 60, 27, 8, 12
    nbr = torch.from_numpy(np.where(rng.random((kin, taps)) < 0.3, rng.integers(0, kin, (kin, taps)), kin)
                           .astype(np.int32))
    valid = torch.from_numpy(rng.random(kin) < 0.8)
    feats, w = torch.randn(kin, cin), torch.randn(taps, cin, cout)
    inv = tsc.inverse_table(nbr, kin)
    q, k, v, g = (torch.randn(1, 6, 7, 8) for _ in range(4))
    runs = []
    for counted in (True, False):
        f, ww = feats.clone().requires_grad_(True), w.clone().requires_grad_(True)
        qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]

        def fwd_bwd():
            out = tsm.subm_conv_gemm_bf16(f, nbr, ww, valid, inv)
            out.sum().backward()
            att = tla.local_attn_fwd_bf16(*qkv, 5)
            att.backward(g)
            return out, att

        if counted:
            (out, att), total, by_op = flops_mod.count_flops(fwd_bwd)
        else:
            out, att = fwd_bwd()
        runs.append([out.detach(), att.detach(), f.grad, ww.grad] + [t.grad for t in qkv])
    hits = int(((nbr < kin) & valid[:, None]).sum())
    assert by_op == {"di_port.subm_conv_gemm": 2 * cin * cout * hits,
                     "di_port.subm_conv_dgrad": 2 * cin * cout * int((inv < kin).sum()),
                     "di_port.subm_conv_wgrad": 2 * cin * cout * int((nbr < kin).sum()),
                     "di_port.local_attn_fwd": 4 * 25 * 8 * 42, "di_port.local_attn_bwd": 10 * 25 * 8 * 42}
    assert total == sum(by_op.values())
    for got, want in zip(*runs):
        assert torch.equal(got, want)

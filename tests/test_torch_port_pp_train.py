"""The port's DeepInteraction++ (``fusion_plusplus``) train step against the
JAX package, on the CPU.

- One ``tiny_pp_config`` step at B=2 against JAX ``make_train_step`` on the
  same weights (``fast_init_variables``) and the batch with the views
  widened (``_wide_cameras`` of ``tests/test_torch_port_pp.py``, so that
  queries land on the images and the image path carries gradient), both in
  float64 for the reason ``tests/test_torch_port_fusion_train.py`` gives
  (ReLU inputs within fp32 rounding of 0 in the DynamicConv blocks). The
  JAX ++ neck runs in its all-view form, the port's only form (the
  ``AllViewsI2P`` and ``DI_WARP_VIEWS=0`` patch of
  ``tests/test_torch_port_pp.py``), and its dropout is 0 on both sides
  (JAX and torch draw from different generators; JAX's deformable
  attentions, built at their default rate, through a patched subclass): the Hungarian
  assignment of every MMPI layer exactly, each loss term and ``grad_norm``
  at rtol 1e-3, every gradient leaf through the bridge at 1e-3 of its
  scale, the BN statistics at 1e-5.
- The same step with ``freeze_img=freeze_pts=True``: frozen leaves get no
  ``.grad`` and are unchanged after the update, trainable ones move, the
  losses equal JAX's.
- The trainable parameters of the full ``fusion_plusplus_config()`` model
  (built on ``meta``) are, through the bridge, exactly the leaves JAX
  ``make_optimizer``'s ``multi_transform`` labels ``"train"``.
- ``MSDeformableAttention`` and ``PolarI2P`` in train mode: their input and
  weight gradients against ``jax.grad`` of their Flax modules (dropout 0,
  float64, 1e-4 of each gradient's scale; MSDA with samples off the map),
  and their dropouts drawn from the caller's generator (MSDA's at its own
  default rate, 0.1, as the JAX ++ neck builds it).
- Per-layer recompute with dropout 0.1: a ``FusionLayerImg`` and a
  ``FusionLayerPts`` gradient through the neck's checkpoint path
  (``fusion_transformer.recomputed``, the pillar I2P's chunk checkpoints
  nested inside) equals the layer called directly, with no checkpoint at
  all, from the same generator state (1e-6); a checkpoint that does not
  restore the generator gives other gradients.

The JAX step is compiled once for the module.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

import jax
import jax.numpy as jnp
import optax

import deepinteraction_tpu.models.fusion_transformer as jfusion
from deepinteraction_tpu import configs as jcfg
from deepinteraction_tpu.models.detector import DeepInteraction as JaxDeepInteraction
from deepinteraction_tpu.ops import hungarian as jhung
from deepinteraction_tpu.ops.deform_attn import MSDeformableAttention as JaxMSDA
from deepinteraction_tpu.train.step import create_train_state, make_optimizer, make_train_step
from deepinteraction_tpu.utils.testing import fast_init_variables
from deepinteraction_tpu.utils.testing import make_synthetic_batch as jax_batch
from deepinteraction_tpu_torch import configs as tcfg
from deepinteraction_tpu_torch.convert import grads_from_flax, load_flax, params_from_flax
from deepinteraction_tpu_torch.models import fusion_transformer as tfusion
from deepinteraction_tpu_torch.models import mmri_encoder
from deepinteraction_tpu_torch.models.detector import DeepInteraction
from deepinteraction_tpu_torch.ops.deform_attn import MSDeformableAttention
from deepinteraction_tpu_torch.train.step import TrainStep, is_frozen
from deepinteraction_tpu_torch.utils.synthetic import init_weights, to_torch
from test_torch_port_pp import _randomize, _wide_cameras

torch.set_num_threads(1)

TOTAL_STEPS = 10
LOSS_RTOL = 1e-3
GRAD_TOL = 1e-3  # max|port - jax| / max|jax| per gradient leaf
STATS_TOL = 1e-5
MOD_GRAD_TOL = 1e-4  # a module's gradients against jax.grad of its Flax module
RECOMPUTE_TOL = 1e-6  # recomputed against direct, same masks, float32
SEED = 3


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: a.astype(np.float64) if a.dtype == np.float32 else a, _np(tree))


def _neck_dropout(cfg, rate):
    m = cfg.model
    return dataclasses.replace(cfg, model=dataclasses.replace(
        m, imgpts_neck=dataclasses.replace(m.imgpts_neck, dropout=rate)))


def _frozen_cfg(cfg):
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, freeze_img=True, freeze_pts=True))


def _port_cfg():
    return _neck_dropout(tcfg.tiny_pp_config(), 0.0)


def _to(batch, dtype):
    return {k: v.to(dtype) if v.is_floating_point() else v for k, v in batch.items()}


def _port_step(variables, np_batch, cfg, dtype=torch.float64):
    port = load_flax(DeepInteraction(cfg.model, cfg.data.padded_img_shape), variables).to(dtype)
    for m in port.modules():  # the deformable attentions keep their own rate
        if isinstance(m, MSDeformableAttention):
            m.dropout = 0.0
    step = TrainStep(cfg, port, TOTAL_STEPS, device="cpu")
    return port, step, _to(to_torch(np_batch, "cpu"), dtype)


def _assert_grads(got, want):
    """Every leaf within GRAD_TOL of its scale; leaves that are 0 in exact
    arithmetic (below 1e-8 of the largest) noise on both sides. Returns the
    names of those leaves."""
    noise = 1e-8 * max(g.abs().max().item() for g in want.values())
    bad, zeros = [], []
    for name in sorted(want):
        scale = want[name].abs().max().item()
        err = (got[name] - want[name]).abs().max().item()
        if scale < noise:
            zeros.append(name)
            ok = got[name].abs().max().item() < noise
        else:
            ok = err <= GRAD_TOL * scale
        if not ok:
            bad.append(f"{name}: max abs err {err:.3e}, scale {scale:.3e}")
    assert not bad, "\n".join(bad)
    return zeros


@pytest.fixture(scope="module")
def pp_step():
    """One JAX ``make_train_step`` step of the tiny ++ model in float64 (the
    all-view neck, dropout 0) with its Hungarian outputs recorded, and the
    port's float64 backward on the same weights and batch."""
    cfg = _neck_dropout(jcfg.tiny_pp_config(), 0.0)
    model = JaxDeepInteraction(cfg.model, cfg.data.padded_img_shape)
    np_batch = _wide_cameras(jax_batch(cfg, b=2, with_gt=True, seed=SEED), cfg)
    variables = _np(fast_init_variables(model, {k: jnp.asarray(v) for k, v in np_batch.items()}, seed=SEED))

    class AllViewsI2P(jfusion.MMRI_I2P):
        n_views: int = 0

    class NoDropoutMSDA(JaxMSDA):  # the neck builds its MSDA at the default rate, 0.1
        dropout: float = 0.0

    laps = []
    lap_host = jhung._lap_host

    def recording_lap(cost, num_gt):
        out = lap_host(cost, num_gt)
        laps.append(out)
        return out

    jhung._lap_host = recording_lap  # read when hungarian_assign is traced
    try:
        with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
            mp.setattr(jfusion, "MMRI_I2P", AllViewsI2P)
            mp.setattr(jfusion, "MSDeformableAttention", NoDropoutMSDA)
            mp.setenv("DI_WARP_VIEWS", "0")
            batch = {k: jnp.asarray(v) for k, v in _f64(np_batch).items()}
            state = create_train_state(cfg, _f64(variables), TOTAL_STEPS)
            new_state, metrics = jax.jit(make_train_step(cfg, model, TOTAL_STEPS))(
                state, batch, jax.random.PRNGKey(0))
            new_state, metrics = _np(new_state), _np(metrics)
    finally:
        jhung._lap_host = lap_host

    # Adam's first moment after one step is (1 - b1) * clip(g)
    adam = [s for s in jax.tree_util.tree_leaves(
        new_state.opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    assert len(adam) == 1
    b1 = cfg.optim.momentum_base
    norm, max_norm = float(metrics["grad_norm"]), cfg.optim.grad_clip_norm
    unclip = norm / max_norm if norm >= max_norm else 1.0
    jax_grads = jax.tree_util.tree_map(lambda m: m / (1.0 - b1) * unclip, adam[0].mu)

    port, step, batch = _port_step(variables, np_batch, _port_cfg())
    port_metrics, targets = step.backward(batch, torch.Generator().manual_seed(0))
    return dict(laps=laps, metrics=metrics, new_state=new_state, jax_grads=jax_grads, variables=variables,
                np_batch=np_batch, port=port, port_metrics=port_metrics, targets=targets,
                port_grads={n: p.grad.clone() for n, p in port.named_parameters() if p.grad is not None},
                no_grad=[n for n, p in port.named_parameters() if p.grad is None],
                port_stats={n: b.clone() for n, b in port.named_buffers()})


def test_pp_step_assignment_equals_jax(pp_step):
    assert len(pp_step["laps"]) == 1
    want = pp_step["laps"][0]  # [B, L, P]
    got = pp_step["targets"].assign.numpy()
    assert want.shape == got.shape == (2, 4, 8)
    assert (want >= 0).sum() > 0
    np.testing.assert_array_equal(got, want)


def test_pp_step_losses_match_jax(pp_step):
    want, got = pp_step["metrics"], pp_step["port_metrics"]
    assert set(got) == set(want)
    assert {f"layer_{i}_loss_{t}" for i in range(4) for t in ("cls", "bbox")} < set(want)
    for k in sorted(want):
        assert np.isfinite(float(want[k])), k
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=LOSS_RTOL, err_msg=k)
    assert float(want["grad_norm"]) > 0


def test_pp_step_gradients_match_jax(pp_step):
    want = grads_from_flax(pp_step["jax_grads"], pp_step["port"])
    got = {n: pp_step["port_grads"].get(n, torch.zeros_like(w)) for n, w in want.items()}
    zeros = _assert_grads(got, want)
    assert set(pp_step["no_grad"]) <= set(zeros)
    assert len(zeros) < 0.2 * len(want), zeros
    # the gradient reaches both branches of the neck, its polar and pillar
    # I2P, both V2 block kinds and the image backbone
    for prefix in ("imgpts_neck.img_layer0.self_attn.", "imgpts_neck.img_layer0.p2i.",
                   "imgpts_neck.pts_layer0.polar_i2p.", "imgpts_neck.pts_layer0.i2p.",
                   "pts_bbox_head.mmpi0_img.", "pts_bbox_head.mmpi3_pts.", "img_backbone.",
                   "pts_middle_encoder."):
        assert any(n.startswith(prefix) and n not in zeros for n in want), prefix


def test_pp_step_batch_stats_match_jax(pp_step):
    ns = pp_step["new_state"]
    want = params_from_flax({"params": ns.params, "batch_stats": ns.batch_stats}, pp_step["port"])
    got = pp_step["port_stats"]
    stats = [n for n in got if n.endswith(("running_mean", "running_var"))]
    assert len(stats) > 100
    for name in stats:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy().astype(np.float64), rtol=STATS_TOL,
                                   atol=STATS_TOL, err_msg=name)


def test_pp_freeze_both_branches(pp_step):
    cfg = _frozen_cfg(_port_cfg())
    model, step, batch = _port_step(pp_step["variables"], pp_step["np_batch"], cfg)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    metrics = step(batch, torch.Generator().manual_seed(0))
    want = pp_step["metrics"]
    for k in sorted(want):
        if k != "grad_norm":  # freezing changes the gradients, not the forward
            np.testing.assert_allclose(float(metrics[k]), float(want[k]), rtol=LOSS_RTOL, err_msg=k)
    assert 0 < float(metrics["grad_norm"]) < float(want["grad_norm"])
    after = model.state_dict()
    frozen = [k for k in before if is_frozen(k.rsplit(".", 1)[0], step.frozen)]
    assert any(k.startswith("img_backbone.") and k.endswith("running_var") for k in frozen)
    assert any(k.startswith("imgpts_neck.shared_conv_pts.") for k in frozen)
    for k in frozen:
        assert torch.equal(before[k], after[k]), k
    assert all(p.grad is None for n, p in model.named_parameters() if is_frozen(n, step.frozen))
    trainable = [n for n, p in model.named_parameters() if p.requires_grad]
    for prefix in ("imgpts_neck.img_layer0.", "imgpts_neck.pts_layer0.polar_i2p.",
                   "imgpts_neck.multi_scale_conv_img.", "pts_bbox_head.mmpi0_img."):
        assert any(n.startswith(prefix) for n in trainable), prefix
    assert not any(n.startswith(("img_backbone.", "img_neck.", "pts_middle_encoder.",
                                 "imgpts_neck.shared_conv_pts.", "pts_bbox_head.decoder0."))
                   for n in trainable)
    # a leaf moves unless its gradient is 0 and it is 0 (weight decay of 0)
    pulled = [n for n in trainable if model.get_parameter(n).grad.abs().max() > 0]
    assert len(pulled) > 0.8 * len(trainable)
    assert all(not torch.equal(before[n], after[n]) for n in pulled)


def test_pp_trainable_set_equals_jax_train_labels():
    """The full ``fusion_plusplus`` tree: the leaves the JAX optimizer
    updates (``multi_transform`` label ``"train"``: Adam keeps a moment for
    them, a ``MaskedNode`` for the rest) map through the bridge onto exactly
    the port's trainable parameters; the restore after the forward covers
    the frozen BN statistics and no non-persistent buffer."""
    cfg = jcfg.fusion_plusplus_config()
    model = JaxDeepInteraction(cfg.model, cfg.data.padded_img_shape)
    shapes = jax.eval_shape(lambda b: model.init(jax.random.PRNGKey(0), b, False),
                            jax_batch(cfg, b=1, seed=0))["params"]
    opt = jax.eval_shape(make_optimizer(cfg, TOTAL_STEPS).init, shapes)
    adam = [s for s in jax.tree_util.tree_leaves(opt, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
            if isinstance(s, optax.ScaleByAdamState)]
    assert len(adam) == 1
    labels = jax.tree_util.tree_map(
        lambda s, m: np.broadcast_to(np.float32(not isinstance(m, optax.MaskedNode)), s.shape), shapes, adam[0].mu,
        is_leaf=lambda m: isinstance(m, optax.MaskedNode))

    pcfg = tcfg.fusion_plusplus_config()
    with torch.device("meta"):
        port = DeepInteraction(pcfg.model, pcfg.data.padded_img_shape)
    step = TrainStep(pcfg, port, TOTAL_STEPS, device="meta")
    train = {n for n, t in grads_from_flax(labels, port).items() if bool(t.reshape(-1)[0])}
    trainable = {n for n, p in port.named_parameters() if p.requires_grad}
    assert len(list(port.parameters())) > 800
    assert train == trainable
    assert {id(p) for p in step.params} == {id(port.get_parameter(n)) for n in trainable}
    assert any(n.startswith("imgpts_neck.pts_layer1.polar_i2p.") for n in trainable)
    assert not any(n.startswith(("img_backbone.", "img_neck.", "imgpts_neck.shared_conv_pts.")) for n in trainable)

    frozen_stats = {n for n in port.state_dict() if is_frozen(n, step.frozen) and "running_" in n}
    named = {id(b): n for n, b in port.named_buffers()}
    assert {named[id(b)] for b in step.frozen_buffers} == frozen_stats
    assert any(n.endswith("rel_pos_index") for n in named.values())


def _float64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def _assert_close_grads(got, want, what):
    """Each gradient within MOD_GRAD_TOL of its scale; a leaf whose gradient
    is 0 in exact arithmetic (the key projection's bias, which the softmax
    cancels) is float64 noise on both sides, below 1e-10 of the largest."""
    got, want = ({n: np.asarray(t, np.float64) for n, t in d.items()} for d in (got, want))
    noise = 1e-10 * max(np.abs(w).max() for w in want.values())
    zeros = 0
    for name, w in want.items():
        scale, err = np.abs(w).max(), np.abs(got[name] - w).max()
        if scale < noise:
            zeros += 1
            assert np.abs(got[name]).max() < noise, f"{what} {name}: not ~0"
        else:
            assert err <= MOD_GRAD_TOL * scale, f"{what} {name}: max abs err {err:.3e}, scale {scale:.3e}"
    assert zeros <= 2, f"{what}: {zeros} leaves ~0"


def test_msda_grads_match_flax():
    """The port's MSDA (``F.grid_sample`` and autograd) against ``jax.grad``
    of the Flax module (the flat patch table and its custom VJPs), train
    mode, dropout 0, float64: the query, value and reference-point
    gradients and every weight's, with part of the samples off the map."""
    rng = np.random.default_rng(4)
    b, nq, c, h, l, p = 2, 30, 32, 4, 2, 4
    shapes = [(6, 9), (3, 5)]
    query = rng.normal(size=(b, nq, c)).astype(np.float32)
    value = rng.normal(size=(b, sum(hh * ww for hh, ww in shapes), c)).astype(np.float32)
    ref = rng.uniform(0.0, 1.0, size=(b, nq, l, 2)).astype(np.float32)
    cot = rng.normal(size=(b, nq, c))
    jm = JaxMSDA(c, h, l, p, dropout=0.0)
    init = jax.eval_shape(lambda q, v, r: jm.init(jax.random.PRNGKey(0), q, v, r, shapes), query, value, ref)
    params = _randomize(init["params"], rng, std=0.3)

    def loss(pr, q, v, r):
        return jnp.sum(jm.apply({"params": pr}, q, v, r, shapes, train=True) * cot)

    with jax.enable_x64(True):
        want = _np(jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(*_float64((params, query, value, ref))))

    port = load_flax(MSDeformableAttention(c, h, l, p, dropout=0.0), {"params": params}).double()
    q, v, r = (torch.from_numpy(a.astype(np.float64)).requires_grad_(True) for a in (query, value, ref))
    out = port(q, v, r, shapes, train=True, generator=torch.Generator().manual_seed(0))
    (out * torch.from_numpy(cot)).sum().backward()
    off = port.sampling_offsets(q).reshape(b, nq, h, l, p, 2)
    wh = torch.tensor([[ww, hh] for hh, ww in shapes], dtype=torch.float64)
    loc = r[:, :, None, :, None, :] + off / wh[:, None, :]
    off_map = ((loc < 0) | (loc > 1)).any(-1).float().mean().item()
    assert 0.1 < off_map < 0.9, off_map

    pg, qg, vg, rg = want
    _assert_close_grads({"query": q.grad, "value": v.grad, "reference_points": r.grad},
                        {"query": qg, "value": vg, "reference_points": rg}, "MSDA")
    wgrads = grads_from_flax(pg, port)
    _assert_close_grads({n: t.grad.detach() for n, t in port.named_parameters()}, wgrads, "MSDA")


def test_msda_dropout_from_generator():
    """Train mode at the module's default rate, 0.1: the output dropout is
    drawn from the caller's generator (one seed, one output; another seed,
    another), and eval applies none."""
    rng = np.random.default_rng(6)
    b, nq, c, shapes = 2, 30, 32, [(6, 9), (3, 5)]
    port = MSDeformableAttention(c, 4, 2, 4)
    assert port.dropout == 0.1
    q = torch.from_numpy(rng.normal(size=(b, nq, c)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(b, 69, c)).astype(np.float32))
    r = torch.from_numpy(rng.uniform(size=(b, nq, 2, 2)).astype(np.float32))
    with torch.no_grad():
        a, a2, other = (port(q, v, r, shapes, train=True, generator=torch.Generator().manual_seed(s))
                        for s in (1, 1, 2))
        ev = port(q, v, r, shapes)
    assert torch.equal(a, a2)
    dropped = (a - q) == 0
    assert 0.05 < dropped.float().mean().item() < 0.15
    torch.testing.assert_close(torch.where(dropped, ev - q, (a - q) * 0.9), ev - q)
    assert not torch.equal(dropped, (other - q) == 0)


def _polar_case(rate):
    """A tiny ++ ``PolarI2P`` (random weights, neck dropout ``rate``) with
    random maps on the widened views of one synthetic sample."""
    jax_cfg = _neck_dropout(jcfg.tiny_pp_config(), rate)
    cfg = _neck_dropout(tcfg.tiny_pp_config(), rate)
    ncfg = cfg.model.imgpts_neck
    rng = np.random.default_rng(5)
    np_batch = _wide_cameras(jax_batch(jax_cfg, b=1, seed=7), jax_cfg)
    c, v = ncfg.hidden_channel, cfg.data.num_views
    pts = rng.normal(size=(1, 16, 16, c)).astype(np.float32)
    img = rng.normal(size=(1, v, 8, 16, c)).astype(np.float32)
    args = (jax_cfg.model.imgpts_neck, cfg.model.pts_voxel_layer.point_cloud_range, cfg.data.padded_img_shape,
            ncfg.polar_radius_range, ncfg.polar_num_z_bins)
    jm = jfusion.PolarI2P(*args)
    init = jax.eval_shape(lambda p, i, b: jm.init(jax.random.PRNGKey(0), p, i, b), pts, img, np_batch)
    params = _randomize(init["params"], rng)
    port = load_flax(tfusion.PolarI2P(ncfg, *args[1:]), {"params": params})
    return jm, params, port, np_batch, pts, img, rng


def test_polar_i2p_grads_match_flax():
    """Train mode, dropout 0, float64: the map and weight gradients of the
    port's ``PolarI2P`` against ``jax.grad`` of the Flax module."""
    jm, params, port, np_batch, pts, img, rng = _polar_case(0.0)
    cot = rng.normal(size=pts.shape)
    keys = ("lidar2img", "img2lidar", "cam2lidar", "lidar_aug", "lidar_aug_inv")
    sub = {k: np_batch[k] for k in keys}

    def loss(pr, p, i, bt):
        return jnp.sum(jm.apply({"params": pr}, p, i, bt, train=True) * cot)

    with jax.enable_x64(True):
        pg, ptg, ig = _np(jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*_float64((params, pts, img, sub))))

    port = port.double()
    p, i = (torch.from_numpy(a.astype(np.float64)).requires_grad_(True) for a in (pts, img))
    batch = {k: torch.from_numpy(a.astype(np.float64)) for k, a in sub.items()}
    out = port(p, i, batch, train=True, generator=torch.Generator().manual_seed(0))
    assert np.abs(out.detach().numpy() - pts).max() > 1e-2  # the splat reached the map
    (out * torch.from_numpy(cot)).sum().backward()
    _assert_close_grads({"pts_map": p.grad, "img_map": i.grad}, {"pts_map": ptg, "img_map": ig}, "PolarI2P")
    _assert_close_grads({n: t.grad.detach() for n, t in port.named_parameters()}, grads_from_flax(pg, port),
                        "PolarI2P")


def test_polar_i2p_dropout_from_generator():
    """Dropout 0.1 on the decoder's attention weights and FFN in train mode,
    drawn from the caller's generator: one seed gives one output, another
    seed another; eval is the identity of dropout."""
    _, _, port, np_batch, pts, img, _ = _polar_case(0.1)
    batch = to_torch(np_batch, "cpu")
    p, i = torch.from_numpy(pts), torch.from_numpy(img)
    with torch.no_grad():
        a, a2, b = (port(p, i, batch, train=True, generator=torch.Generator().manual_seed(s)) for s in (1, 1, 2))
        ev = port(p, i, batch)
        for m in port.modules():
            if hasattr(m, "dropout"):
                m.dropout = 0.0
        nodrop = port(p, i, batch, train=True, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, a2)
    assert (a - b).abs().max() > 1e-3 and (a - ev).abs().max() > 1e-3
    torch.testing.assert_close(nodrop, ev, rtol=0, atol=0)


@pytest.fixture(scope="module")
def layer_inputs():
    """The tiny ++ model in train mode with neck dropout 0.1, and the
    arguments its first image and LiDAR layers received in one forward."""
    cfg = _neck_dropout(tcfg.tiny_pp_config(), 0.1)
    np_batch = _wide_cameras(jax_batch(jcfg.tiny_pp_config(), b=2, with_gt=True, seed=SEED), cfg)
    model = DeepInteraction(cfg.model, cfg.data.padded_img_shape)
    init_weights(model, seed=SEED)
    seen = {}
    neck = model.imgpts_neck
    hooks = [getattr(neck, f"{kind}_layer0").register_forward_pre_hook(
        lambda m, a, kind=kind: seen.setdefault(kind, a)) for kind in ("img", "pts")]
    with torch.no_grad():
        model(to_torch(np_batch, "cpu"), train=True, generator=torch.Generator().manual_seed(0))
    for h in hooks:
        h.remove()
    return neck, seen


def _layer_grads(layer, args, run):
    """Gradients of a fixed projection of ``run(layer, args)`` with respect
    to the layer's weights and its three map inputs."""
    args = list(args)
    for j in range(3):
        args[j] = args[j].detach().clone().requires_grad_(True)
    out = run(layer, args)
    cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(9))
    layer.zero_grad(set_to_none=True)
    (out * cot).sum().backward()
    grads = {n: p.grad.clone() for n, p in layer.named_parameters() if p.grad is not None}
    grads.update({f"input{j}": args[j].grad.clone() for j in range(3)})
    return grads


@pytest.mark.parametrize("kind", ["img", "pts"])
def test_recompute_keeps_dropout_masks(layer_inputs, kind, monkeypatch):
    """Through ``recomputed`` (checkpoint, the generator snapshotted and
    restored for the recompute; for the LiDAR layer with the pillar I2P's
    chunk checkpoints, 64 pillars a chunk, inside it) the gradients equal
    those of the layer called directly with the same generator and no
    checkpoint anywhere; the generator ends where the direct forward left
    it. A plain checkpoint redraws the masks and misses."""
    neck, seen = layer_inputs
    layer = getattr(neck, f"{kind}_layer0")
    args = seen[kind][:-2]  # without train and generator
    monkeypatch.setattr(mmri_encoder, "I2P_CHUNK", 64)
    gens = {}

    def through_neck(m, a):
        gens["neck"] = torch.Generator().manual_seed(11)
        return tfusion.recomputed(m, gens["neck"], *a)

    def naive(m, a):
        g = torch.Generator().manual_seed(11)
        return checkpoint(lambda *x: m(*x, True, g), *a, use_reentrant=False)

    got = _layer_grads(layer, args, through_neck)
    after_backward = gens["neck"].get_state()
    naive_grads = _layer_grads(layer, args, naive)
    with monkeypatch.context() as mp:
        mp.setattr(mmri_encoder, "checkpoint", lambda fn, *a, use_reentrant: fn(*a))

        def direct(m, a):
            gens["direct"] = torch.Generator().manual_seed(11)
            return m(*a, True, gens["direct"])

        want = _layer_grads(layer, args, direct)
    assert torch.equal(after_backward, gens["direct"].get_state())
    assert set(got) == set(want) and len(want) > 20
    for name in want:
        scale = want[name].abs().max().item()
        err = (got[name] - want[name]).abs().max().item()
        assert err <= RECOMPUTE_TOL * max(scale, 1e-30), f"{kind} {name}: {err:.3e} of scale {scale:.3e}"
    worst = max((naive_grads[n] - want[n]).abs().max().item() / want[n].abs().max().item()
                for n in want if want[n].abs().max() > 0)
    assert worst > 1e-2, worst

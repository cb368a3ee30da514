"""The port's fusion (DeepInteraction-base) train step against the JAX
package, on the CPU.

- One step of ``tiny_config`` at B=2, seed 3, against JAX
  ``make_train_step`` on the same weights and batch (dropout is 0 there, and
  with 2 views JAX's top-2-view I2P is the port's all-view I2P), both in
  float64: the Hungarian assignment of all four MMPI layers exactly, each
  loss term (``layer_{i}`` terms included) and ``grad_norm`` at rtol 1e-3,
  every gradient leaf through the bridge at 1e-3 of the leaf's scale, and
  the BN running statistics after the step at 1e-5. JAX's gradients are
  read back from Adam's first moment, as in
  ``tests/test_torch_port_train.py``. The port's float32 step is held to
  the same JAX step on the assignment and the losses.

  Why float64: each MMPI block's DynamicConv sends 16 x 49 x 64 LayerNorm
  outputs through a ReLU, and after the trunks and four blocks the forward
  carries about 1e-5 of relative fp32 rounding. A few of those ReLU inputs
  lie within it of 0 and take the other sign in one of the two fp32 runs,
  and one such flip moves whole weight gradients by 1-10 %. Every seed
  from 0 to 11 has some (the LiDAR-only step of
  ``tests/test_torch_port_train.py`` has a seed without). In float64 no
  input comes that close to 0; the card's step is compared with the CPU's
  in fp32 by replaying one run's ReLU masks (``chip_smoke.py``).
- The same config with ``freeze_img=freeze_pts=True``, the port's mirror of
  ``tests/test_train_step.py``: frozen leaves get no ``.grad``, their
  parameters and BN statistics are unchanged after the update, trainable
  ones move, and the losses equal JAX's (freezing changes no forward value,
  so they are the unfrozen JAX step's).
- ``train/checkpoint.py``: save after one step, restore, take a second step:
  equal to two uninterrupted steps; ``load_params`` keeps a fresh optimizer;
  ``publish`` writes every parameter and buffer.

The JAX step is compiled once for the module (the file's wall time is
mostly that compile).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from deepinteraction_tpu import configs as jcfg
from deepinteraction_tpu.models.detector import DeepInteraction as JaxDeepInteraction
from deepinteraction_tpu.ops import hungarian as jhung
from deepinteraction_tpu.train.step import create_train_state, make_train_step
from deepinteraction_tpu.utils.testing import fast_init_variables
from deepinteraction_tpu.utils.testing import make_synthetic_batch as jax_batch
from deepinteraction_tpu_torch import configs as tcfg
from deepinteraction_tpu_torch.convert import grads_from_flax, load_flax, params_from_flax
from deepinteraction_tpu_torch.models.detector import DeepInteraction
from deepinteraction_tpu_torch.train import checkpoint as ckpt
from deepinteraction_tpu_torch.train.step import TrainStep, is_frozen
from deepinteraction_tpu_torch.utils.synthetic import to_torch

torch.set_num_threads(1)

TOTAL_STEPS = 10
LOSS_RTOL = 1e-3
GRAD_TOL = 1e-3  # max|port - jax| / max|jax| per gradient leaf
STATS_TOL = 1e-5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: a.astype(np.float64) if a.dtype == np.float32 else a, _np(tree))


def _port_step(variables, np_batch, dtype, cfg=None):
    """The port on the same weights, and one step's backward in ``dtype``."""
    cfg = cfg or tcfg.tiny_config()
    port = _port_model(variables, cfg).to(dtype)
    step = TrainStep(cfg, port, TOTAL_STEPS, device="cpu")
    batch = {k: v.to(dtype) if v.is_floating_point() else v for k, v in to_torch(np_batch, "cpu").items()}
    metrics, targets = step.backward(batch, torch.Generator().manual_seed(0))
    return port, step, metrics, targets


def _frozen_cfg(cfg):
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, freeze_img=True, freeze_pts=True))


@pytest.fixture(scope="module")
def one_step():
    """One JAX ``make_train_step`` step in float64 and the port's steps in
    float64 and float32 on the same weights, with JAX's Hungarian outputs
    recorded."""
    cfg = jcfg.tiny_config()
    np_batch = jax_batch(cfg, b=2, with_gt=True, seed=3)
    model = JaxDeepInteraction(cfg.model, cfg.data.padded_img_shape)
    variables = _np(fast_init_variables(model, {k: jnp.asarray(v) for k, v in np_batch.items()}, seed=3))

    laps = []
    lap_host = jhung._lap_host

    def recording_lap(cost, num_gt):
        out = lap_host(cost, num_gt)
        laps.append(out)
        return out

    jhung._lap_host = recording_lap  # read when hungarian_assign is traced
    try:
        with jax.enable_x64(True):
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

    port, _, port_metrics, targets = _port_step(variables, np_batch, torch.float64)
    _, _, port32_metrics, targets32 = _port_step(variables, np_batch, torch.float32)
    port_grads = {n: p.grad.clone() if p.grad is not None else torch.zeros_like(p)
                  for n, p in port.named_parameters()}
    no_grad = [n for n, p in port.named_parameters() if p.grad is None]
    port_stats = {n: b.clone() for n, b in port.named_buffers()}
    return dict(laps=laps, metrics=metrics, new_state=new_state, jax_grads=jax_grads,
                variables=variables, np_batch=np_batch, port=port, port_metrics=port_metrics,
                targets=targets, port_grads=port_grads, no_grad=no_grad, port_stats=port_stats,
                port32_metrics=port32_metrics, targets32=targets32)


@pytest.mark.parametrize("bits", [64, 32])
def test_fusion_step_assignment_equals_jax(one_step, bits):
    assert len(one_step["laps"]) == 1
    want = one_step["laps"][0]  # [B, L, P]
    got = one_step["targets" if bits == 64 else "targets32"].assign.numpy()
    assert want.shape == got.shape == (2, 4, 8)
    assert (want >= 0).sum() > 0
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bits", [64, 32])
def test_fusion_step_losses_match_jax(one_step, bits):
    want, got = one_step["metrics"], one_step["port_metrics" if bits == 64 else "port32_metrics"]
    assert set(got) == set(want)
    assert {f"layer_{i}_loss_{t}" for i in range(4) for t in ("cls", "bbox")} < set(want)
    for k in sorted(want):
        assert np.isfinite(float(want[k])), k
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=LOSS_RTOL, err_msg=k)
    assert float(want["grad_norm"]) > 0


def test_fusion_step_gradients_match_jax(one_step):
    want = grads_from_flax(one_step["jax_grads"], one_step["port"])
    got = one_step["port_grads"]
    assert set(got) == set(want)
    # Leaves whose gradient is 0 in exact arithmetic (a bias a softmax over
    # keys or a train-mode BN cancels; the FPN levels and the LiDAR heatmap
    # head, which no loss reaches in the fusion model, hold no gradient in
    # the port at all) must be noise on both sides. JAX keeps I2P's products
    # in float32 even under x64, so the noise is float32's.
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
    assert set(one_step["no_grad"]) <= set(zeros)
    # 84 of 574 here: the k_proj biases, every fc0 bias before a train-mode
    # BN (6 heads x 5 prediction FFNs), FPN levels 1-3, the LiDAR heatmap head
    assert len(zeros) < 0.2 * len(want), zeros
    for prefix in ("imgpts_neck.layer0.i2p.", "imgpts_neck.layer0.p2i_local.", "pts_bbox_head.mmpi0_img.",
                   "pts_bbox_head.mmpi3_pts.", "img_backbone.", "pts_middle_encoder."):
        assert any(n.startswith(prefix) and n not in zeros for n in want), prefix


def test_fusion_step_batch_stats_match_jax(one_step):
    ns = one_step["new_state"]
    want = params_from_flax({"params": ns.params, "batch_stats": ns.batch_stats}, one_step["port"])
    got = one_step["port_stats"]
    assert len(got) > 100
    for name, t in got.items():
        np.testing.assert_allclose(t.numpy(), want[name].numpy().astype(np.float64), rtol=STATS_TOL,
                                   atol=STATS_TOL, err_msg=name)
    # the LiDAR heatmap head normalises in train mode too, though no loss
    # reaches it; every running statistic moved
    moved = sum(not torch.equal(t, torch.ones_like(t)) and not torch.equal(t, torch.zeros_like(t))
                for t in got.values())
    assert moved == len(got)


def _port_model(variables, cfg):
    model = DeepInteraction(cfg.model, cfg.data.padded_img_shape)
    return load_flax(model, variables)


def test_freeze_both_branches(one_step):
    cfg = _frozen_cfg(tcfg.tiny_config())
    model = _port_model(one_step["variables"], cfg)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    step = TrainStep(cfg, model, TOTAL_STEPS, device="cpu")
    metrics = step(to_torch(one_step["np_batch"], "cpu"), torch.Generator().manual_seed(0))
    want = one_step["metrics"]
    for k in sorted(want):
        if k != "grad_norm":  # freezing changes the gradients, not the forward
            np.testing.assert_allclose(float(metrics[k]), float(want[k]), rtol=LOSS_RTOL, err_msg=k)
    assert 0 < float(metrics["grad_norm"]) < float(want["grad_norm"])
    after = model.state_dict()
    frozen = [k for k in before if is_frozen(k.rsplit(".", 1)[0], step.frozen)]
    assert any(k.startswith("img_backbone.") and k.endswith("running_var") for k in frozen)
    assert any(k.startswith("pts_middle_encoder.") and k.endswith("running_mean") for k in frozen)
    for k in frozen:
        assert torch.equal(before[k], after[k]), k
    assert all(p.grad is None for n, p in model.named_parameters() if is_frozen(n, step.frozen))
    trainable = [n for n, p in model.named_parameters() if p.requires_grad]
    assert any(n.startswith("imgpts_neck.layer0.") for n in trainable)
    assert any(n.startswith("pts_bbox_head.mmpi") for n in trainable)
    assert not any(n.startswith(("img_backbone.", "pts_middle_encoder.", "pts_bbox_head.decoder0."))
                   for n in trainable)
    # a leaf moves unless its gradient is 0 and it is 0 (weight decay of 0)
    pulled = [n for n in trainable if model.get_parameter(n).grad.abs().max() > 0]
    assert len(pulled) > 0.9 * len(trainable)
    assert all(not torch.equal(before[n], after[n]) for n in pulled)


def _two_steps(model, cfg, batch, save_dir=None):
    """Two steps; with ``save_dir``, the second runs after a save and a
    restore into a fresh model and step."""
    step = TrainStep(cfg, model, TOTAL_STEPS, device="cpu")
    step(batch, torch.Generator().manual_seed(0))
    if save_dir is not None:
        ckpt.save_checkpoint(save_dir, step)
        model = _blank_model(cfg)
        step = TrainStep(cfg, model, TOTAL_STEPS, device="cpu")
        ckpt.restore_checkpoint(save_dir, step)
        assert step.step_count == 1
    metrics = step(batch, torch.Generator().manual_seed(1))
    return model, step, metrics


def _blank_model(cfg):
    fresh = DeepInteraction(cfg.model, cfg.data.padded_img_shape)
    for p in fresh.parameters():
        torch.nn.init.zeros_(p)
    return fresh


def test_checkpoint_resume_equals_uninterrupted(one_step, tmp_path):
    cfg = tcfg.tiny_config()
    batch = to_torch(one_step["np_batch"], "cpu")
    m_ref, _, ref = _two_steps(_port_model(one_step["variables"], cfg), cfg, batch)
    m_got, step, got = _two_steps(_port_model(one_step["variables"], cfg), cfg, batch, str(tmp_path / "run"))
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    sd_ref, sd_got = m_ref.state_dict(), m_got.state_dict()
    assert all(torch.equal(sd_got[k], sd_ref[k]) for k in sd_ref)
    assert step.step_count == 2

    # load_from: weights and statistics, a fresh optimizer at step 0
    fresh = _blank_model(cfg)
    loaded = TrainStep(cfg, fresh, TOTAL_STEPS, device="cpu")
    ckpt.load_params(str(tmp_path / "run"), loaded)
    assert loaded.step_count == 0 and not loaded.opt.state
    saved = ckpt.restore_checkpoint(str(tmp_path / "run"), TrainStep(cfg, _blank_model(cfg), TOTAL_STEPS,
                                                                    device="cpu"))
    assert all(torch.equal(fresh.state_dict()[k], saved.model.state_dict()[k]) for k in sd_ref)

    # publish: a flat .npz of every parameter and buffer
    out = ckpt.publish(str(tmp_path / "run"), str(tmp_path / "model.npz"))
    with np.load(out) as z:
        assert set(z.files) == set(sd_ref)
        for k in sd_ref:
            np.testing.assert_array_equal(z[k], saved.model.state_dict()[k].numpy())

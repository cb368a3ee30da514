"""The port's LiDAR-only (TransFusion-L) slice and its train-side ops against
the JAX package, on the CPU, on inputs made from numpy seeds.

- the port's configs copy equals the JAX package's (``dataclasses.asdict``);
- the ``tiny_lidar_config`` eval forward against the live JAX
  ``model.apply`` on the same weights (rtol 2e-3, atol 5e-4; labels exact);
- ``iou_3d``, ``gaussian_radius`` / ``draw_heatmap``, the coder's
  ``encode``, the losses and the host LAP against their JAX functions;
- the inverse neighbor tables (tap mirror and scatter) and K1's backward
  route (d/dfeat as the forward conv over the inverse table with W^T, d/dW
  tap-looped) against autograd of ``gathered_matmul``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepinteraction_tpu import configs as jcfg
from deepinteraction_tpu.models.detector import DeepInteraction as JaxDeepInteraction
from deepinteraction_tpu.ops import gaussian as jgauss
from deepinteraction_tpu.ops import hungarian as jhung
from deepinteraction_tpu.ops import rotated_iou as jiou
from deepinteraction_tpu.ops import sparse_conv as jsc
from deepinteraction_tpu.targets import losses as jloss
from deepinteraction_tpu.targets.coder import TransFusionBBoxCoder as JaxCoder
from deepinteraction_tpu.utils.testing import fast_init_variables
from deepinteraction_tpu.utils.testing import make_synthetic_batch as jax_batch
from deepinteraction_tpu_torch import configs as tcfg
from deepinteraction_tpu_torch.convert import load_flax
from deepinteraction_tpu_torch.inference import get_bboxes
from deepinteraction_tpu_torch.models.detector import DeepInteraction
from deepinteraction_tpu_torch.ops import gaussian as tgauss
from deepinteraction_tpu_torch.ops import hungarian as thung
from deepinteraction_tpu_torch.ops import rotated_iou as tiou
from deepinteraction_tpu_torch.ops import sparse_conv as tsc
from deepinteraction_tpu_torch.ops import subm_conv as tsm
from deepinteraction_tpu_torch.targets import losses as tloss
from deepinteraction_tpu_torch.targets.coder import TransFusionBBoxCoder
from deepinteraction_tpu_torch.utils.synthetic import to_torch

torch.set_num_threads(1)

RTOL, ATOL = 2e-3, 5e-4  # the golden fixtures' tolerance
SHAPE = (9, 48, 48)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("name", ["fusion_base_config", "tiny_config", "lidar_only_config", "tiny_lidar_config",
                                  "dryrun_config"])
def test_configs_copy_equals_jax(name):
    want, got = getattr(jcfg, name)(), getattr(tcfg, name)()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.model.pts_voxel_layer.grid_size == want.model.pts_voxel_layer.grid_size
    assert got.data.padded_img_shape == want.data.padded_img_shape


@pytest.mark.parametrize("impl", ["auction", "scipy"])
def test_lap_impl_other_than_callback_raises(impl):
    """``model.assigner.lap_impl`` takes JAX's two values: ``auction`` runs
    (on the CPU, the plain auction) and matches every GT of every sample;
    any other value is refused, not silently run as scipy."""
    from deepinteraction_tpu_torch.targets.assign import build_targets

    cfg = tcfg.apply_overrides(tcfg.tiny_lidar_config(), {"model.assigner.lap_impl": impl})
    assert cfg.model.assigner.lap_impl == impl
    m = cfg.model
    rng = np.random.default_rng(6)
    b, p, hb = 2, m.pts_bbox_head.num_proposals, 8
    preds = {k: _t(rng.normal(size=(b, p, n)).astype(np.float32))
             for k, n in (("center", 2), ("height", 1), ("dim", 3), ("rot", 2), ("vel", 2),
                          ("heatmap", m.pts_bbox_head.num_classes))}
    preds["center"] = preds["center"].abs() * hb / 2
    np_batch = jax_batch(jcfg.tiny_lidar_config(), b=b, with_gt=True, seed=6)
    gt = [_t(np_batch[k]) for k in ("gt_boxes", "gt_labels", "gt_mask")]
    if impl != "auction":
        with pytest.raises(ValueError, match=r"lap_impl='scipy': expected one of \('callback', 'auction'\)"):
            build_targets(preds, *gt, m.pts_bbox_head, m.bbox_coder, m.assigner, (hb, hb))
        return
    t = build_targets(preds, *gt, m.pts_bbox_head, m.bbox_coder, m.assigner, (hb, hb))
    assert t.assign.shape == (b, 1, p) and t.assign.dtype == torch.int32
    for i in range(b):
        got = t.assign[i, 0][t.assign[i, 0] >= 0]
        assert sorted(got.tolist()) == list(range(int(gt[2][i].sum()))) != []


@pytest.fixture(scope="module")
def lidar():
    """JAX apply of the tiny LiDAR-only detector at B=2 and the port on the
    same weights."""
    cfg = jcfg.tiny_lidar_config()
    np_batch = jax_batch(cfg, b=2, with_gt=True, seed=2)
    batch = {k: jnp.asarray(v) for k, v in np_batch.items()}
    model = JaxDeepInteraction(cfg.model, cfg.data.padded_img_shape)
    variables = fast_init_variables(model, batch, seed=2)
    preds = _np(jax.jit(lambda v, b: model.apply(v, b, False))(variables, batch))
    pcfg = tcfg.tiny_lidar_config()
    port = DeepInteraction(pcfg.model, pcfg.data.padded_img_shape)
    load_flax(port, _np(variables))
    return dict(cfg=pcfg, preds=preds, port=port, batch=to_torch(np_batch, "cpu"))


def test_lidar_eval_forward_matches_jax(lidar):
    got = lidar["port"](lidar["batch"])
    want = lidar["preds"]
    assert set(got) == set(want)
    assert got["on_image_masks"].shape == (0, 2, lidar["cfg"].model.pts_bbox_head.num_proposals)
    for k in sorted(want):
        g = got[k].numpy()
        if k in ("query_labels", "on_image_masks"):
            np.testing.assert_array_equal(g, want[k], err_msg=k)
        else:
            np.testing.assert_allclose(g, want[k], rtol=RTOL, atol=ATOL, err_msg=k)
    cfg = lidar["cfg"]
    det = get_bboxes(got, cfg.model.pts_bbox_head, cfg.model.bbox_coder, cfg.model.pts_bbox_head.num_proposals)
    assert torch.isfinite(det.boxes).all() and torch.isfinite(det.scores).all()


def _boxes(rng, n):
    b = np.zeros((n, 9), np.float32)
    b[:, :2] = rng.uniform(-6, 6, (n, 2))
    b[:, 2] = rng.uniform(-2, 0, n)
    b[:, 3:6] = rng.uniform(0.5, 4.0, (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    b[:, 7:] = rng.normal(size=(n, 2))
    return b


def test_iou_3d_matches_jax():
    rng = np.random.default_rng(11)
    a, b = _boxes(rng, 40), _boxes(rng, 12)
    b[:4] = a[:4]  # identical pairs: IoU 1
    b[4, :] = a[5]
    b[4, 6] += 0.3  # a rotated copy
    got = tiou.iou_3d(_t(a), _t(b)).numpy()
    want = np.asarray(jiou.iou_3d(jnp.asarray(a), jnp.asarray(b)))
    assert (want > 0.05).sum() >= 8
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_gaussian_heatmap_matches_jax():
    rng = np.random.default_rng(12)
    g = 9
    ln, w = rng.uniform(0.3, 6, g).astype(np.float32), rng.uniform(0.3, 6, g).astype(np.float32)
    r_want = np.asarray(jgauss.gaussian_radius((jnp.asarray(ln), jnp.asarray(w)), 0.1))
    r_got = tgauss.gaussian_radius((_t(ln), _t(w)), 0.1).numpy()
    np.testing.assert_allclose(r_got, r_want, rtol=1e-6)
    radii = np.maximum(2, r_want.astype(np.int32))
    centers = rng.uniform(0, 16, (g, 2)).astype(np.float32)
    labels = rng.integers(0, 10, g).astype(np.int32)
    labels[:3] = 4  # overlapping boxes of one class: per-pixel max
    mask = np.arange(g) < g - 2
    kw = dict(num_classes=10, height=16, width=16)
    want = np.asarray(jgauss.draw_heatmap(jnp.asarray(centers), jnp.asarray(radii), jnp.asarray(labels),
                                          jnp.asarray(mask), **kw))
    got = tgauss.draw_heatmap(_t(centers), _t(radii), _t(labels), _t(mask), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_encode_and_losses_match_jax():
    rng = np.random.default_rng(13)
    ccfg = jcfg.tiny_lidar_config().model.bbox_coder
    boxes = _boxes(rng, 16)
    np.testing.assert_allclose(TransFusionBBoxCoder(ccfg).encode(_t(boxes)).numpy(),
                               np.asarray(JaxCoder(ccfg).encode(jnp.asarray(boxes))), rtol=1e-6, atol=1e-6)
    logits = rng.normal(scale=3, size=(2, 8, 10)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 8)).astype(np.int32)
    weights = rng.uniform(size=(2, 8)).astype(np.float32)
    args = (jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(weights), jnp.asarray(5.0))
    np.testing.assert_allclose(tloss.sigmoid_focal_loss(_t(logits), _t(labels), _t(weights), torch.tensor(5.0)).item(),
                               float(jloss.sigmoid_focal_loss(*args)), rtol=1e-6)
    pred = tloss.clip_sigmoid(_t(logits)).numpy()
    np.testing.assert_allclose(pred, np.asarray(jloss.clip_sigmoid(jnp.asarray(logits))), rtol=1e-6)
    target = rng.uniform(size=pred.shape).astype(np.float32)
    target[0, :3, 1] = 1.0
    np.testing.assert_allclose(
        tloss.gaussian_focal_loss(_t(pred), _t(target), torch.tensor(3.0)).item(),
        float(jloss.gaussian_focal_loss(jnp.asarray(pred), jnp.asarray(target), jnp.asarray(3.0))), rtol=1e-5)
    reg, tgt, w = (rng.normal(size=(2, 8, 10)).astype(np.float32) for _ in range(3))
    np.testing.assert_allclose(
        tloss.weighted_l1_loss(_t(reg), _t(tgt), _t(w), torch.tensor(0.0)).item(),
        float(jloss.weighted_l1_loss(jnp.asarray(reg), jnp.asarray(tgt), jnp.asarray(w), jnp.asarray(0.0))),
        rtol=1e-5)


def test_lap_host_matches_jax():
    rng = np.random.default_rng(14)
    cost = rng.uniform(size=(2, 1, 8, 6)).astype(np.float32)
    num_gt = np.array([[5], [0]], np.int32)
    want = jhung._lap_host(cost, num_gt)
    np.testing.assert_array_equal(thung.lap_host(cost, num_gt), want)
    np.testing.assert_array_equal(thung.hungarian_assign(_t(cost), _t(num_gt)).numpy(), want)
    assert (want[0, 0] >= 0).sum() == 5 and (want[1] == -1).all()


def _sparse(rng, n_active, capacity, c):
    ids = np.sort(rng.permutation(np.prod(SHAPE))[:n_active])
    coords = np.stack([ids // (SHAPE[1] * SHAPE[2]), (ids // SHAPE[2]) % SHAPE[1], ids % SHAPE[2]], 1)
    coords = np.concatenate([coords, np.zeros((capacity - n_active, 3))]).astype(np.int32)
    feats = rng.normal(size=(capacity, c)).astype(np.float32)
    valid = np.arange(capacity) < n_active
    feats[~valid] = 0
    return tsc.SparseTensor(_t(feats), _t(coords), _t(valid), SHAPE)


def _brute_inverse(nbr, k_in):
    inv = np.full((k_in, nbr.shape[1]), nbr.shape[0], np.int32)
    for i, d in zip(*np.nonzero(nbr < k_in)):
        assert inv[nbr[i, d], d] == nbr.shape[0], "an input row reached twice at one tap"
        inv[nbr[i, d], d] = i
    return inv


def test_inverse_tables_exact():
    rng = np.random.default_rng(15)
    st = _sparse(rng, 1500, 1600, 4)  # about 2.5 of 27 taps hit per row
    nbr = tsc.subm_neighbor_table(st)
    assert (nbr < 1600).float().mean() > 0.05
    want = _brute_inverse(nbr.numpy(), 1600)
    np.testing.assert_array_equal(tsc.mirror_table(nbr).numpy(), want)
    np.testing.assert_array_equal(tsc.inverse_table(nbr, 1600).numpy(), want)
    for kernel, stride, pad, cap in [((3, 3, 3), (2, 2, 2), (1, 1, 1), 900), ((3, 1, 1), (2, 1, 1), (0, 0, 0), 1600)]:
        oc, ov, _ = tsc.downsample_sites(st.coords, st.valid, SHAPE, kernel, stride, pad, cap)
        snbr = tsc.strided_neighbor_table(st, oc, ov, kernel, stride, pad)
        # the port's strided table is the JAX package's
        jst = jsc.SparseTensor(*(jnp.asarray(a.numpy()) for a in st[:3]), SHAPE)
        np.testing.assert_array_equal(
            snbr.numpy(), np.asarray(jsc.strided_neighbor_table(jst, jnp.asarray(oc.numpy()), jnp.asarray(ov.numpy()),
                                                                kernel, stride, pad)))
        np.testing.assert_array_equal(tsc.inverse_table(snbr, 1600).numpy(), _brute_inverse(snbr.numpy(), 1600))


@pytest.mark.parametrize("route", ["mirror", "scatter", "strided"])
def test_k1_backward_route_matches_autograd(route):
    rng = np.random.default_rng(16)
    st = _sparse(rng, 700, 800, 8)
    cout = 12
    if route == "strided":
        oc, ov, _ = tsc.downsample_sites(st.coords, st.valid, SHAPE, (3, 3, 3), (2, 2, 2), (1, 1, 1), 300)
        nbr = tsc.strided_neighbor_table(st, oc, ov, (3, 3, 3), (2, 2, 2), (1, 1, 1))
        valid_out = ov
        inv = tsc.inverse_table(nbr, 800)
    else:
        nbr = tsc.subm_neighbor_table(st)
        valid_out = st.valid
        inv = tsc.mirror_table(nbr) if route == "mirror" else tsc.inverse_table(nbr, 800)
    feats = st.features.clone().requires_grad_(True)
    w = (torch.randn(27, 8, cout, generator=torch.Generator().manual_seed(0)) * 0.2).requires_grad_(True)
    r = torch.from_numpy(rng.normal(size=(nbr.shape[0], cout)).astype(np.float32))
    (tsm.gathered_matmul(feats, nbr, w, valid_out) * r).sum().backward()
    dy = torch.where(valid_out[:, None], r, torch.zeros(()))
    dfeat = tsm.subm_conv_dgrad(dy, inv, w.detach())
    dw = tsm.subm_conv_wgrad(feats.detach(), nbr, dy)
    for got, want in ((dfeat, feats.grad), (dw, w.grad)):
        assert want.abs().max() > 0
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.parametrize("strided", [False, True])
def test_k1_autograd_function_matches_plain_autograd(strided):
    """``subm_conv_gemm``'s autograd.Function (the route the card runs, here
    on the plain versions) against autograd of ``gathered_matmul``."""
    rng = np.random.default_rng(17)
    st = _sparse(rng, 700, 800, 5)
    if strided:
        oc, valid_out, _ = tsc.downsample_sites(st.coords, st.valid, SHAPE, (3, 3, 3), (2, 2, 2), (1, 1, 1), 300)
        nbr = tsc.strided_neighbor_table(st, oc, valid_out, (3, 3, 3), (2, 2, 2), (1, 1, 1))
        inv = tsc.inverse_table(nbr, 800)
    else:
        nbr, valid_out = tsc.subm_neighbor_table(st), st.valid
        inv = tsc.mirror_table(nbr)
    w0 = torch.from_numpy(rng.normal(scale=0.2, size=(27, 5, 16)).astype(np.float32))
    r = torch.from_numpy(rng.normal(size=(nbr.shape[0], 16)).astype(np.float32))
    grads = []
    for fn in (lambda f, w: tsm.subm_conv_gemm(f, nbr, w, valid_out, inv),
               lambda f, w: tsm.gathered_matmul(f, nbr, w, valid_out)):
        f, w = st.features.clone().requires_grad_(True), w0.clone().requires_grad_(True)
        (fn(f, w) * r).sum().backward()
        grads.append((f.grad, w.grad))
    for got, want in zip(*grads):
        assert want.abs().max() > 0
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()

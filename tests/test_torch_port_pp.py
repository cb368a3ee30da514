"""The PyTorch port of DeepInteraction++ (``fusion_plusplus``) against the
JAX package, on the CPU.

- The config functions equal JAX's field for field.
- ``SwinTransformer`` at a small width on an image whose stage sizes are
  not multiples of the window (padding and the shifted mask), and
  ``MSDeformableAttention`` with samples off the map (zero padding), each
  against its Flax module with random weights at 1e-4.
- The whole ``tiny_pp_config`` eval forward against the live JAX
  ``model.apply`` on every head (rtol 2e-3, atol 5e-4; labels and on-image
  masks exactly), and ``PolarI2P``, ``FusionTransformerPP`` and the V2
  decoder each fed the inputs its Flax module saw inside that JAX forward,
  at 1e-4. Both packages' I2P and BEVWarp run at their shipped view
  settings (two views a pillar and a point) and in their all-view form
  (patching the ``MMRI_I2P`` the JAX neck binds, and ``DI_I2P_VIEWS`` /
  ``DI_WARP_VIEWS``); with each, two cases:
  the Flax init's weights (the init program ``tests/test_golden_regression.py``
  compiles, so the compile cache is shared) on the synthetic batch, whose
  narrow views see too few queries for an image block to refine any; and
  seeded random weights on views widened and rolled, where the image
  blocks, the broadcast self term, the cumulative masks and the polar
  I2P's mean over z-bins at different image columns all take effect (the
  test asserts the first three).
- ``params_from_flax`` maps the full ``fusion_plusplus`` variable tree.

The ++ train step is ``tests/test_torch_port_pp_train.py``'s.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepinteraction_tpu.models.fusion_transformer as jfusion
from deepinteraction_tpu.configs import fusion_plusplus_config as jax_fusion_plusplus_config
from deepinteraction_tpu.configs import tiny_pp_config as jax_tiny_pp_config
from deepinteraction_tpu.models.detector import DeepInteraction as JaxDeepInteraction
from deepinteraction_tpu.models.swin import SwinTransformer as JaxSwin
from deepinteraction_tpu.ops.deform_attn import MSDeformableAttention as JaxMSDA
from deepinteraction_tpu.utils.testing import fast_init_variables
from deepinteraction_tpu.utils.testing import make_synthetic_batch as jax_batch
from deepinteraction_tpu_torch.configs import fusion_plusplus_config, tiny_pp_config
from deepinteraction_tpu_torch.convert import flax_leaf_shapes, load_flax, params_from_flax
from deepinteraction_tpu_torch.inference import get_bboxes
from deepinteraction_tpu_torch.models.decoder import Decoder
from deepinteraction_tpu_torch.models.detector import DeepInteraction
from deepinteraction_tpu_torch.models.fusion_transformer import PolarI2P
from deepinteraction_tpu_torch.models.layers import DropPath
from deepinteraction_tpu_torch.models.swin import SwinTransformer
from deepinteraction_tpu_torch.ops.deform_attn import MSDeformableAttention
from deepinteraction_tpu_torch.ops.voxelize import voxelize_batched
from deepinteraction_tpu_torch.utils.synthetic import to_torch

torch.set_num_threads(1)

RTOL, ATOL = 2e-3, 5e-4  # the golden fixtures' tolerance
MOD_TOL = 1e-4
EXACT = ("query_labels", "on_image_masks")
CAPTURED = ("img_neck", "pts_neck", "imgpts_neck", "norm0", "multi_scale_conv_img", "polar_i2p")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _sub(variables, *path):
    """The variables of the Flax submodule at ``path`` (every collection)."""
    out = {}
    for col, tree in variables.items():
        for name in path:
            tree = tree.get(name) if tree is not None else None
        if tree is not None:
            out[col] = tree
    return out


def _t(a):
    return torch.from_numpy(np.array(a))


def _randomize(params, rng, std=None):
    """Random weights in place of an init: LayerNorm scales near 1, every
    other leaf normal with std ``std`` or 1/sqrt(fan_in)."""
    def fill(path, a):
        name = str(path[-1]).lower()
        if "scale" in name:
            return (1.0 + 0.1 * rng.normal(size=a.shape)).astype(np.float32)
        fan_in = int(np.prod(a.shape[:-1])) if a.ndim >= 2 else 16
        s = std if std is not None else 1.0 / np.sqrt(fan_in)
        if "rel_pos_bias" in name:
            s = 0.5
        return rng.normal(scale=s, size=a.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, params)


@pytest.mark.parametrize("name", ["fusion_plusplus_config", "tiny_pp_config"])
def test_configs_equal_jax(name):
    jax_fn = {"fusion_plusplus_config": jax_fusion_plusplus_config, "tiny_pp_config": jax_tiny_pp_config}[name]
    port_fn = {"fusion_plusplus_config": fusion_plusplus_config, "tiny_pp_config": tiny_pp_config}[name]
    assert dataclasses.asdict(port_fn()) == dataclasses.asdict(jax_fn())


def test_swin_matches_flax():
    """Embed 24, depths (2, 2), heads (2, 4), window 7, on 2 images of
    40x52: stage 0 is 10x13 (padded to 14x14, its second block shifted),
    stage 1 is 5x7 after the odd-width merge (padded to 7x7)."""
    rng = np.random.default_rng(0)
    kw = dict(embed_dims=24, depths=(2, 2), num_heads=(2, 4), window_size=7, out_indices=(0, 1))
    x = rng.normal(size=(2, 40, 52, 3)).astype(np.float32)
    jm = JaxSwin(**kw)
    params = _randomize(jax.eval_shape(lambda x: jm.init(jax.random.PRNGKey(0), x), x)["params"], rng)
    want = jax.jit(lambda p, x: jm.apply({"params": p}, x))(params, x)
    port = SwinTransformer(**kw).eval()
    load_flax(port, {"params": params})
    assert port.out_channels == (24, 48)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert [tuple(g.shape) for g in got] == [(2, 10, 13, 24), (2, 5, 7, 48)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=MOD_TOL, atol=MOD_TOL)


def test_msda_matches_flax():
    """2 levels, 4 points, 4 heads, with random weights whose offsets send
    part of the samples off the map (zero padding)."""
    rng = np.random.default_rng(4)
    b, nq, c, h, l, p = 2, 30, 32, 4, 2, 4
    shapes = [(6, 9), (3, 5)]
    query = rng.normal(size=(b, nq, c)).astype(np.float32)
    value = rng.normal(size=(b, sum(hh * ww for hh, ww in shapes), c)).astype(np.float32)
    ref = rng.uniform(0.0, 1.0, size=(b, nq, l, 2)).astype(np.float32)
    jm = JaxMSDA(c, h, l, p, dropout=0.0)
    init = jax.eval_shape(lambda q, v, r: jm.init(jax.random.PRNGKey(0), q, v, r, shapes), query, value, ref)
    params = _randomize(init["params"], rng, std=0.3)
    want = jax.jit(lambda pr, q, v, r: jm.apply({"params": pr}, q, v, r, shapes))(params, query, value, ref)
    port = MSDeformableAttention(c, h, l, p, dropout=0.0).eval()
    load_flax(port, {"params": params})
    with torch.no_grad():
        got = port(*map(torch.from_numpy, (query, value, ref)), shapes)
        off = port.sampling_offsets(torch.from_numpy(query)).reshape(b, nq, h, l, p, 2)
        wh = torch.tensor([[ww, hh] for hh, ww in shapes], dtype=torch.float32)
        loc = torch.from_numpy(ref)[:, :, None, :, None, :] + off / wh[:, None, :]
    off_map = ((loc < 0) | (loc > 1)).any(-1).float().mean().item()
    assert 0.1 < off_map < 0.9, off_map
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=MOD_TOL, atol=MOD_TOL)


@pytest.mark.parametrize("rate", [0.0, 0.5])
def test_drop_path(rate):
    """Eval: the identity. Train: each sample's branch kept whole (scaled by
    1 / (1 - rate)) or dropped whole, drawn from the caller's generator."""
    x = torch.randn(64, 3, 5, 4)
    dp = DropPath(rate)
    assert torch.equal(dp(x), x)
    a = dp(x, True, torch.Generator().manual_seed(1))
    assert torch.equal(a, dp(x, True, torch.Generator().manual_seed(1)))
    kept = (a != 0).flatten(1).any(1)
    torch.testing.assert_close(a[kept], x[kept] / (1.0 - rate), rtol=0, atol=0)
    assert not a[~kept].any()
    assert int(kept.sum()) == 64 if rate == 0.0 else 16 < int(kept.sum()) < 48


def _wide_cameras(np_batch, cfg, focal_frac=0.1, roll=0.15):
    """The synthetic batch's views with a wider field of view (focal
    ``focal_frac`` * width) and rolled by ``roll`` rad about their optical
    axes, so that the tiny model's queries land on the images and the polar
    I2P's z-bins project to different image columns."""
    out = dict(np_batch)
    h, w = cfg.data.padded_img_shape
    l2i = np.zeros_like(np_batch["lidar2img"])
    cr, sr = np.cos(roll), np.sin(roll)
    rolled = np.array([[cr, -sr, 0, 0], [sr, cr, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)
    for i in range(cfg.data.num_views):
        intr = np.eye(4, dtype=np.float32)
        intr[0, 0] = intr[1, 1] = focal_frac * w
        intr[0, 2], intr[1, 2] = w / 2, h / 2
        c, s = np.cos(2.0 * np.pi * i / cfg.data.num_views), np.sin(2.0 * np.pi * i / cfg.data.num_views)
        rot = np.eye(4, dtype=np.float32)
        rot[0, :3], rot[1, :3], rot[2, :3] = (s, -c, 0.0), (0.0, 0.0, -1.0), (c, s, 0.0)
        l2i[:, i] = intr @ rolled @ rot
    out.update(lidar2img=l2i, img2lidar=np.linalg.inv(l2i),
               cam2lidar=np.linalg.inv(l2i.astype(np.float64)).astype(np.float32))
    return out


@pytest.fixture(scope="module")
def jax_pp():
    """The tiny ++ JAX detector, its init (the golden test's program), the
    synthetic batch, and a jitted apply for each view setting that captures
    the module outputs the module tests feed (traced by its first call,
    under its setting)."""
    cfg = jax_tiny_pp_config()
    np_batch = jax_batch(cfg, b=1, with_gt=True, seed=7)
    model = JaxDeepInteraction(cfg.model, cfg.data.padded_img_shape)
    variables = jax.jit(lambda r, b: model.init(r, b, False))(
        jax.random.PRNGKey(7), {k: jnp.asarray(v) for k, v in np_batch.items()})
    applies = {views: jax.jit(lambda v, b: model.apply(
        v, b, False, mutable=["intermediates"],
        capture_intermediates=lambda m, n: m.name in CAPTURED and n == "__call__",
    )) for views in ("shipped", "all")}
    return cfg, model, np_batch, variables, applies


@pytest.fixture(scope="module", params=[("init", "shipped"), ("init", "all"), ("wide", "shipped"), ("wide", "all")],
                ids=lambda p: "-".join(p))
def tiny_pp(request, jax_pp):
    """JAX and the port on one case: ``init``, the Flax init's weights on
    the synthetic batch (whose narrow views see few queries); ``wide``, the
    ``fast_init_variables`` weights (the port's ``init_weights``) on the
    batch with :func:`_wide_cameras`, where queries land on the images,
    move between the MMPI layers and leave them. Both packages' I2P and
    BEVWarp at their shipped view settings (``shipped``: two views a
    pillar and a point) or over every view (``all``: JAX's ``n_views`` 0
    through a subclass of the ``MMRI_I2P`` its neck binds, and
    ``DI_I2P_VIEWS=0`` / ``DI_WARP_VIEWS=0``, which the port reads when it
    is built), each with its own jitted apply."""
    (case, views), (cfg, model, np_batch, variables, applies) = request.param, jax_pp
    if case == "wide":
        np_batch = _wide_cameras(np_batch, cfg)
        variables = fast_init_variables(model, {k: jnp.asarray(v) for k, v in np_batch.items()}, seed=7)

    class AllViewsI2P(jfusion.MMRI_I2P):
        n_views: int = 0

    with pytest.MonkeyPatch.context() as mp:
        if views == "all":
            mp.setattr(jfusion, "MMRI_I2P", AllViewsI2P)
            mp.setenv("DI_I2P_VIEWS", "0")
            mp.setenv("DI_WARP_VIEWS", "0")
        else:
            mp.delenv("DI_I2P_VIEWS", raising=False)
            mp.delenv("DI_WARP_VIEWS", raising=False)
            assert jfusion.MMRI_I2P.n_views == 2
        preds, state = applies[views](variables, {k: jnp.asarray(v) for k, v in np_batch.items()})
        port = DeepInteraction(cfg.model, cfg.data.padded_img_shape).eval()
    assert port.levers.i2p_views == port.levers.warp_views == (2 if views == "shipped" else 0)
    inter = _np(state["intermediates"])

    load_flax(port, _np(variables))
    tb = to_torch(np_batch, "cpu")
    return dict(case=case, cfg=cfg, variables=_np(variables), preds=_np(preds), inter=inter,
                port=port, batch=tb, port_preds=port(tb))


def _assert_heads(got, want, rtol=RTOL, atol=ATOL):
    assert set(got) == set(want)
    for k in sorted(want):
        g = got[k].numpy()
        if k in EXACT:
            np.testing.assert_array_equal(g, want[k], err_msg=k)
        else:
            np.testing.assert_allclose(g, want[k], rtol=rtol, atol=atol, err_msg=k)


def _mmri_batch(cfg, batch):
    pl = cfg.model.pts_pillar_layer
    po = voxelize_batched(
        batch["points"], batch["points_mask"], voxel_size=pl.voxel_size,
        point_cloud_range=pl.point_cloud_range, max_num_points=pl.max_num_points,
        max_voxels=pl.max_voxels[1],
    )
    out = dict(batch)
    out.update(pillars=po.voxels, pillar_counts=po.num_points, pillar_coords=po.coords,
               pillar_valid=torch.arange(pl.max_voxels[1])[None] < po.num_voxels[:, None])
    return out


def test_tiny_pp_forward_matches_jax(tiny_pp):
    preds = tiny_pp["port_preds"]
    cfg = tiny_pp["cfg"]
    assert preds["on_image_masks"].shape == (cfg.model.pts_bbox_head.num_mmpi, 1, cfg.model.pts_bbox_head.num_proposals)
    _assert_heads(preds, tiny_pp["preds"])
    det = get_bboxes(preds, cfg.model.pts_bbox_head, cfg.model.bbox_coder, cfg.model.pts_bbox_head.num_proposals)
    assert torch.isfinite(det.boxes).all() and torch.isfinite(det.scores).all()


def test_fusion_transformer_pp_matches_flax(tiny_pp):
    cfg, inter = tiny_pp["cfg"], tiny_pp["inter"]
    b, v = 1, cfg.data.num_views
    levels = [_t(f) for f in inter["img_neck"]["__call__"][0][:2]]
    img = [f.reshape(b, v, *f.shape[1:]) for f in levels]
    pts = [_t(f) for f in inter["pts_neck"]["__call__"][0]]
    with torch.no_grad():
        new_img, (pts_conv, new_pts) = tiny_pp["port"].imgpts_neck(img, pts, _mmri_batch(cfg, tiny_pp["batch"]))
    want_img, (want_conv, want_pts) = inter["imgpts_neck"]["__call__"][0]
    for g, w in ((new_img, want_img), (pts_conv, want_conv), (new_pts, want_pts)):
        np.testing.assert_allclose(g.numpy(), w, rtol=MOD_TOL, atol=MOD_TOL)


def test_polar_i2p_matches_flax(tiny_pp):
    cfg, inter = tiny_pp["cfg"], tiny_pp["inter"]
    ncfg = cfg.model.imgpts_neck
    neck = inter["imgpts_neck"]
    img0 = _t(neck["multi_scale_conv_img"]["__call__"][0])  # level 0, the layer's image map
    img = img0.reshape(1, cfg.data.num_views, *img0.shape[1:])
    qm = _t(neck["pts_layer0"]["norm0"]["__call__"][0])
    hb = int(round(qm.shape[1] ** 0.5))
    qm = qm.reshape(1, hb, hb, -1)
    port = PolarI2P(ncfg, cfg.model.pts_voxel_layer.point_cloud_range, cfg.data.padded_img_shape,
                    ncfg.polar_radius_range, ncfg.polar_num_z_bins).eval()
    load_flax(port, _sub(tiny_pp["variables"], "imgpts_neck", "pts_layer0", "polar_i2p"))
    with torch.no_grad():
        got = port(qm, img, tiny_pp["batch"])
    want = neck["pts_layer0"]["polar_i2p"]["__call__"][0]
    assert np.abs(want - qm.numpy()).max() > 1e-2  # the splat reached the map
    np.testing.assert_allclose(got.numpy(), want, rtol=MOD_TOL, atol=MOD_TOL)


def test_v2_decoder_matches_flax(tiny_pp):
    """num_mmpi=4: both block kinds, the look-forward over four layers and
    the inherited masks."""
    cfg, inter = tiny_pp["cfg"], tiny_pp["inter"]
    assert cfg.model.pts_bbox_head.num_mmpi == 4
    dec = Decoder(cfg.model.pts_bbox_head, cfg.model.bbox_coder, cfg.data.padded_img_shape).eval()
    load_flax(dec, _sub(tiny_pp["variables"], "pts_bbox_head"))
    new_img, (pts_conv, new_pts) = jax.tree_util.tree_map(_t, inter["imgpts_neck"]["__call__"][0])
    eff = {}
    for i in (0, 2):
        getattr(dec, f"mmpi{i}_img").register_forward_hook(lambda m, a, o, i=i: eff.__setitem__(i, o[1][0]))
    with torch.no_grad():
        got = dec((pts_conv, new_pts), new_img, _mmri_batch(cfg, tiny_pp["batch"]))
    _assert_heads(got, tiny_pp["preds"], rtol=MOD_TOL, atol=MOD_TOL)
    masks = got["on_image_masks"][:, 0]
    assert torch.equal(masks[1], masks[0]) and torch.equal(masks[3], masks[2])  # odd layers inherit
    assert not (masks[2] & ~masks[0]).any()  # cumulative
    if tiny_pp["case"] == "wide":
        # the paths are exercised: queries on and off the images, a view
        # with several on-image queries (so the first one's self branch is
        # broadcast), and a query on an image at layer 2 but not at layer 0
        # (so the cumulative AND decides)
        assert 0 < int(masks[0].sum()) < len(masks[0])
        views = eff[0][eff[0] >= 0]
        assert int(torch.bincount(views).max()) >= 2
        assert bool(((eff[2] >= 0) & (eff[0] < 0)).any())


def test_full_pp_variables_convert():
    """``params_from_flax`` maps every leaf of the full fusion_plusplus
    variable tree (shapes from an abstract trace of JAX's init) onto the
    port, with nothing missing, unused or mis-shaped."""
    cfg = jax_fusion_plusplus_config()
    model = JaxDeepInteraction(cfg.model, cfg.data.padded_img_shape)
    shapes = jax.eval_shape(lambda b: model.init(jax.random.PRNGKey(0), b, False),
                            jax_batch(cfg, b=1, seed=0))
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    pcfg = fusion_plusplus_config()
    with torch.device("meta"):
        port = DeepInteraction(pcfg.model, pcfg.data.padded_img_shape, pcfg.test_num_proposals)
    assert flax_leaf_shapes(port) == flat
    sd = params_from_flax({p: np.broadcast_to(np.float32(0), s) for p, s in flat.items()}, port)
    assert set(sd) == set(port.state_dict())
    assert flat["params/img_backbone/stage2_block5/attn/rel_pos_bias"] == (169, 12)
    assert flat["params/imgpts_neck/pts_layer1/polar_i2p/dec_ffn/fc0/kernel"] == (128, 512)
    assert flat["params/pts_bbox_head/mmpi3_pred/center/fc0/kernel"] == (128, 64)

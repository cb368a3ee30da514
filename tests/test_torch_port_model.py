"""The PyTorch port's modules and its whole eval slice against the JAX
package, on the CPU.

- The whole slice on ``tiny_config``: the JAX programs are the very ones
  ``tests/test_golden_regression.py`` compiles (so the persistent compile
  cache is shared), the weights cross the bridge, and every output head is
  compared elementwise (rtol 2e-3, atol 5e-4; labels and on-image masks
  exactly), then replayed through the ``golden_v1.npz`` digest.
- The sparse encoder, the MMRI encoder and the decoder at tiny width, each
  fed the inputs its Flax module saw inside the same JAX forward.
- The MMRI encoder at 6 views against JAX, at JAX's default top-2-view
  settings and in its all-view form, with a pillar whose points reach a
  third view.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepinteraction_tpu.configs import tiny_config
from deepinteraction_tpu.models.detector import DeepInteraction as JaxDeepInteraction
from deepinteraction_tpu.models.mmri_encoder import MMRIEncoder as JaxMMRIEncoder
from deepinteraction_tpu.utils.testing import make_synthetic_batch as jax_batch
from deepinteraction_tpu_torch.convert import load_flax
from deepinteraction_tpu_torch.inference import get_bboxes
from deepinteraction_tpu_torch.models.decoder import Decoder
from deepinteraction_tpu_torch.models.detector import DeepInteraction
from deepinteraction_tpu_torch.models.mmri_encoder import MMRIEncoder
from deepinteraction_tpu_torch.models.sparse_encoder import SparseEncoder
from deepinteraction_tpu_torch.ops.voxelize import hard_simple_vfe, voxelize_batched
from deepinteraction_tpu_torch.utils.synthetic import to_torch

from test_golden_regression import FIXTURE_DIR, _digest

torch.set_num_threads(1)

RTOL, ATOL = 2e-3, 5e-4  # the golden fixtures' tolerance
EXACT = ("query_labels", "on_image_masks")
CAPTURED = ("img_neck", "pts_middle_encoder", "pts_neck", "imgpts_neck")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _sub(variables, name):
    return {c: v[name] for c, v in variables.items() if name in v}


@pytest.fixture(scope="module")
def tiny():
    """JAX init + apply of the v1 tiny detector (the golden test's
    programs), its captured module outputs, and the port on the same
    weights."""
    cfg = tiny_config()
    np_batch = jax_batch(cfg, b=1, with_gt=True, seed=7)
    batch = {k: jnp.asarray(v) for k, v in np_batch.items()}
    model = JaxDeepInteraction(cfg.model, cfg.data.padded_img_shape)
    variables = jax.jit(lambda r, b: model.init(r, b, False))(jax.random.PRNGKey(7), batch)
    preds = jax.jit(lambda v, b: model.apply(v, b, False))(variables, batch)
    _, state = jax.jit(
        lambda v, b: model.apply(
            v, b, False, mutable=["intermediates"],
            capture_intermediates=lambda m, n: m.name in CAPTURED and n == "__call__",
        )
    )(variables, batch)
    inter = {k: _np(v["__call__"][0]) for k, v in state["intermediates"].items()}

    port = DeepInteraction(cfg.model, cfg.data.padded_img_shape).eval()
    load_flax(port, _np(variables))
    tb = to_torch(np_batch, "cpu")
    return dict(cfg=cfg, variables=_np(variables), preds=_np(preds), inter=inter,
                port=port, batch=tb, port_preds=port(tb))


def _assert_heads(got, want, rtol=RTOL, atol=ATOL):
    assert set(got) == set(want)
    for k in sorted(want):
        g = got[k].numpy()
        if k in EXACT:
            np.testing.assert_array_equal(g, want[k], err_msg=k)
        else:
            np.testing.assert_allclose(g, want[k], rtol=rtol, atol=atol, err_msg=k)


def test_slice_matches_jax(tiny):
    _assert_heads(tiny["port_preds"], tiny["preds"])
    cfg = tiny["cfg"]
    det = get_bboxes(tiny["port_preds"], cfg.model.pts_bbox_head, cfg.model.bbox_coder,
                     cfg.test_num_proposals)
    assert det.boxes.shape == (1, cfg.test_num_proposals, 9)
    assert torch.isfinite(det.boxes).all() and torch.isfinite(det.scores).all()


def test_slice_replays_golden_v1(tiny):
    want = np.load(f"{FIXTURE_DIR}/golden_v1.npz")
    got = _digest({k: v.numpy() for k, v in tiny["port_preds"].items()})
    assert set(want.files) == set(got)
    for k in want.files:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL, err_msg=k)


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


def test_sparse_encoder_matches_flax(tiny):
    cfg, inter = tiny["cfg"], tiny["inter"]
    vl = cfg.model.pts_voxel_layer
    b = tiny["batch"]
    vo = voxelize_batched(
        b["points"], b["points_mask"], voxel_size=vl.voxel_size,
        point_cloud_range=vl.point_cloud_range, max_num_points=vl.max_num_points,
        max_voxels=vl.max_voxels[1],
    )
    enc = SparseEncoder(cfg.model.pts_middle_encoder).eval()
    load_flax(enc, _sub(tiny["variables"], "pts_middle_encoder"))
    valid = torch.arange(vl.max_voxels[1])[None] < vo.num_voxels[:, None]
    with torch.no_grad():
        got = enc(hard_simple_vfe(vo.voxels, vo.num_points), vo.coords, valid)
    np.testing.assert_allclose(got.numpy(), inter["pts_middle_encoder"], rtol=1e-4, atol=1e-4)


def test_mmri_encoder_matches_flax(tiny):
    cfg, inter = tiny["cfg"], tiny["inter"]
    port = tiny["port"].imgpts_neck
    fpn0 = inter["img_neck"][0]
    img = torch.from_numpy(fpn0.copy()).reshape(1, cfg.data.num_views, *fpn0.shape[1:])
    pts = torch.from_numpy(inter["pts_neck"][0].copy())
    with torch.no_grad():
        new_img, (pts_conv, new_pts) = port(img, pts, _mmri_batch(cfg, tiny["batch"]))
    want_img, (want_conv, want_pts) = inter["imgpts_neck"]
    for g, w in ((new_img, want_img), (pts_conv, want_conv), (new_pts, want_pts)):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4)


def test_decoder_matches_flax(tiny):
    cfg, inter = tiny["cfg"], tiny["inter"]
    dec = Decoder(cfg.model.pts_bbox_head, cfg.model.bbox_coder, cfg.data.padded_img_shape).eval()
    load_flax(dec, _sub(tiny["variables"], "pts_bbox_head"))
    new_img, (pts_conv, new_pts) = jax.tree_util.tree_map(lambda a: torch.from_numpy(a.copy()), inter["imgpts_neck"])
    with torch.no_grad():
        got = dec((pts_conv, new_pts), new_img, _mmri_batch(cfg, tiny["batch"]))
    _assert_heads(got, tiny["preds"], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("views", ["top2", "all"])
def test_mmri_encoder_six_views_vs_jax_top2(views, monkeypatch):
    """The MMRI encoder at 6 views against JAX, both with the same view
    settings: ``top2``, JAX at its defaults (top-2 views for the I2P keys
    and for the BEVWarp scatter) against ``i2p_views=warp_views=2``;
    ``all``, JAX in its all-view form (``DI_I2P_VIEWS=0`` /
    ``DI_WARP_VIEWS=0``) against the port's all-view arguments. The forms
    differ only for a pillar whose points reach three or more views: three
    points are placed next to the ego, at z=0 so that the cameras' vertical
    field of view holds them, in one pillar at azimuths 6, 30 and 87
    degrees (views {0}, {0, 1}, {1, 2}), so that pillar sees three views
    while each point sees at most two. Every output agrees at 1e-4, that
    pillar's I2P output too."""
    import dataclasses

    import deepinteraction_tpu.models.mmri_encoder as jmmri

    cfg = tiny_config()
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, num_views=6))
    ncfg = dataclasses.replace(cfg.model.imgpts_neck, num_layers=1)
    h, w = cfg.data.padded_img_shape
    rng = np.random.default_rng(3)
    np_batch = jax_batch(cfg, b=1, seed=3)
    az = np.deg2rad([6.0, 30.0, 87.0])
    np_batch["points"][0, :3, :3] = np.stack([0.9 * np.cos(az), 0.9 * np.sin(az), np.zeros(3)], 1)
    np_batch["points_mask"][0, :3] = True
    c_img, c_pts = ncfg.in_channels_img, ncfg.in_channels_pts
    img = rng.normal(size=(1, 6, h // 4, w // 4, c_img)).astype(np.float32)
    pts = rng.normal(size=(1, 16, 16, c_pts)).astype(np.float32)

    if views == "all":
        class AllViewsI2P(jmmri.MMRI_I2P):
            n_views: int = 0

        monkeypatch.setattr(jmmri, "MMRI_I2P", AllViewsI2P)
        monkeypatch.setenv("DI_WARP_VIEWS", "0")
    else:
        monkeypatch.delenv("DI_WARP_VIEWS", raising=False)
        assert jmmri.MMRI_I2P.n_views == 2
    nv = 2 if views == "top2" else 0

    batch = _mmri_batch(cfg, to_torch(np_batch, "cpu"))
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    pcr = cfg.model.pts_voxel_layer.point_cloud_range
    jm = JaxMMRIEncoder(ncfg, pcr, (h, w))
    variables = jax.jit(lambda r: jm.init(r, img, pts, jbatch, False))(jax.random.PRNGKey(0))
    (want_img, (_, want_pts)), state = jax.jit(
        lambda v: jm.apply(v, img, pts, jbatch, False, mutable=["intermediates"],
                           capture_intermediates=lambda m, n: m.name == "i2p")
    )(variables)
    want_i2p = np.asarray(state["intermediates"]["layer0"]["i2p"]["__call__"][0])

    port = MMRIEncoder(ncfg, c_img, c_pts, pcr, (h, w), i2p_views=nv, warp_views=nv).eval()
    load_flax(port, _np(variables))
    captured = {}
    port.layer0.i2p.register_forward_hook(lambda m, a, o: captured.setdefault("i2p", o))
    with torch.no_grad():
        got_img, (_, got_pts) = port(torch.from_numpy(img), torch.from_numpy(pts), batch)

    # pillars whose valid points project into three or more views
    from deepinteraction_tpu_torch.models.mmri_encoder import i2p_geometry

    _, kmask = i2p_geometry(batch["pillars"], batch["pillar_counts"], batch["lidar2img"],
                            batch["lidar_aug_inv"], (h, w))
    p = batch["pillars"].shape[2]
    seen = kmask[0].reshape(-1, p, 6).any(1).sum(-1)  # [Kp]
    wide = batch["pillar_valid"][0] & (seen >= 3)
    two = batch["pillar_valid"][0] & (seen == 2)
    assert int(two.sum()) > 0 and 0 < int(wide.sum()) < int(batch["pillar_valid"].sum()) // 4
    coords = batch["pillar_coords"][0].long()[wide]
    assert np.abs(want_i2p[0][coords[:, 1], coords[:, 2]]).max() > 0.1

    np.testing.assert_allclose(captured["i2p"].numpy(), want_i2p, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_pts.numpy(), want_pts, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_img.numpy(), want_img, rtol=1e-4, atol=1e-4)

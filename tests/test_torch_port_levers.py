"""The JAX package's shipped eval and train settings (``DI_*``) in the port
(``deepinteraction_tpu_torch/levers.py``) against the JAX package, on the
CPU, on inputs made from numpy seeds, weights carried across by
``convert.load_flax``.

- ``EvalLevers.from_env()`` with no variable set is the JAX package's
  defaults, read from its source; every other ``DI_*`` name there is one
  ROADMAP.md lists as a TPU implementation choice; ``parity()`` is the
  gate tool's ``PARITY`` set.
- The nearest samplers exactly, with grid points at exact half pixels
  (``floor(f + 0.5)`` rounds them up, ``F.grid_sample``'s nearest does not).
- ``i2p_geometry`` at 2 views (views and masks exactly, valid keys' grids
  1e-6) on six
  views with a pillar that three views see and a tie in counts at the cut;
  the one-layer MMRI encoder (I2P output and both outputs, 1e-4) at top-2
  views bilinear, nearest, with the key dedupe at 8 (a pillar-view holds
  more than 8 distinct pixels), in train (with the image features'
  gradient against ``jax.grad``, 1e-4 of scale), and nearest over all
  views.
- ``bevwarp_grid`` at 2 views on widened views, where points reach three
  views (mask equal; uv within 1e-6 with the lite fill, 2e-5 with the
  full one, whose bilateral pass differs by 1.2e-5 over all views too).
- The lite depth fill (1e-5).
- MSDA's per-level and joint top-k, with random weights and with every
  weight tied (1e-4).
- ResNet, FPN, SECOND and SECONDFPN on bf16 activations against the Flax
  modules at ``dtype=bfloat16`` (2e-2 of scale), and the detector's wiring.
- The tiny ``fusion_base`` and ``tiny_pp_config`` forwards on six widened
  views with no ``DI_*`` set (JAX's import-time MSDA constants set to their
  defaults; ``tests/conftest.py`` pins them off), against JAX at its
  defaults: every head at rtol 2e-3 / atol 5e-4, labels and masks exactly.

``DI_I2P_SAMPLE`` and ``DI_WARP_VIEWS`` are read when JAX traces, so each
setting gets a freshly jitted function.
"""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

import deepinteraction_tpu.models.mmri_encoder as jmmri
import deepinteraction_tpu.ops.deform_attn as jdeform
from deepinteraction_tpu.configs import tiny_config as jtiny
from deepinteraction_tpu.configs import tiny_pp_config as jtiny_pp
from deepinteraction_tpu.models.detector import DeepInteraction as JaxDeepInteraction
from deepinteraction_tpu.models.fpn import FPN as JaxFPN
from deepinteraction_tpu.models.resnet import ResNet as JaxResNet
from deepinteraction_tpu.models.second import SECOND as JaxSECOND
from deepinteraction_tpu.models.second import SECONDFPN as JaxSECONDFPN
from deepinteraction_tpu.ops import depth_fill as jdf
from deepinteraction_tpu.utils import geometry as jgeo
from deepinteraction_tpu.utils.testing import fast_init_variables
from deepinteraction_tpu.utils.testing import make_synthetic_batch as jax_batch
from deepinteraction_tpu_torch.convert import load_flax
from deepinteraction_tpu_torch.levers import ENV, EvalLevers
from deepinteraction_tpu_torch.models.detector import DeepInteraction
from deepinteraction_tpu_torch.models.fpn import FPN
from deepinteraction_tpu_torch.models.mmri_encoder import MMRIEncoder, bevwarp_grid, i2p_geometry
from deepinteraction_tpu_torch.models.resnet import ResNet
from deepinteraction_tpu_torch.models.second import SECOND, SECONDFPN
from deepinteraction_tpu_torch.ops import depth_fill as tdf
from deepinteraction_tpu_torch.ops.deform_attn import MSDeformableAttention
from deepinteraction_tpu_torch.ops.voxelize import voxelize_batched
from deepinteraction_tpu_torch.tools import gate_eval
from deepinteraction_tpu_torch.utils import geometry as tgeo
from deepinteraction_tpu_torch.utils.synthetic import to_torch

from test_torch_port_pp import _randomize, _wide_cameras

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 2e-3, 5e-4  # the golden fixtures' tolerance
MOD_TOL = 1e-4
BF16_TOL = 2e-2  # of scale
EXACT = ("query_labels", "on_image_masks")
# the JAX package's DI_* names that choose among TPU implementations of
# the same math (ROADMAP.md)
TPU_ONLY = re.compile(r"DI_(NBR_\w+|GATHER_BWD\w*|I2P_UNROLL|I2P_CHUNK"
                      r"|MSDA_HEADS_MAJOR|MSDA_COMBINE|TPU_NATIVE_IO)$")


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_sources():
    for dirpath, _, files in os.walk(os.path.join(REPO, "deepinteraction_tpu")):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    yield fh.read()


def test_levers_are_jax_defaults(monkeypatch):
    found = {}
    for src in _jax_sources():
        for name, default in re.findall(r'environ\.get\(\s*"(DI_\w+)",\s*"([^"]*)"', src):
            found[name] = default
    for name in re.findall(r'"(DI_\w+)"', "".join(_jax_sources())):
        found.setdefault(name, None)
    assert {n: found[n] for n in ENV} == {n: d for n, (_, d) in ENV.items()}
    others = sorted(set(found) - set(ENV))
    assert others and all(TPU_ONLY.match(n) for n in others), others
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    assert EvalLevers.from_env() == EvalLevers()
    assert EvalLevers.from_env(EvalLevers.parity().as_env()) == EvalLevers.parity()
    assert EvalLevers.from_env({"DI_DENSE_BF16": "1", "DI_I2P_DEDUPE": "8", "DI_I2P_DTYPE": "bfloat16"}
                               ) == EvalLevers(dense_bf16=True, i2p_dedupe=8, i2p_dtype="bfloat16")
    # the gate tool's parity set, every name of it a setting of the port's
    parity = {k: v for k, v in gate_eval.PARITY.items() if k in ENV}
    assert parity == {k: v for k, v in EvalLevers.parity().as_env().items() if k in gate_eval.PARITY}
    assert set(gate_eval.PARITY) - set(parity) == set()
    with pytest.raises(ValueError):
        EvalLevers(i2p_sample="bicubic")
    with pytest.raises(ValueError, match="i2p_dtype"):
        EvalLevers.from_env({"DI_I2P_DTYPE": "float16"})


def test_nearest_samplers_match_jax():
    """16x8 maps: pixel (k + 0.5) sits at x = (2k + 2) / 16 - 1, exact in
    fp32; a third of the points sit on such halves in x, y or both."""
    rng = np.random.default_rng(11)
    v, h, w = 3, 8, 16
    feat = rng.normal(size=(v, h, w, 5)).astype(np.float32)
    grid = rng.uniform(-1.15, 1.15, size=(v, 60, 2)).astype(np.float32)
    half_x = (2.0 * rng.integers(-1, w, size=(v, 20)) + 2.0) / w - 1.0
    half_y = (2.0 * rng.integers(-1, h, size=(v, 20)) + 2.0) / h - 1.0
    grid[:, :20, 0] = half_x
    grid[:, 10:30, 1] = np.concatenate([half_y[:, :10], half_y[:, 10:]], 1)
    vidx = rng.integers(0, v, size=(v, 60)).astype(np.int32)
    jf, jg, jv = map(jnp.asarray, (feat, grid, vidx))
    got = tgeo.grid_sample_2d_views_nearest(_t(feat), _t(grid), _t(vidx)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jgeo.grid_sample_2d_views_nearest(jf, jg, jv)))
    np.testing.assert_array_equal(tgeo.grid_sample_2d_nearest(_t(feat[0]), _t(grid)).numpy(),
                                  np.asarray(jgeo.grid_sample_2d_nearest(jf[0], jg)))
    ids, inside = tgeo.nearest_row_ids((v, h, w), _t(grid), _t(vidx))
    jids, jin = jgeo.nearest_row_ids((v, h, w), jg, jv)
    np.testing.assert_array_equal(inside.numpy(), np.asarray(jin))
    np.testing.assert_array_equal(ids.numpy()[inside.numpy()], np.asarray(jids)[np.asarray(jin)])
    assert 0 < int((~inside).sum()) < inside.numel() // 2
    # at the halves torch's own nearest (round half to even) picks otherwise
    theirs = F.grid_sample(_t(feat[0]).permute(2, 0, 1)[None], _t(grid[:, :20]).reshape(1, 1, -1, 2), mode="nearest",
                           padding_mode="zeros", align_corners=False)[0, :, 0].T
    ours = tgeo.grid_sample_2d_nearest(_t(feat[0]), _t(grid[:, :20]).reshape(-1, 2))
    assert not torch.equal(theirs, ours)


def _six_view_cfg(pillar_points: int = 8):
    cfg = jtiny()
    pl = dataclasses.replace(cfg.model.pts_pillar_layer, max_num_points=pillar_points)
    model = dataclasses.replace(cfg.model, pts_pillar_layer=pl)
    return dataclasses.replace(cfg, model=model, data=dataclasses.replace(cfg.data, num_views=6))


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


@pytest.fixture(scope="module")
def six_views():
    """Six views and 16 points a pillar. Next to the ego at z=0 (in the
    cameras' vertical field of view): points at azimuths 6 and 7 degrees
    (view 0) and 87 (views 1 and 2) in one pillar, whose view counts are
    2, 1, 1: three views, with a tie at the cut that the lower index wins;
    and a 4x4 grid of points 1.5 m ahead (view 0), 0.8 m wide and tall, in
    one pillar, that hits more than 8 distinct feature pixels."""
    cfg = _six_view_cfg(16)
    np_batch = jax_batch(cfg, b=1, seed=3)
    az = np.deg2rad([6.0, 7.0, 87.0])
    np_batch["points"][0, :3, :3] = np.stack([0.9 * np.cos(az), 0.9 * np.sin(az), np.zeros(3)], 1)
    yy, zz = np.meshgrid(np.linspace(0.1, 0.9, 4), np.linspace(-0.4, 0.4, 4))
    np_batch["points"][0, 3:19, :3] = np.stack([np.full(16, 1.5), yy.ravel(), zz.ravel()], 1)
    np_batch["points_mask"][0, :19] = True
    batch = _mmri_batch(cfg, to_torch(np_batch, "cpu"))
    return cfg, batch, {k: jnp.asarray(v.numpy()) for k, v in batch.items()}


def test_i2p_geometry_top2_matches_jax(six_views):
    cfg, batch, jbatch = six_views
    shape = cfg.data.padded_img_shape
    args = [batch[k] for k in ("pillars", "pillar_counts", "lidar2img", "lidar_aug_inv")]
    gsel, vidx, kmask = i2p_geometry(*args, shape, n_views=2)
    want = jmmri.i2p_geometry(*[jbatch[k] for k in ("pillars", "pillar_counts", "lidar2img", "lidar_aug_inv")],
                              shape, 2)
    np.testing.assert_array_equal(vidx.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(kmask.numpy(), np.asarray(want[2]))
    # grids within 1e-6 where a key is valid; behind a camera the depth is
    # clamped to 1e-5 and coordinates reach 1e4, within 1e-5 of themselves
    on = kmask.reshape(vidx.shape).numpy()
    np.testing.assert_allclose(gsel.numpy()[on], np.asarray(want[0])[on], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(gsel.numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-6)
    # the pillar of the first three points: views 0, 1 and 2 with counts 2, 1, 1
    _, all_mask = i2p_geometry(*args, shape)
    p = batch["pillars"].shape[2]
    counts = all_mask[0].reshape(-1, p, 6).sum(1)  # [Kp, V]
    valid = batch["pillar_valid"][0]
    tie = valid & (counts[:, 0] == 2) & (counts[:, 1] == 1) & (counts[:, 2] == 1) & (counts[:, 3:] == 0).all(1)
    assert int(tie.sum()) == 1
    np.testing.assert_array_equal(vidx[0][tie][0, :, 0].numpy(), [0, 1])


I2P_CASES = {  # name: (n_views, sample mode, dedupe, train, I2P dtype)
    "top2_bilinear": (2, "bilinear", 0, False, "float32"),
    "top2_nearest": (2, "nearest", 0, False, "float32"),
    "top2_dedupe8": (2, "nearest", 8, False, "float32"),
    "top2_train": (2, "nearest", 0, True, "float32"),
    "all_views_nearest": (0, "nearest", 0, False, "float32"),
    "top2_bilinear_bf16": (2, "bilinear", 0, False, "bfloat16"),
    "all_views_bilinear_bf16": (0, "bilinear", 0, False, "bfloat16"),
    "top2_train_bf16": (2, "nearest", 0, True, "bfloat16"),
}


@pytest.mark.parametrize("case", list(I2P_CASES))
def test_mmri_encoder_i2p_settings_match_jax(case, six_views, monkeypatch):
    """The one-layer MMRI encoder with JAX's ``MMRI_I2P`` fields and
    ``DI_WARP_VIEWS`` set to the case, against the port's encoder with the
    same arguments. In train both sample bilinear and normalise with the
    batch's statistics. With bf16 keys (JAX's ``DI_I2P_DTYPE``) both sides
    are held to 2e-2 of scale, and the port's bf16 output must move
    against its fp32 one."""
    nv, mode, dd, train, dt = I2P_CASES[case]
    cfg, batch, jbatch = six_views
    ncfg = cfg.model.imgpts_neck
    h, w = cfg.data.padded_img_shape
    rng = np.random.default_rng(3)
    img = rng.normal(size=(1, 6, h // 4, w // 4, ncfg.in_channels_img)).astype(np.float32)
    pts = rng.normal(size=(1, 16, 16, ncfg.in_channels_pts)).astype(np.float32)
    pcr = cfg.model.pts_voxel_layer.point_cloud_range

    class CaseI2P(jmmri.MMRI_I2P):
        n_views: int = nv
        sample_mode: str = mode
        dedupe: int = dd
        dtype: str = dt

    monkeypatch.setattr(jmmri, "MMRI_I2P", CaseI2P)
    monkeypatch.setenv("DI_WARP_VIEWS", str(nv))
    jm = jmmri.MMRIEncoder(ncfg, pcr, (h, w))
    variables = jax.jit(lambda r: jm.init(r, img, pts, jbatch, False))(jax.random.PRNGKey(0))
    mutable = ["intermediates", "batch_stats"] if train else ["intermediates"]
    (want_img, (_, want_pts)), state = jax.jit(
        lambda v: jm.apply(v, img, pts, jbatch, train, mutable=mutable,
                           capture_intermediates=lambda m, n: m.name == "i2p")
    )(variables)
    want_i2p = np.asarray(state["intermediates"]["layer0"]["i2p"]["__call__"][0])

    port = MMRIEncoder(ncfg, ncfg.in_channels_img, ncfg.in_channels_pts, pcr, (h, w), i2p_views=nv,
                       i2p_sample=mode, i2p_dedupe=dd, warp_views=nv, i2p_dtype=dt)
    load_flax(port, _np(variables))
    captured = {}
    port.layer0.i2p.register_forward_hook(lambda m, a, o: captured.setdefault("i2p", o))
    timg = torch.from_numpy(img).requires_grad_(train)
    with torch.set_grad_enabled(train):
        got_img, (_, got_pts) = port(timg, torch.from_numpy(pts), batch, train=train)
    assert np.abs(want_i2p).max() > 0.1
    if dt == "bfloat16":
        for what, g, wnt in (("i2p", captured["i2p"], want_i2p), ("pts", got_pts, want_pts), ("img", got_img, want_img)):
            _close_of_scale(g.detach(), wnt, BF16_TOL, what)
        fp32 = MMRIEncoder(ncfg, ncfg.in_channels_img, ncfg.in_channels_pts, pcr, (h, w), i2p_views=nv,
                           i2p_sample=mode, warp_views=nv)
        fp32.load_state_dict(port.state_dict())
        fp32.layer0.i2p.register_forward_hook(lambda m, a, o: captured.__setitem__("fp32", o))
        with torch.no_grad():
            fp32(torch.from_numpy(img), torch.from_numpy(pts), batch, train=train)
        moved = (captured["fp32"] - captured["i2p"]).abs().max().item()
        assert moved > MOD_TOL * np.abs(want_i2p).max(), moved
    else:
        np.testing.assert_allclose(captured["i2p"].detach().numpy(), want_i2p, rtol=MOD_TOL, atol=MOD_TOL)
        np.testing.assert_allclose(got_pts.detach().numpy(), np.asarray(want_pts), rtol=MOD_TOL, atol=MOD_TOL)
        np.testing.assert_allclose(got_img.detach().numpy(), np.asarray(want_img), rtol=MOD_TOL, atol=MOD_TOL)

    if train:
        # the image features' gradient through the top-2 keys (and the
        # rest of the layer) against jax.grad, 1e-4 of its scale
        r = rng.normal(size=np.shape(want_pts)).astype(np.float32)
        jgrad = jax.jit(jax.grad(lambda x: jnp.sum(
            jm.apply(variables, x, pts, jbatch, True, mutable=["batch_stats"])[0][1][1] * r)))(img)
        (got_pts * torch.from_numpy(r)).sum().backward()
        jgrad = np.asarray(jgrad)
        tol = BF16_TOL if dt == "bfloat16" else MOD_TOL
        np.testing.assert_allclose(timg.grad.numpy(), jgrad, rtol=0, atol=tol * np.abs(jgrad).max())

    if case == "top2_dedupe8":
        # a pillar-view with more than 8 distinct pixels, whose keys past
        # the 8th the dedupe drops: its output moves against plain nearest
        gsel, vidx, kmask = i2p_geometry(batch["pillars"], batch["pillar_counts"], batch["lidar2img"],
                                         batch["lidar_aug_inv"], (h, w), 2)
        ids, inside = tgeo.nearest_row_ids((6, h // 4, w // 4), gsel[0], vidx[0])
        valid = kmask[0].reshape(ids.shape) & inside
        distinct = torch.tensor([[len(set(i[m].tolist())) for i, m in zip(pi, pm)] for pi, pm in zip(ids, valid)])
        assert int(distinct.max()) > 8
        nearest = MMRIEncoder(ncfg, ncfg.in_channels_img, ncfg.in_channels_pts, pcr, (h, w), i2p_views=2,
                              i2p_sample="nearest", warp_views=2)
        nearest.load_state_dict(port.state_dict())
        nearest.layer0.i2p.register_forward_hook(lambda m, a, o: captured.__setitem__("nearest", o))
        nearest(torch.from_numpy(img), torch.from_numpy(pts), batch)
        coor = batch["pillar_coords"][0].long()[distinct.max(1).values > 8]
        d = (captured["nearest"] - captured["i2p"])[0, coor[:, 1], coor[:, 2]].abs().max().item()
        assert d > 1e-3, d


@pytest.mark.parametrize("lite", [True, False])
def test_bevwarp_grid_top2_matches_jax(lite, monkeypatch):
    """Six views widened (a focal of 0.1 x width), where points reach
    three views: JAX at ``DI_WARP_VIEWS=2`` against ``warp_views=2``, with
    the lite depth fill and with the full one. The full fill's bilateral
    pass (``exp`` on both sides) moves uv by up to 1.2e-5 between the two
    packages, over all views as well: uv is held to 1e-6 with the lite fill
    and to 2e-5 with the full one."""
    cfg = _six_view_cfg()
    np_batch = _wide_cameras(jax_batch(cfg, b=2, seed=4), cfg)
    tb = to_torch(np_batch, "cpu")
    h, w = cfg.data.padded_img_shape
    feat = (h // 4, w // 4)
    pcr = cfg.model.pts_voxel_layer.point_cloud_range
    keys = ("points", "points_mask", "lidar2img", "img2lidar", "lidar_aug", "lidar_aug_inv")
    monkeypatch.setenv("DI_WARP_VIEWS", "2")
    monkeypatch.setenv("DI_DEPTH_FILL_LITE", "1" if lite else "0")
    uv_j, ok_j = jax.jit(lambda *a: jmmri.bevwarp_grid(*a, feat, (h, w), pcr))(*(np_batch[k] for k in keys))
    uv, ok = bevwarp_grid(*(tb[k] for k in keys), feat, (h, w), pcr, warp_views=2, depth_fill_lite=lite)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_j))
    tol = 1e-6 if lite else 2e-5
    np.testing.assert_allclose(uv.numpy(), np.asarray(uv_j), rtol=tol, atol=tol)
    uv_all, ok_all = bevwarp_grid(*(tb[k] for k in keys), feat, (h, w), pcr, depth_fill_lite=lite)
    assert (uv_all - uv).abs().max() > 1e-3, "no point reaches three views"


def test_depth_fill_lite_matches_jax():
    rng = np.random.default_rng(5)
    d = np.zeros((3, 28, 50), np.float32)
    hit = rng.uniform(size=d.shape) < 0.06
    d[hit] = rng.uniform(1.0, 60.0, size=hit.sum())
    d[:, :4] = 0
    d[1, :, 7] = 0
    got = tdf.fill_in_multiscale(_t(d), lite=True).numpy()
    np.testing.assert_allclose(got, np.asarray(jdf.fill_in_multiscale(jnp.asarray(d), lite=True)),
                               rtol=1e-5, atol=1e-5)
    assert np.abs(got - tdf.fill_in_multiscale(_t(d)).numpy()).max() > 1.0


MSDA_CASES = {  # name: (joint kj, per-level k, levels, every weight tied)
    "joint4": (4, 0, 2, False),
    "joint4_tied": (4, 0, 2, True),
    "level2": (0, 2, 2, False),
    "level2_tied": (0, 2, 2, True),
    "joint4_wins": (4, 2, 2, False),
    "joint4_off_one_level": (4, 2, 1, False),  # kj == L*P: the per-level top-2 applies
}


@pytest.mark.parametrize("case", list(MSDA_CASES))
def test_msda_topk_matches_flax(case, monkeypatch):
    kj, k, l, tied = MSDA_CASES[case]
    monkeypatch.setattr(jdeform, "MSDA_JOINT_POINTS", kj)
    monkeypatch.setattr(jdeform, "MSDA_EVAL_POINTS", k)
    rng = np.random.default_rng(4)
    b, nq, c, h, p = 2, 30, 32, 4, 4
    shapes = [(6, 9), (3, 5)][:l]
    query = rng.normal(size=(b, nq, c)).astype(np.float32)
    value = rng.normal(size=(b, sum(hh * ww for hh, ww in shapes), c)).astype(np.float32)
    ref = rng.uniform(0.0, 1.0, size=(b, nq, l, 2)).astype(np.float32)
    jm = jdeform.MSDeformableAttention(c, h, l, p, dropout=0.0)
    init = jax.eval_shape(lambda q, v, r: jm.init(jax.random.PRNGKey(0), q, v, r, shapes), query, value, ref)
    params = _randomize(init["params"], rng, std=0.3)
    if tied:
        params["attention_weights"] = jax.tree_util.tree_map(np.zeros_like, params["attention_weights"])
    want = jax.jit(lambda pr, q, v, r: jm.apply({"params": pr}, q, v, r, shapes))(params, query, value, ref)
    port = MSDeformableAttention(c, h, l, p, dropout=0.0, joint_points=kj, eval_points=k).eval()
    load_flax(port, {"params": params})
    exact = MSDeformableAttention(c, h, l, p, dropout=0.0)
    exact.load_state_dict(port.state_dict())
    with torch.no_grad():
        args = (*map(torch.from_numpy, (query, value, ref)), shapes)
        got, full = port(*args), exact(*args)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=MOD_TOL, atol=MOD_TOL)
    assert (got - full).abs().max().item() > 1e-2  # the reduction took effect


def _close_of_scale(got, want, tol, what):
    want = np.asarray(want, np.float32)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= tol * np.abs(want).max(), (what, err, np.abs(want).max())


def _random_variables(module, rng, *inputs):
    """Random weights for a Flax module from its init's shapes (no init
    run): params as :func:`_randomize` draws them, BN means N(0, 0.1) and
    variances U(0.5, 1.5)."""
    shapes = jax.eval_shape(lambda *x: module.init(jax.random.PRNGKey(0), *x), *inputs)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.normal(scale=0.1, size=a.shape) if "mean" in str(path[-1])
                         else rng.uniform(0.5, 1.5, size=a.shape)).astype(np.float32),
        shapes.get("batch_stats", {}))
    return {"params": _randomize(shapes["params"], rng), "batch_stats": stats}


def test_dense_bf16_matches_flax():
    """ResNet-18 + FPN and SECOND + SECONDFPN of ``tiny_config`` at random
    weights and statistics, on bf16 activations, against the Flax modules
    at ``dtype=bfloat16`` (params fp32 in both), 2e-2 of scale."""
    cfg = jtiny().model
    rng = np.random.default_rng(9)
    bf16 = torch.bfloat16
    img = rng.normal(size=(2, 32, 64, 3)).astype(np.float32)
    jr = JaxResNet(depth=18, out_indices=(0, 1, 2, 3), dtype=jnp.bfloat16)
    jfpn = JaxFPN(out_channels=cfg.img_neck.out_channels, num_outs=cfg.img_neck.num_outs, dtype=jnp.bfloat16)
    rv = _random_variables(jr, rng, img)
    feat_shapes = jax.eval_shape(lambda v, x: jr.apply(v, x), rv, img)
    fv = _random_variables(jfpn, rng, feat_shapes)
    feats, outs = jax.jit(lambda a, b, x: (lambda f: (f, jfpn.apply(b, f)))(jr.apply(a, x)))(rv, fv, img)
    resnet = load_flax(ResNet(18, (0, 1, 2, 3)).eval(), _np(rv))
    fpn = load_flax(FPN((64, 128, 256, 512), cfg.img_neck.out_channels, cfg.img_neck.num_outs).eval(),
                    {"params": _np(fv["params"])})
    with torch.no_grad():
        got = resnet(_t(img).to(bf16))
        got_outs = fpn(got)
    for i, (g, wnt) in enumerate(zip(got, feats)):
        assert g.dtype == bf16 and wnt.dtype == jnp.bfloat16
        _close_of_scale(g, wnt.astype(jnp.float32), BF16_TOL, f"resnet {i}")
    for i, (g, wnt) in enumerate(zip(got_outs, outs)):
        _close_of_scale(g, wnt.astype(jnp.float32), BF16_TOL, f"fpn {i}")

    pb, pn = cfg.pts_backbone, cfg.pts_neck
    bev = rng.normal(size=(2, 16, 16, pb.in_channels)).astype(np.float32)
    js = JaxSECOND(pb.out_channels, pb.layer_nums, pb.layer_strides, dtype=jnp.bfloat16)
    jn = JaxSECONDFPN(pn.out_channels, pn.upsample_strides, dtype=jnp.bfloat16)
    sv = _random_variables(js, rng, bev)
    nv = _random_variables(jn, rng, jax.eval_shape(lambda v, x: js.apply(v, x), sv, bev))
    neck = jax.jit(lambda a, b, x: jn.apply(b, js.apply(a, x)))(sv, nv, bev)
    second = load_flax(SECOND(pb.in_channels, pb.out_channels, pb.layer_nums, pb.layer_strides).eval(), _np(sv))
    secondfpn = load_flax(SECONDFPN(pb.out_channels, pn.out_channels, pn.upsample_strides).eval(), _np(nv))
    with torch.no_grad():
        got_neck = secondfpn(second(_t(bev).to(bf16)))
    for i, (g, wnt) in enumerate(zip(got_neck, neck)):
        assert g.dtype == bf16
        _close_of_scale(g, wnt.astype(jnp.float32), BF16_TOL, f"secondfpn {i}")


def test_dense_bf16_detector_wiring():
    """``dense_bf16`` in eval: ResNet, FPN, SECOND and SECONDFPN see bf16,
    the neck fp32; in train nothing changes; the heads stay finite and near
    the fp32 model's."""
    cfg = jtiny()
    batch = to_torch(jax_batch(cfg, b=1, seed=2), "cpu")
    fp32 = DeepInteraction(cfg.model, cfg.data.padded_img_shape, levers=EvalLevers.parity()).eval()
    port = DeepInteraction(cfg.model, cfg.data.padded_img_shape,
                           levers=dataclasses.replace(EvalLevers.parity(), dense_bf16=True)).eval()
    port.load_state_dict(fp32.state_dict())
    seen = {}
    def record(name, args):
        seen.setdefault(name, [t.dtype for t in jax.tree_util.tree_leaves(args)
                               if torch.is_tensor(t) and t.is_floating_point()])

    for name in ("img_backbone", "img_neck", "pts_backbone", "pts_neck", "imgpts_neck"):
        port.get_submodule(name).register_forward_pre_hook(lambda m, a, name=name: record(name, a))
    got, want = port(batch), fp32(batch)
    assert all(d == torch.bfloat16 for n in ("img_backbone", "img_neck", "pts_backbone", "pts_neck")
               for d in seen[n]), seen
    assert all(d == torch.float32 for d in seen["imgpts_neck"]), seen
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.isfinite(got[k].float()).all(), k
    assert (got["heatmap"] - want["heatmap"]).abs().max() > 0
    seen.clear()
    port.train()(batch, train=True, generator=torch.Generator().manual_seed(0))
    assert all(d == torch.float32 for v in seen.values() for d in v), seen


def _defaults(monkeypatch):
    """Both packages at their shipped defaults: no ``DI_*`` variable, and
    JAX's import-time MSDA constants at the values they take with none."""
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(jdeform, "MSDA_JOINT_POINTS", 4)
    monkeypatch.setattr(jdeform, "MSDA_EVAL_POINTS", 2)
    assert jmmri.MMRI_I2P.n_views == 2 and jmmri.MMRI_I2P.dedupe == 0


@pytest.mark.parametrize("which", ["fusion_base", "pp", "fusion_base_bf16"])
def test_tiny_forward_at_defaults_matches_jax(which, monkeypatch):
    """Six views widened, so that pillars reach three views and the MMPI
    image blocks take queries; random weights (``fast_init_variables``).
    ``fusion_base_bf16`` adds ``DI_I2P_DTYPE=bfloat16`` on both sides
    (JAX's ``MMRI_I2P.dtype`` is read at import: a subclass): every head
    within 2e-2 of its scale, labels and masks exactly."""
    _defaults(monkeypatch)
    bf16 = which.endswith("_bf16")
    if bf16:
        class BF16I2P(jmmri.MMRI_I2P):
            dtype: str = "bfloat16"

        monkeypatch.setattr(jmmri, "MMRI_I2P", BF16I2P)
        monkeypatch.setenv("DI_I2P_DTYPE", "bfloat16")
    cfg = _six_view_cfg() if which.startswith("fusion_base") else dataclasses.replace(
        jtiny_pp(), data=dataclasses.replace(jtiny_pp().data, num_views=6))
    np_batch = _wide_cameras(jax_batch(cfg, b=1, with_gt=True, seed=5), cfg)
    jb = {k: jnp.asarray(v) for k, v in np_batch.items()}
    model = JaxDeepInteraction(cfg.model, cfg.data.padded_img_shape)
    variables = fast_init_variables(model, jb, seed=7)
    want = _np(jax.jit(lambda v, b: model.apply(v, b, False))(variables, jb))

    port = DeepInteraction(cfg.model, cfg.data.padded_img_shape).eval()
    assert port.levers == EvalLevers(i2p_dtype="bfloat16" if bf16 else "float32")
    load_flax(port, _np(variables))
    batch = to_torch(np_batch, "cpu")
    got = port(batch)
    assert set(got) == set(want)
    for k in sorted(want):
        if k in EXACT:
            np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
        elif bf16:
            _close_of_scale(got[k], want[k], BF16_TOL, k)
        else:
            np.testing.assert_allclose(got[k].numpy(), want[k], rtol=RTOL, atol=ATOL, err_msg=k)
    if bf16:
        fp32 = DeepInteraction(cfg.model, cfg.data.padded_img_shape, levers=EvalLevers()).eval()
        fp32.load_state_dict(port.state_dict())
        assert max((fp32(batch)[k] - got[k]).abs().max().item() for k in got if k not in EXACT) > 0
        return

    # the defaults took effect: a pillar reaches three views, and the
    # parity model is far from JAX's defaults
    mb = _mmri_batch(cfg, batch)
    _, kmask = i2p_geometry(mb["pillars"], mb["pillar_counts"], mb["lidar2img"], mb["lidar_aug_inv"],
                            cfg.data.padded_img_shape)
    p = mb["pillars"].shape[2]
    assert int((mb["pillar_valid"][0] & (kmask[0].reshape(-1, p, 6).any(1).sum(-1) >= 3)).sum()) > 0
    parity = DeepInteraction(cfg.model, cfg.data.padded_img_shape, levers=EvalLevers.parity()).eval()
    parity.load_state_dict(port.state_dict())
    moved = parity(batch)
    assert max((moved[k] - got[k]).abs().max().item() for k in got if k not in EXACT) > 10 * ATOL

"""The PyTorch port's ops against the JAX package, on the CPU, on inputs
made from numpy seeds.

- voxelization, neighbor tables and the BEV fold: exactly equal;
- K1's plain version (``gathered_matmul``) vs the XLA gather (rtol 1e-5) and
  vs the Pallas banded kernel in interpret mode (bf16: max|d|/max|ref| <
  2e-2, as tests/test_sparse_conv_banded.py holds it);
- K2's plain version vs the XLA formulation (2e-5) and vs the Pallas kernel
  in interpret mode (bf16 3e-2, as tests/test_local_attention_pallas.py);
- the K1/K2 wrappers take their plain version for CPU tensors;
- depth fill, grid sampling and ROIAlign (1e-5).
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepinteraction_tpu.ops import depth_fill as jdf
from deepinteraction_tpu.ops import local_attention as jla
from deepinteraction_tpu.ops import roi_align as jra
from deepinteraction_tpu.ops import sparse_conv as jsc
from deepinteraction_tpu.ops import sparse_conv_banded as jscb
from deepinteraction_tpu.ops.local_attention_pallas import _pallas_forward
from deepinteraction_tpu.utils import geometry as jgeo
from deepinteraction_tpu_torch.ops import depth_fill as tdf
from deepinteraction_tpu_torch.ops import local_attention as tla
from deepinteraction_tpu_torch.ops import roi_align as tra
from deepinteraction_tpu_torch.ops import sparse_conv as tsc
from deepinteraction_tpu_torch.ops import subm_conv as tsm
from deepinteraction_tpu_torch.ops import voxelize as tvox
from deepinteraction_tpu_torch.utils import geometry as tgeo

# the package's ops/__init__ exports a function of the module's name
jvox = importlib.import_module("deepinteraction_tpu.ops.voxelize")

torch.set_num_threads(1)

SHAPE = (9, 48, 48)


def _t(a):
    return torch.from_numpy(np.array(a))


def _points(rng, n, pcr):
    pts = np.stack(
        [rng.uniform(pcr[0] - 1, pcr[3] + 1, n), rng.uniform(pcr[1] - 1, pcr[4] + 1, n),
         rng.uniform(pcr[2], pcr[5], n), rng.uniform(0, 255, n), np.zeros(n)], 1
    ).astype(np.float32)
    return pts, rng.uniform(size=n) > 0.2


@pytest.mark.parametrize("max_voxels,max_pts", [(400, 4), (50, 3)])  # 50: overflow
def test_voxelize_exact(max_voxels, max_pts):
    rng = np.random.default_rng(max_voxels)
    pcr = (-4.0, -4.0, -2.0, 4.0, 4.0, 2.0)
    pts, mask = _points(rng, 3000, pcr)
    kw = dict(voxel_size=(0.5, 0.5, 1.0), point_cloud_range=pcr,
              max_num_points=max_pts, max_voxels=max_voxels)
    want = jvox.voxelize_batched(jnp.asarray(pts[None]), jnp.asarray(mask[None]), **kw)
    got = tvox.voxelize_batched(_t(pts[None]), _t(mask[None]), **kw)
    for name in got._fields:  # the port drops point_voxel_idx (test-only in JAX)
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name)
    np.testing.assert_array_equal(
        tvox.hard_simple_vfe(got.voxels, got.num_points).numpy(),
        np.asarray(jvox.hard_simple_vfe(want.voxels[0], want.num_points[0]))[None],
    )


def _sparse(rng, n_active, capacity, c):
    ids = np.sort(rng.permutation(np.prod(SHAPE))[:n_active])
    coords = np.stack([ids // (SHAPE[1] * SHAPE[2]), (ids // SHAPE[2]) % SHAPE[1], ids % SHAPE[2]], 1)
    coords = np.concatenate([coords, np.zeros((capacity - n_active, 3))]).astype(np.int32)
    feats = rng.normal(size=(capacity, c)).astype(np.float32)
    valid = np.arange(capacity) < n_active
    feats[~valid] = 0
    return feats, coords, valid


def test_neighbor_tables_and_bev_exact():
    rng = np.random.default_rng(0)
    feats, coords, valid = _sparse(rng, 700, 800, 6)
    jst = jsc.SparseTensor(jnp.asarray(feats), jnp.asarray(coords), jnp.asarray(valid), SHAPE)
    tst = tsc.SparseTensor(_t(feats), _t(coords), _t(valid), SHAPE)
    np.testing.assert_array_equal(tsc.subm_neighbor_table(tst).numpy(), np.asarray(jsc.subm_neighbor_table(jst)))
    np.testing.assert_array_equal(tsc.to_dense_bev(tst).numpy(), np.asarray(jsc.to_dense_bev(jst)))
    for kernel, stride, pad, cap in [((3, 3, 3), (2, 2, 2), (1, 1, 1), 500), ((3, 3, 3), (2, 2, 2), (0, 1, 1), 60),
                                     ((3, 1, 1), (2, 1, 1), (0, 0, 0), 800)]:
        jo = jsc.downsample_sites_batched(jst.coords[None], jst.valid[None], SHAPE, kernel, stride, pad, cap)
        to = tsc.downsample_sites(tst.coords, tst.valid, SHAPE, kernel, stride, pad, cap)
        np.testing.assert_array_equal(to[0].numpy(), np.asarray(jo[0][0]))
        np.testing.assert_array_equal(to[1].numpy(), np.asarray(jo[1][0]))
        assert to[2] == jo[2]
        jn = jsc.strided_neighbor_table(jst, jo[0][0], jo[1][0], kernel, stride, pad)
        tn = tsc.strided_neighbor_table(tst, to[0], to[1], kernel, stride, pad)
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))


@pytest.mark.parametrize("c,cout", [(16, 16), (8, 32)])
def test_gathered_matmul_vs_xla_and_banded(c, cout):
    rng = np.random.default_rng(c)
    feats, coords, valid = _sparse(rng, 500, 640, c)
    st = jsc.SparseTensor(jnp.asarray(feats), jnp.asarray(coords), jnp.asarray(valid), SHAPE)
    nbr = jsc.subm_neighbor_table(st)
    w = (rng.normal(size=(27, c, cout)) * 0.2).astype(np.float32)
    got = tsm.subm_conv_gemm(_t(feats), _t(nbr), _t(w), _t(valid)).numpy()
    assert np.array_equal(got, tsm.gathered_matmul(_t(feats), _t(nbr), _t(w), _t(valid)).numpy())
    ref = np.asarray(jsc.gathered_matmul(st.features, nbr, jnp.asarray(w).reshape(27 * c, cout), st.valid))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
    plan = jscb.make_banded_plan(nbr, st.valid, T=128, W=512)
    banded = np.asarray(jscb.banded_subm_conv(128, 512, True, st.features, jnp.asarray(w), st.valid, nbr, plan))
    assert np.abs(banded - got).max() / np.abs(got).max() < 2e-2


@pytest.mark.parametrize("shape,kernel", [((2, 16, 24, 128), 5), ((1, 11, 13, 128), 3), ((1, 12, 10, 32), 9)])
def test_local_attention_vs_xla_and_pallas(shape, kernel):
    rng = np.random.default_rng(sum(shape))
    q, k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    got = tla.local_attn_fwd(_t(q), _t(k), _t(v), kernel).numpy()
    assert np.array_equal(got, tla.local_attention(_t(q), _t(k), _t(v), kernel).numpy())
    ref = np.asarray(jla.local_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kernel))
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=2e-5)
    if shape[-1] == 128 and kernel // 2 <= 8:
        pal = np.asarray(_pallas_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kernel, interpret=True))
        np.testing.assert_allclose(got, pal, atol=3e-2, rtol=3e-2)


def test_depth_fill_matches_jax():
    rng = np.random.default_rng(5)
    d = np.zeros((3, 28, 50), np.float32)
    hit = rng.uniform(size=d.shape) < 0.06
    d[hit] = rng.uniform(1.0, 60.0, size=hit.sum())
    d[:, :4] = 0  # empty top rows: the top-row mask matters
    d[1, :, 7] = 0  # an empty column
    got = tdf.fill_in_multiscale(_t(d)).numpy()
    want = np.asarray(jdf.fill_in_multiscale(jnp.asarray(d)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_grid_sample_matches_jax():
    rng = np.random.default_rng(6)
    feat = rng.normal(size=(3, 9, 11, 8)).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, size=(3, 40, 2)).astype(np.float32)
    vidx = rng.integers(0, 3, size=(3, 40)).astype(np.int32)
    np.testing.assert_allclose(
        tgeo.grid_sample_2d(_t(feat[0]), _t(grid)).numpy(),
        np.asarray(jgeo.grid_sample_2d(jnp.asarray(feat[0]), jnp.asarray(grid))),
        rtol=1e-5, atol=1e-5,
    )
    np.testing.assert_allclose(
        tgeo.grid_sample_2d_views(_t(feat), _t(grid), _t(vidx)).numpy(),
        np.asarray(jgeo.grid_sample_2d_views(jnp.asarray(feat), jnp.asarray(grid), jnp.asarray(vidx))),
        rtol=1e-5, atol=1e-5,
    )


def test_roi_align_matches_jax():
    rng = np.random.default_rng(7)
    feat = rng.normal(size=(2, 12, 20, 8)).astype(np.float32)
    x0 = rng.uniform(-10, 70, size=(30, 1))
    y0 = rng.uniform(-10, 40, size=(30, 1))
    boxes = np.concatenate([x0, y0, x0 + rng.uniform(1, 30, (30, 1)), y0 + rng.uniform(1, 20, (30, 1))], 1).astype(np.float32)
    vidx = rng.integers(0, 2, size=30).astype(np.int32)
    np.testing.assert_allclose(
        tra.roi_align(_t(feat[0]), _t(boxes), spatial_scale=0.25).numpy(),
        np.asarray(jra.roi_align(jnp.asarray(feat[0]), jnp.asarray(boxes), spatial_scale=0.25)),
        rtol=1e-5, atol=1e-5,
    )
    np.testing.assert_allclose(
        tra.roi_align_views(_t(feat), _t(boxes), _t(vidx), spatial_scale=0.25).numpy(),
        np.asarray(jra.roi_align_views(jnp.asarray(feat), jnp.asarray(boxes), jnp.asarray(vidx), spatial_scale=0.25)),
        rtol=1e-5, atol=1e-5,
    )

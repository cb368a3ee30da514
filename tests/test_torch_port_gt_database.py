"""The port's data preparation against the JAX package, on the CPU.

- ``points_in_box``, ``create_gt_database`` (the index pkl and every
  ``.bin``, exactly) and ``ObjectSampler`` (points, boxes and labels,
  exactly, from the same ``np.random.default_rng`` seed: 3 seeds, a sparse
  scene and a collision-heavy one) against ``deepinteraction_tpu.data.
  gt_database`` on a database of two synthetic clouds with boxes of four
  classes;
- GT paste in the train pipeline: the dataset with ``gt_database`` and
  ``sample_groups`` (so ``build_sample(train=True, sampler=...)``) against
  JAX's before ``fade_epoch`` (the paste fires) and after it (the sample is
  the sampler-less one), on the tiny tree;
- ``export_2d_annotation``'s JSON against JAX's, with and without mono3d;
- ``write_synthetic_nuscenes(device="cpu")``'s tree byte for byte against
  the JAX writer's;
- ``python -m deepinteraction_tpu_torch.tools.create_data`` in its
  ``synthetic`` (tiny profile) and ``nuscenes`` modes with ``--gt-database
  --export-2d``: its info pkls, 2D annotations and GT database against
  JAX's ``create_nuscenes_infos``, ``export_2d_annotation`` and
  ``create_gt_database`` on the same tree; the ``synthetic`` mode needs a
  card unless given ``--device cpu``.
"""

import dataclasses
import filecmp
import json
import os
import pickle
import shutil

import numpy as np
import pytest
import torch

from deepinteraction_tpu.data import NuScenesDataset as JDataset
from deepinteraction_tpu.data import anno_2d as janno
from deepinteraction_tpu.data import gt_database as jgt
from deepinteraction_tpu.data.nuscenes_converter import create_nuscenes_infos as jcreate
from deepinteraction_tpu.utils.synthetic_nuscenes import write_synthetic_nuscenes as jwrite
from deepinteraction_tpu_torch.data import NuScenesDataset as TDataset
from deepinteraction_tpu_torch.data import anno_2d as tanno
from deepinteraction_tpu_torch.data import gt_database as tgt
from deepinteraction_tpu_torch.data.dataset import load_infos
from deepinteraction_tpu_torch.tools import create_data
from deepinteraction_tpu_torch.utils.synthetic_nuscenes import write_synthetic_nuscenes as twrite
from test_torch_port_data import _assert_same, _cfgs, _compare_samples

torch.set_num_threads(1)

CLASSES = ("car", "pedestrian", "barrier", "traffic_cone")
DIMS = {"car": (4.2, 1.8, 1.6), "pedestrian": (0.7, 0.7, 1.8), "barrier": (0.5, 2.5, 1.0),
        "traffic_cone": (0.4, 0.4, 1.0)}


def _cloud_with_boxes(rng, path, n_boxes=5, pts_per_box=30):
    """A cloud of ``n_boxes`` boxes (random classes, poses and yaws inside
    the tiny range) each holding ``pts_per_box`` points, plus noise; the
    info dict that describes it."""
    boxes, names, pts = [], [], []
    for _ in range(n_boxes):
        name = CLASSES[rng.integers(len(CLASSES))]
        dx, dy, dz = DIMS[name]
        box = np.array([*rng.uniform(-7, 7, 2), rng.uniform(-2, 0), dx, dy, dz, rng.uniform(-np.pi, np.pi)],
                       np.float32)
        local = rng.uniform(-0.45, 0.45, size=(pts_per_box, 5)).astype(np.float32)
        local[:, :3] *= (dx, dy, dz)
        c, s = np.cos(box[6]), np.sin(box[6])
        p = local.copy()
        p[:, 0] = c * local[:, 0] - s * local[:, 1] + box[0]
        p[:, 1] = s * local[:, 0] + c * local[:, 1] + box[1]
        p[:, 2] = local[:, 2] + box[2] + dz / 2
        boxes.append(box)
        names.append(name)
        pts.append(p)
    noise = rng.uniform(-8, 8, size=(300, 5)).astype(np.float32)
    noise[:, 2] = rng.uniform(-3, 2, size=300)
    np.concatenate(pts + [noise]).tofile(path)
    return {"token": os.path.basename(path)[:-4], "timestamp": 1_000_000, "lidar_path": path, "sweeps": [],
            "gt_boxes": np.stack(boxes), "gt_names": np.asarray(names),
            "gt_velocity": rng.normal(size=(n_boxes, 2))}


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    """Two synthetic infos and the GT database each package builds from
    them."""
    root = tmp_path_factory.mktemp("gtdb")
    rng = np.random.default_rng(5)
    infos = [_cloud_with_boxes(rng, str(root / f"pc{i}.bin")) for i in range(2)]
    jpath = jgt.create_gt_database(infos, str(root / "jax"), num_sweeps=0)
    tpath = tgt.create_gt_database(infos, str(root / "port"), num_sweeps=0)
    return infos, jpath, tpath


def _assert_same_database(jpath, tpath):
    with open(jpath, "rb") as f:
        want = pickle.load(f)
    with open(tpath, "rb") as f:
        got = pickle.load(f)
    _assert_same(got, want, "gt_database")
    n = 0
    for entries in want.values():
        for e in entries:
            a, b = (os.path.join(os.path.dirname(p), e["path"]) for p in (jpath, tpath))
            assert filecmp.cmp(a, b, shallow=False), e["path"]
            n += 1
    return want, n


def test_points_in_box_matches_jax():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-5, 5, size=(2000, 5)).astype(np.float32)
    for _ in range(20):
        box = np.array([*rng.uniform(-2, 2, 3), *rng.uniform(0.5, 4, 3), rng.uniform(-np.pi, np.pi)], np.float32)
        got, want = tgt.points_in_box(pts, box), jgt.points_in_box(pts, box)
        np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < len(pts)


def test_create_gt_database_matches_jax(db):
    _, jpath, tpath = db
    want, n = _assert_same_database(jpath, tpath)
    assert n == 10 and set(want) <= set(CLASSES), {k: len(v) for k, v in want.items()}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("case", ["sparse", "collision_heavy"])
def test_object_sampler_matches_jax(db, seed, case):
    infos, jpath, tpath = db
    if case == "sparse":  # a scene of noise, no boxes: candidates collide only with each other
        groups = {"car": 2, "pedestrian": 2, "barrier": 1}
        points = np.random.default_rng(9).uniform(-8, 8, size=(400, 5)).astype(np.float32)
        boxes, labels = np.zeros((0, 9), np.float32), np.zeros((0,), np.int64)
    else:  # the first cloud with its boxes, every class asked for more than the pools hold
        groups = dict.fromkeys(CLASSES, 8)
        points = np.fromfile(infos[0]["lidar_path"], np.float32).reshape(-1, 5)
        boxes = np.concatenate([infos[0]["gt_boxes"], infos[0]["gt_velocity"]], 1).astype(np.float32)
        labels = np.asarray([_cfgs()[1].data.class_names.index(n) for n in infos[0]["gt_names"]], np.int64)
    class_names = _cfgs()[1].data.class_names
    want = jgt.ObjectSampler(jpath, os.path.dirname(jpath), groups)(
        points, boxes, labels, class_names, np.random.default_rng(seed))
    got = tgt.ObjectSampler(tpath, os.path.dirname(tpath), groups)(
        points, boxes, labels, class_names, np.random.default_rng(seed))
    for name, g, w in zip(("points", "boxes", "labels"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    pasted = len(want[1]) - len(boxes)
    assert pasted > 0, case
    if case == "collision_heavy":
        with open(jpath, "rb") as f:
            pools = {k: len(v) for k, v in pickle.load(f).items()}
        asked = sum(min(8 - int((np.asarray(infos[0]["gt_names"]) == k).sum()), pools.get(k, 0)) for k in CLASSES)
        assert pasted < asked, (pasted, asked)  # some candidates were rejected


@pytest.fixture(scope="module")
def tiny_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("nusc"))
    jwrite(root, num_samples=3)
    train, _ = jcreate(root, os.path.join(root, "infos"), version="v1.0-mini")
    return root, train


@pytest.mark.parametrize("epoch", [0, 1])
def test_gt_paste_in_train_samples_matches_jax(tiny_tree, db, epoch):
    """The dataset with GT paste (``fade_epoch`` 1) against JAX's, sample by
    sample: at epoch 0 the paste fires, at epoch 1 the Fading hook has
    removed it and the samples are those of a dataset without a sampler."""
    _, info_path = tiny_tree
    _, jdb, tdb = db
    # set directly: apply_overrides leaves a field whose default is None a
    # string, in both packages
    jcfg, tcfg = (dataclasses.replace(c, data=dataclasses.replace(c.data, fade_epoch=1)) for c in _cfgs())
    groups = {"car": 3, "pedestrian": 3, "barrier": 2}
    jds = JDataset(jcfg, info_path, train=True, use_cbgs=False, gt_database=jdb, sample_groups=groups)
    tds = TDataset(tcfg, info_path, train=True, use_cbgs=False, gt_database=tdb, sample_groups=groups)
    plain = TDataset(tcfg, info_path, train=True, use_cbgs=False)
    pasted = 0
    for i in range(len(tds)):
        for ds in (jds, tds, plain):
            ds.epoch = epoch
        want, got, bare = jds[i], tds[i], plain[i]
        _compare_samples(want, got, tcfg)
        pasted += int(got["gt_mask"].sum() - bare["gt_mask"].sum())
        if epoch >= 1:
            for k in ("points", "gt_boxes", "gt_labels", "gt_mask", "lidar_aug"):
                np.testing.assert_array_equal(got[k], bare[k], err_msg=k)
    assert (pasted > 0) == (epoch == 0), pasted


@pytest.mark.parametrize("mono3d", [True, False])
def test_export_2d_annotation_matches_jax(tiny_tree, tmp_path, mono3d):
    root, info_path = tiny_tree
    outs = []
    for name, fn in (("jax", janno.export_2d_annotation), ("port", tanno.export_2d_annotation)):
        os.makedirs(tmp_path / name)
        copy = str(tmp_path / name / os.path.basename(info_path))
        shutil.copy(info_path, copy)
        outs.append(fn(root, copy, "v1.0-mini", mono3d=mono3d))
    assert os.path.basename(outs[0]) == os.path.basename(outs[1])
    want, got = (json.load(open(p)) for p in outs)
    assert got == want
    assert len(want["annotations"]) > 0 and len(want["images"]) == 3 * 6


@pytest.mark.parametrize("num_samples,seed", [(3, 0), (2, 4)])
def test_write_synthetic_nuscenes_matches_jax(tmp_path, num_samples, seed):
    jroot, troot = str(tmp_path / "jax"), str(tmp_path / "port")
    jwrite(jroot, num_samples=num_samples, seed=seed)
    twrite(troot, num_samples=num_samples, seed=seed, device="cpu")
    want = sorted(os.path.relpath(os.path.join(d, f), jroot) for d, _, fs in os.walk(jroot) for f in fs)
    got = sorted(os.path.relpath(os.path.join(d, f), troot) for d, _, fs in os.walk(troot) for f in fs)
    assert got == want and any(f.endswith(".jpg") for f in want)
    for rel in want:
        assert filecmp.cmp(os.path.join(jroot, rel), os.path.join(troot, rel), shallow=False), rel


@pytest.mark.parametrize("mode", ["synthetic", "nuscenes"])
def test_create_data_cli_matches_jax(tmp_path, mode):
    """The CLI's pkls and annotations against the JAX functions run on the
    same tree (the CLI writes the tree in ``synthetic`` mode; the JAX writer
    writes it in ``nuscenes`` mode)."""
    root, out = str(tmp_path / "nusc"), str(tmp_path / "port")
    if mode == "synthetic":
        argv = ["synthetic", "--root", root, "--out", out, "--num-samples", "3", "--device", "cpu"]
    else:
        jwrite(root, num_samples=3, seed=1)
        argv = ["nuscenes", "--root", root, "--out", out, "--version", "v1.0-mini"]
    written = create_data.main(argv + ["--gt-database", "--export-2d"])
    assert [os.path.basename(p) for p in written] == [
        "nuscenes_infos_mini_train.pkl", "nuscenes_infos_mini_val.pkl", "nuscenes_infos_mini_train_mono3d.coco.json",
        "nuscenes_infos_mini_val_mono3d.coco.json", "gt_database_infos.pkl"]

    jout = str(tmp_path / "jax")
    jpaths = jcreate(root, jout, version="v1.0-mini", max_sweeps=10)
    for jp, tp in zip(jpaths, written[:2]):
        with open(jp, "rb") as f:
            want = pickle.load(f)
        with open(tp, "rb") as f:
            _assert_same(pickle.load(f), want)
        with open(janno.export_2d_annotation(root, jp, "v1.0-mini")) as f:
            want = json.load(f)
        with open(tp[: -len(".pkl")] + "_mono3d.coco.json") as f:
            assert json.load(f) == want
    jdb = jgt.create_gt_database(load_infos(jpaths[0]), jout, num_sweeps=10)
    want, n = _assert_same_database(jdb, written[-1])
    assert n > 0 and len(load_infos(jpaths[0])) == 3


def test_create_data_synthetic_needs_a_card_unless_told(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        create_data.main(["synthetic", "--root", str(tmp_path / "nusc")])

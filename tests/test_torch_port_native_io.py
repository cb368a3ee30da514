"""The port's native sweep reader (``data/native``) against the JAX
package's, on the CPU.

Clouds of 20 000 points in +-50 m; sweeps rotated by yaws of a few
hundredths of a radian and moved by translations that float32 cannot hold,
as real nuScenes sweeps are (the synthetic trees give every sweep an
identity rotation, which hides the difference):

- ``assemble_points`` equals JAX's ``native.assemble_points`` bit for bit,
  plain, with the range filter, and with the splitmix64 shuffle (seed 7);
- ``load_sweep_points`` equals JAX's default ``load_sweep_points`` (its
  native path) bit for bit; the float32 numpy version is within 1e-5 m of
  both and not equal to them;
- ``build_sample`` on a tree whose sweeps were rotated gives JAX's points
  exactly, in eval and in train;
- two processes building the library at once each load a whole library;
  a failed build raises with the compiler's output; a missing cloud raises.
"""

import copy
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

from deepinteraction_tpu.configs import apply_overrides as japply
from deepinteraction_tpu.configs import tiny_config as jtiny
from deepinteraction_tpu.data import native as jnative
from deepinteraction_tpu.data import pipeline as jpipe
from deepinteraction_tpu.data.nuscenes_converter import create_nuscenes_infos as jcreate
from deepinteraction_tpu.utils.synthetic_nuscenes import write_synthetic_nuscenes
from deepinteraction_tpu_torch.configs import apply_overrides as tapply
from deepinteraction_tpu_torch.configs import tiny_config as ttiny
from deepinteraction_tpu_torch.data import native
from deepinteraction_tpu_torch.data import pipeline as tpipe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SWEEPS = 3


def _yaw(rad):
    c, s = np.cos(rad), np.sin(rad)
    return [[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]]


def _sweeps(rng, paths, key_ts):
    return [{"data_path": p, "sensor2lidar_rotation": _yaw(rng.uniform(-0.05, 0.05)),
             "sensor2lidar_translation": list(rng.uniform(-3, 3, 3) + 1e-9), "timestamp": key_ts - 50000 * (i + 1)}
            for i, p in enumerate(paths)]


@pytest.fixture(scope="module")
def clouds(tmp_path_factory):
    d = tmp_path_factory.mktemp("clouds")
    rng = np.random.default_rng(0)
    paths = []
    for i in range(1 + N_SWEEPS):
        pts = rng.uniform(-50, 50, (20000, 5)).astype(np.float32)
        pts[:, 3] = rng.uniform(0, 255, 20000)
        path = str(d / f"cloud{i}.bin")
        pts.tofile(path)
        paths.append(path)
    key_ts = 1533151603547590
    info = {"lidar_path": paths[0], "timestamp": key_ts, "sweeps": _sweeps(rng, paths[1:], key_ts)}
    return paths, info


def _native_args(info):
    rots = np.stack([np.eye(3)] + [np.asarray(s["sensor2lidar_rotation"]) for s in info["sweeps"]])
    trans = np.stack([np.zeros(3)] + [np.asarray(s["sensor2lidar_translation"]) for s in info["sweeps"]])
    ts = np.asarray([0.0] + [(info["timestamp"] - s["timestamp"]) / 1e6 for s in info["sweeps"]])
    return rots, trans, ts


@pytest.mark.parametrize("pcr,shuffle", [
    ((-1e9, -1e9, -1e9, 1e9, 1e9, 1e9), False),
    ((-30.0, -40.0, -5.0, 30.0, 40.0, 3.0), False),
    ((-30.0, -40.0, -5.0, 30.0, 40.0, 3.0), True),
])
def test_assemble_points_bit_equal_jax(clouds, pcr, shuffle):
    paths, info = clouds
    assert jnative.available()
    rots, trans, ts = _native_args(info)
    cap = 90000
    want = jnative.assemble_points(paths, rots, trans, ts, pcr, cap, shuffle=shuffle, seed=7)
    got = native.assemble_points(paths, rots, trans, ts, pcr, cap, shuffle=shuffle, seed=7)
    assert got[2] == want[2] and 0 < got[2] < cap
    assert got[0].tobytes() == want[0].tobytes()
    assert np.array_equal(got[1], want[1])


def test_load_sweep_points_bit_equal_jax(clouds):
    """JAX's default path is its native reader; the port's parent tree read
    sweeps in float32 numpy and failed this test."""
    _, info = clouds
    assert jpipe.USE_NATIVE_IO and jnative.available()
    want = jpipe.load_sweep_points(info, 10, None)
    got = tpipe.load_sweep_points(info, 10, None)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape == (20000 * (1 + N_SWEEPS), 5)
    assert got.tobytes() == want.tobytes()


def test_plain_version_within_1e5(clouds):
    _, info = clouds
    plain = tpipe.load_sweep_points_plain(info, 10, None)
    for ref in (tpipe.load_sweep_points(info, 10, None), jpipe.load_sweep_points(info, 10, None)):
        assert plain.shape == ref.shape
        np.testing.assert_allclose(plain, ref, rtol=0, atol=1e-5)
        assert not np.array_equal(plain, ref), "the rotated sweeps should round differently in float32"


@pytest.fixture(scope="module")
def rotated_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("nusc"))
    write_synthetic_nuscenes(root, num_samples=3)
    _, val = jcreate(root, os.path.join(root, "infos"), version="v1.0-mini", val_scene_names={"scene-9001"})
    with open(val, "rb") as f:
        infos = pickle.load(f)["infos"]
    rng = np.random.default_rng(3)
    out = []
    for info in infos:
        info = copy.deepcopy(info)
        for s in info["sweeps"]:
            s["sensor2lidar_rotation"] = _yaw(rng.uniform(-0.05, 0.05))
            s["sensor2lidar_translation"] = list(np.asarray(s["sensor2lidar_translation"]) + rng.uniform(-2, 2, 3))
        out.append(info)
    assert sum(len(info["sweeps"]) for info in out) >= 2
    return out


@pytest.mark.parametrize("train,seed", [(False, 0), (True, 1)])
def test_build_sample_rotated_sweeps_equal_jax(rotated_tree, train, seed):
    six = {"data.num_views": "6"}
    jcfg, tcfg = japply(jtiny(), six), tapply(ttiny(), six)
    for info in rotated_tree:
        want = jpipe.build_sample(info, jcfg, train, np.random.default_rng(seed))
        got = tpipe.build_sample(info, tcfg, train, np.random.default_rng(seed))
        for k in ("points", "points_mask"):
            assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes(), k


def test_two_processes_build_at_once(clouds, tmp_path):
    """Each of two processes started together compiles into the same empty
    directory and loads a whole library; one library is left, no partial
    file."""
    paths, info = clouds
    build_dir = str(tmp_path / "build")
    code = (
        "import sys, numpy as np\n"
        "from deepinteraction_tpu_torch.data import native\n"
        "lib = native.load(native.build(sys.argv[1]))\n"
        "rots = np.stack([np.eye(3)] * 2); trans = np.zeros((2, 3)); ts = np.zeros(2)\n"
        "pts, mask, n = native.assemble_points(sys.argv[2:4], rots, trans, ts, (-1e9,) * 3 + (1e9,) * 3, 50000,"
        " lib=lib)\n"
        "print(n, float(pts[:n].sum()))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", code, build_dir, *paths[:2]], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env, cwd=REPO) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    assert outs[0][0] == outs[1][0] and outs[0][0].split()[0] == "40000"
    assert os.listdir(build_dir) == [os.path.basename(native.library_path(build_dir))]


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "points_io.cpp"
    bad.write_text("int assemble_points( {\n")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed .*error:"):
        native.build(str(tmp_path / "build"))
    assert os.listdir(tmp_path / "build") == []


def test_missing_cloud_raises(clouds, tmp_path):
    paths, _ = clouds
    with pytest.raises(OSError, match="cannot read"):
        native.assemble_points([paths[0], str(tmp_path / "none.bin")], np.stack([np.eye(3)] * 2), np.zeros((2, 3)),
                               np.zeros(2), (-1e9,) * 3 + (1e9,) * 3, 50000)

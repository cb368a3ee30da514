"""The port's eval-side tools against their JAX counterparts, on the CPU.

- ``utils/fuse_bn.py::fuse_conv_bn`` on ``tiny_config``, ``tiny_pp_config``
  and ``tiny_lidar_config`` with random BN affines and statistics: the same
  pair count as JAX ``fuse_conv_bn`` on the same weights (the port's tree
  through ``flax_from_params``), the folded weights equal to JAX's folded
  tree (through ``params_from_flax``) at 1e-6, and the folded model's eval
  outputs equal to the unfolded model's at 1e-4 of scale;
- ``tools/misc_tools.py fuse_conv_bn`` on a saved checkpoint: the saved
  weights are the folded ones;
- ``tools/ensemble.py`` over two members made from the same numpy arrays:
  its fused pkl (boxes at 1e-6, the same names and scores) and its metrics
  equal JAX ``tools/ensemble.py``'s;
- ``print_config``'s JSON equals JAX's for every config name;
- ``tools/analyze_logs.py cal_train_time`` prints what JAX's prints on one
  ``train_log.jsonl``, and ``plot_curve`` writes its PNG;
- ``visualize_results`` and ``browse_dataset`` write one PNG a sample up to
  ``--limit`` (skipped without matplotlib).
"""

import argparse
import copy
import json
import os
import pickle
import sys

import numpy as np
import pytest
import torch

from deepinteraction_tpu.eval.nuscenes_metrics import DetectionFrame as JaxFrame
from deepinteraction_tpu.utils.fuse_bn import fuse_conv_bn as jax_fuse_conv_bn
from deepinteraction_tpu_torch.convert import flax_from_params, params_from_flax
from deepinteraction_tpu_torch.data.nuscenes_converter import create_nuscenes_infos
from deepinteraction_tpu_torch.eval.nuscenes_metrics import DetectionFrame
from deepinteraction_tpu_torch.models.detector import DeepInteraction
from deepinteraction_tpu_torch.models.layers import BatchNorm
from deepinteraction_tpu_torch.tools import analyze_logs, ensemble, misc_tools
from deepinteraction_tpu_torch.tools.test import CONFIGS
from deepinteraction_tpu_torch.train.checkpoint import load_weights, save_checkpoint
from deepinteraction_tpu_torch.train.step import TrainStep
from deepinteraction_tpu_torch.utils.fuse_bn import fuse_conv_bn
from deepinteraction_tpu_torch.utils.synthetic import init_weights, make_synthetic_batch, to_torch
from deepinteraction_tpu_torch.utils.synthetic_nuscenes import write_synthetic_nuscenes

torch.set_num_threads(1)

FOLD_TOL = 1e-6  # the port's folded weights against JAX's
HEAD_TOL = 1e-4  # folded against unfolded eval outputs, of scale
NAMES = ("car", "pedestrian", "barrier")


def _unflatten(flat):
    tree = {}
    for path, arr in flat.items():
        *parents, leaf = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return tree


def _model_with_random_bn(cfg, seed=1):
    model = DeepInteraction(cfg.model, cfg.data.padded_img_shape, cfg.test_num_proposals).eval()
    init_weights(model, seed=seed)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                c = m.weight.numel()
                for t, draw in ((m.weight, rng.uniform(0.5, 1.5, c)), (m.bias, 0.1 * rng.normal(size=c)),
                                (m.running_mean, 0.1 * rng.normal(size=c)), (m.running_var, rng.uniform(0.5, 2.0, c))):
                    t.copy_(torch.from_numpy(draw.astype(np.float32)))
    return model


@pytest.mark.parametrize("name", ["tiny", "tiny_pp", "tiny_lidar"])
def test_fuse_conv_bn_equals_jax(name):
    cfg = CONFIGS[name]()
    model = _model_with_random_bn(cfg)
    tree = _unflatten(flax_from_params(model))
    jp, js, jn = jax_fuse_conv_bn(tree["params"], tree["batch_stats"])
    folded = copy.deepcopy(model)
    n = fuse_conv_bn(folded)
    assert n == jn and n > 0, (n, jn)
    want = params_from_flax({"params": jp, "batch_stats": js}, model)
    got = folded.state_dict()
    changed = 0
    for k, t in want.items():
        np.testing.assert_allclose(got[k].numpy(), t.numpy(), rtol=FOLD_TOL, atol=FOLD_TOL, err_msg=k)
        changed += not torch.equal(got[k], model.state_dict()[k])
    assert changed >= 4 * n  # weight, BN weight, bias, mean and var of each pair

    batch = to_torch(make_synthetic_batch(cfg, b=1, seed=1), "cpu")
    a, b = model(batch), folded(batch)
    for k, t in a.items():
        if t.is_floating_point() and t.numel():
            err = (b[k] - t).abs().max().item()
            assert err <= HEAD_TOL * t.abs().max().item(), (k, err)


def test_misc_tools_fuse_conv_bn_writes_the_folded_checkpoint(tmp_path):
    cfg = CONFIGS["tiny"]()
    model = _model_with_random_bn(cfg, seed=2)
    src = str(tmp_path / "src")
    save_checkpoint(src, TrainStep(cfg, model, 1, device="cpu"))
    misc_tools.main(["fuse_conv_bn", "tiny", "--checkpoint", src, "--out", str(tmp_path / "fused")])
    want = copy.deepcopy(model)
    fuse_conv_bn(want)
    got = load_weights(str(tmp_path / "fused"), copy.deepcopy(model))
    for k, t in want.state_dict().items():
        assert torch.equal(got.state_dict()[k], t), k


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The tiny synthetic tree (3 samples with GT) and two ensemble members
    made from the same arrays, written once with the port's frame class and
    once with JAX's."""
    root = str(tmp_path_factory.mktemp("nusc"))
    write_synthetic_nuscenes(root, num_samples=3, device="cpu")
    infos_pkl, _ = create_nuscenes_infos(root, root, version="v1.0-mini", val_scene_names=set())
    with open(infos_pkl, "rb") as f:
        tokens = [i["token"] for i in sorted(pickle.load(f)["infos"], key=lambda i: i["timestamp"])]
    rng = np.random.default_rng(0)
    arrays = []
    for _ in range(2):
        member = []
        for _ in tokens:
            n = 6
            boxes = np.concatenate([rng.uniform(-8, 8, (n, 3)), rng.uniform(0.5, 4, (n, 3)),
                                    rng.uniform(-3, 3, (n, 1))], 1)
            member.append((boxes, rng.normal(size=(n, 2)), np.asarray(rng.choice(NAMES, n)), rng.uniform(0, 1, n)))
        arrays.append(member)
    arrays[1] = [(b0 + 0.05, v, nm, s) for (b0, v, nm, s) in arrays[0]]  # the same objects, moved a little
    paths = {}
    for kind, cls in (("port", DetectionFrame), ("jax", JaxFrame)):
        for i, member in enumerate(arrays):
            frames = [cls(boxes=b, velocity=v, names=nm, scores=s, attributes=np.asarray([""] * len(b)))
                      for b, v, nm, s in member]
            paths[kind, i] = str(tmp_path_factory.getbasetemp() / f"{kind}{i}.pkl")
            with open(paths[kind, i], "wb") as f:
                pickle.dump({"tokens": tokens, "frames": frames}, f)
    return root, infos_pkl, tokens, paths


def test_ensemble_equals_jax(tree, tmp_path, capsys, monkeypatch):
    from tools import ensemble as jax_ensemble

    _, infos_pkl, tokens, paths = tree
    outs = {k: str(tmp_path / f"{k}.pkl") for k in ("port", "jax")}
    metrics = ensemble.main([paths["port", 0], paths["port", 1], "--infos", infos_pkl, "--out", outs["port"]])
    assert json.loads(capsys.readouterr().out) == metrics
    monkeypatch.setattr(sys, "argv", ["ensemble.py", paths["jax", 0], paths["jax", 1], "--infos", infos_pkl,
                                      "--out", outs["jax"]])
    jax_ensemble.main()
    assert json.loads(capsys.readouterr().out) == metrics
    assert metrics["mAP"] > 0
    fused = {}
    for k, path in outs.items():
        with open(path, "rb") as f:
            fused[k] = pickle.load(f)
    assert fused["port"]["tokens"] == fused["jax"]["tokens"] == tokens
    for a, b in zip(fused["port"]["frames"], fused["jax"]["frames"]):
        assert len(a.boxes) and len(a.boxes) == len(b.boxes)
        np.testing.assert_allclose(a.boxes, b.boxes, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(a.velocity, b.velocity, rtol=1e-6, atol=1e-6)
        assert np.array_equal(a.names, b.names) and np.array_equal(a.scores, b.scores)
        assert np.array_equal(a.attributes, b.attributes)


@pytest.mark.parametrize("name", ["fusion_base", "fusion_plusplus", "lidar_only", "tiny", "tiny_pp", "tiny_lidar"])
def test_print_config_equals_jax(name, capsys):
    from tools import misc_tools as jax_misc

    misc_tools.main(["print_config", name])
    got = capsys.readouterr().out
    jax_misc.print_config(argparse.Namespace(config=name))
    assert json.loads(got) == json.loads(capsys.readouterr().out)


def test_analyze_logs_equals_jax(tmp_path, capsys):
    from tools import analyze_logs as jax_logs

    rng = np.random.default_rng(3)
    log = str(tmp_path / "train_log.jsonl")
    with open(log, "w") as f:
        for step in range(1, 8):
            f.write(json.dumps({"loss_total": float(rng.uniform(1, 9)), "loss_heatmap": float(rng.uniform()),
                                "grad_norm": float(rng.uniform()), "epoch": 0, "iter": step, "step": step,
                                "time": float(rng.uniform(0.1, 1)), "data_time": float(rng.uniform(0, 0.1))}) + "\n")
    analyze_logs.main(["cal_train_time", log])
    got = capsys.readouterr().out
    jax_logs.cal_train_time(jax_logs.load(log))
    assert got == capsys.readouterr().out and got.startswith("iter time: mean")


def test_visualisers_write_one_png_a_sample(tree, tmp_path):
    pytest.importorskip("matplotlib")
    root, infos_pkl, tokens, paths = tree
    viz = tmp_path / "viz"
    misc_tools.main(["visualize_results", "--detections", paths["port", 0], "--infos", infos_pkl,
                     "--out", str(viz), "--limit", "2"])
    assert sorted(os.listdir(viz)) == sorted(f"{t}.png" for t in tokens[:2])
    browse = tmp_path / "browse"
    misc_tools.main(["browse_dataset", "tiny", "--infos", infos_pkl, "--out", str(browse)])
    assert sorted(os.listdir(browse)) == [f"sample{i}.png" for i in range(len(tokens))]
    curve = tmp_path / "curve.png"
    log = tmp_path / "train_log.jsonl"
    log.write_text("".join(json.dumps({"step": s, "loss_total": 1.0 / s}) + "\n" for s in range(1, 4)))
    analyze_logs.main(["plot_curve", str(log), "--out", str(curve)])
    assert curve.stat().st_size > 0

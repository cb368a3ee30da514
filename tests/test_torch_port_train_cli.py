"""The port's train and benchmark CLIs, on the CPU.

The train CLI's numerics are ``train/step.py::TrainStep``'s, which
``tests/test_torch_port_train.py`` and ``tests/test_torch_port_fusion_train.py``
hold to JAX ``make_train_step``; here the CLI is held to ``TrainStep``, on
a tiny tree written by ``write_synthetic_nuscenes`` (3 samples of one
scene, 6 cameras of 32x24; CBGS draws 2 of them an epoch):

- ``python -m deepinteraction_tpu_torch.tools.train tiny_lidar --device
  cpu --num-workers 0`` for 3 epochs of 2 steps, with ``--eval-infos`` and
  ``--profile-steps 1``: its first step's losses and ``grad_norm`` equal
  ``TrainStep`` called directly on the loader's first batch with the same
  weights and dropout seed (rtol 1e-6); the ``train_log.jsonl`` keys are
  the step's metric names (JAX's, as the train-step test holds them) plus
  ``epoch, iter, step, time, data_time``, and ``tools/analyze_logs.py``
  reads the log; a profiler trace of step 5; ``config.json``;
- ``--resume-from`` a copy of its epoch-0 checkpoint (with
  ``--tensorboard`` and no tensorboard package: it says so and goes on):
  it continues at step 2, writes epoch 1's and 2's lines with the uninterrupted run's losses,
  and ends with the uninterrupted run's weights and optimizer state (lr,
  betas, Adam's moments) exactly;
- each epoch's ``eval_log.jsonl`` line holds the metrics of
  ``tools/test.py::evaluate`` on the epoch's checkpoint at the train-time
  proposal count, and the metric keys of ``tools.test``;
- ``python -m deepinteraction_tpu_torch.tools.benchmark tiny --synthetic
  --device cpu`` in eval and ``--train`` mode prints its JSON line;
- each CLI needs a card unless given ``--device cpu``.
"""

import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from deepinteraction_tpu_torch.configs import apply_overrides, tiny_lidar_config
from deepinteraction_tpu_torch.data import DataLoader, NuScenesDataset
from deepinteraction_tpu_torch.data.nuscenes_converter import create_nuscenes_infos
from deepinteraction_tpu_torch.levers import EvalLevers
from deepinteraction_tpu_torch.models.detector import DeepInteraction
from deepinteraction_tpu_torch.ops.images import to_device
from deepinteraction_tpu_torch.tools import benchmark, get_flops, trace_model, train
from deepinteraction_tpu_torch.tools import test as test_cli
from deepinteraction_tpu_torch.train.checkpoint import load_weights
from deepinteraction_tpu_torch.train.step import TrainStep
from deepinteraction_tpu_torch.utils.synthetic import init_weights
from deepinteraction_tpu_torch.utils.synthetic_nuscenes import write_synthetic_nuscenes

torch.set_num_threads(1)

OPTIONS = {"data.num_views": "6", "optim.total_epochs": "3", "optim.log_interval_steps": "1"}
LOG_EXTRA = {"epoch", "iter", "step", "time", "data_time"}


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("nusc"))
    write_synthetic_nuscenes(root, num_samples=3, device="cpu")
    train_pkl, _ = create_nuscenes_infos(root, os.path.join(root, "train"), version="v1.0-mini",
                                         val_scene_names=set())
    _, val_pkl = create_nuscenes_infos(root, os.path.join(root, "val"), version="v1.0-mini",
                                       val_scene_names={"scene-9001"})
    return train_pkl, val_pkl


def _train(argv):
    return train.main(argv + ["--device", "cpu", "--num-workers", "0", "--cfg-options",
                              *(f"{k}={v}" for k, v in OPTIONS.items())])


def _rows(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def run(trees, tmp_path_factory):
    """The uninterrupted run: 3 epochs of 2 steps, evaluated every epoch,
    step 5 profiled."""
    train_pkl, val_pkl = trees
    work = str(tmp_path_factory.mktemp("train"))
    summary = _train(["tiny_lidar", "--infos", train_pkl, "--work-dir", work, "--eval-infos", val_pkl,
                      "--profile-steps", "1"])
    return work, summary


def test_train_cli_first_step_equals_train_step(trees, run):
    train_pkl, _ = trees
    work, summary = run
    assert summary["first_step"] == 0 and summary["steps"] == summary["last_step"] == 6
    cfg = apply_overrides(tiny_lidar_config(), OPTIONS)
    dataset = NuScenesDataset(cfg, train_pkl, train=True, use_cbgs=cfg.data.use_cbgs, seed=0)
    assert len(dataset) == 2  # CBGS: one draw per class present
    host = next(DataLoader(dataset, cfg.data.samples_per_device, num_workers=0).epoch(0))
    model = DeepInteraction(cfg.model, cfg.data.padded_img_shape)
    init_weights(model, seed=0)
    step = TrainStep(cfg, model, total_steps=6, device="cpu")
    want = {k: v.item() for k, v in step(to_device(host, cfg.data, "cpu"), torch.Generator().manual_seed(0)).items()}
    first = _rows(os.path.join(work, "train_log.jsonl"))[0]
    assert set(first) == set(want) | LOG_EXTRA
    assert {"loss_total", "loss_heatmap", "matched_ious", "grad_norm"} <= set(want)
    for k, v in want.items():
        np.testing.assert_allclose(first[k], v, rtol=1e-6, err_msg=k)
    assert (first["epoch"], first["iter"], first["step"]) == (0, 1, 1)
    assert first["time"] > 0 and first["data_time"] > 0


def test_train_cli_logs_and_trace(run, capsys):
    from tools.analyze_logs import cal_train_time, load

    work, _ = run
    rows = _rows(os.path.join(work, "train_log.jsonl"))
    assert [(r["epoch"], r["iter"], r["step"]) for r in rows] == [(e, i, 2 * e + i) for e in range(3) for i in (1, 2)]
    keys = set(rows[0])
    assert all(set(r) == keys for r in rows)
    assert all(np.isfinite(v) for r in rows for v in r.values())
    cal_train_time(load(os.path.join(work, "train_log.jsonl")))
    assert "iter time: mean" in capsys.readouterr().out
    with open(os.path.join(work, "config.json")) as f:
        assert json.load(f) == {"config": "tiny_lidar", "overrides": OPTIONS}
    assert os.path.getsize(os.path.join(work, "trace", "trace.json")) > 0
    assert sorted(os.listdir(os.path.join(work, "ckpts"))) == ["step_2.pt", "step_4.pt", "step_6.pt"]


def test_train_cli_resume_continues_at_the_saved_step(trees, run, tmp_path, monkeypatch, capsys):
    train_pkl, _ = trees
    work, _ = run
    saved = str(tmp_path / "saved")
    os.makedirs(saved)
    shutil.copy(os.path.join(work, "ckpts", "step_2.pt"), saved)
    resumed = str(tmp_path / "resumed")
    # --tensorboard without the tensorboard package: a line, and training goes on
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    summary = _train(["tiny_lidar", "--infos", train_pkl, "--work-dir", resumed, "--resume-from", saved,
                      "--tensorboard"])
    assert "tensorboard logging requested but tensorboard unavailable" in capsys.readouterr().out
    assert (summary["first_step"], summary["last_step"]) == (2, 6)
    got, want = _rows(os.path.join(resumed, "train_log.jsonl")), _rows(os.path.join(work, "train_log.jsonl"))[2:]
    assert [(r["epoch"], r["step"]) for r in got] == [(r["epoch"], r["step"]) for r in want] == [(1, 3), (1, 4),
                                                                                                 (2, 5), (2, 6)]
    for g, w in zip(got, want):
        for k in set(w) - {"time", "data_time"}:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-6, err_msg=k)
    a = torch.load(os.path.join(resumed, "ckpts", "step_6.pt"), weights_only=True)
    b = torch.load(os.path.join(work, "ckpts", "step_6.pt"), weights_only=True)
    assert a["step"] == b["step"] == 6
    for k, v in b["model"].items():
        assert torch.equal(a["model"][k], v), k
    ga, gb = a["optimizer"]["param_groups"][0], b["optimizer"]["param_groups"][0]
    cfg = apply_overrides(tiny_lidar_config(), OPTIONS)
    schedule = TrainStep(cfg, DeepInteraction(cfg.model, cfg.data.padded_img_shape), 6, "cpu")
    assert ga["lr"] == gb["lr"] == schedule.lr(5) != schedule.lr(0)  # the 6th update's
    assert ga["betas"] == gb["betas"] == (schedule.b1(5), 0.999)
    for i, s in b["optimizer"]["state"].items():
        for k, v in s.items():
            assert torch.equal(a["optimizer"]["state"][i][k], v), (i, k)


def test_train_cli_eval_log(trees, run):
    _, val_pkl = trees
    work, summary = run
    rows = _rows(os.path.join(work, "eval_log.jsonl"))
    assert [r["epoch"] for r in rows] == [0, 1, 2]
    keys = set(test_cli.main(["tiny_lidar", "--infos", val_pkl, "--device", "cpu", "--num-workers", "0",
                              "--cfg-options", "data.num_views=6"])["metrics"])
    assert all(set(r) == keys | {"epoch"} for r in rows)
    cfg = apply_overrides(tiny_lidar_config(), OPTIONS)
    model = DeepInteraction(cfg.model, cfg.data.padded_img_shape)
    load_weights(os.path.join(work, "ckpts"), model, at=2)
    res = test_cli.evaluate(model, cfg, cfg.model.pts_bbox_head.num_proposals, val_pkl, 0, "cpu")
    assert len(res["frames"]) == 3
    assert res["detections"][0].boxes.shape[1] == cfg.model.pts_bbox_head.num_proposals
    for k, v in res["metrics"].items():
        assert rows[0][k] == pytest.approx(v, rel=1e-6, abs=1e-9), k
    assert summary["eval_launches"] == summary["launches"] == dict.fromkeys(train.launch_counts(), 0)
    assert EvalLevers(**summary["levers"]) == EvalLevers.from_env()  # the settings the model resolved


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_benchmark_cli_prints_its_json_line(mode, capsys):
    argv = ["tiny", "--synthetic", "--device", "cpu", "--samples", "2", "--warmup", "1"]
    record = benchmark.main(argv + (["--train"] if mode == "train" else []))
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last == record
    assert last["mode"] == mode and last["device"] == "cpu" and last["distinct_batches"] == 2
    assert last["ms_per_iter_mean"] > 0 and last["ms_per_iter_median"] > 0 and last["first_iter_s"] > 0
    assert ("steps_per_s" if mode == "train" else "frames_per_s") in last
    assert EvalLevers(**last["levers"]) == EvalLevers.from_env()


@pytest.mark.parametrize("cli", ["train", "benchmark", "get_flops", "trace_model"])
def test_cli_needs_a_card_unless_told(trees, cli):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    main = {"train": train.main, "benchmark": benchmark.main, "get_flops": get_flops.main,
            "trace_model": trace_model.main}[cli]
    argv = ["tiny_lidar", "--infos", trees[0]] if cli in ("train", "benchmark") else ["tiny_lidar"]
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(argv)

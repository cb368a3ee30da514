"""``python -m deepinteraction_tpu_torch.tools.gate_eval`` (the port of
``tools/gate_eval.py``) on the CPU.

- Its tables are the JAX tool's; the environment each gate composes: the
  caller's settings cleared, then the parity set and the gate's own, and
  none at all for ``default``.
- ``diff_dets`` on two hand-made detection pickles: the greedy matching,
  score and centre deltas and label agreement.
- One real run, ``--gates parity default --device cpu``, over the tiny
  tree (3 samples, 6 cameras) with a port checkpoint of random weights:
  both gates evaluate every frame, each reports the settings its model
  resolved, and the table of detections against parity is written.
"""

import importlib.util
import os
import pickle

import numpy as np
import pytest

from deepinteraction_tpu_torch.configs import tiny_config
from deepinteraction_tpu_torch.data.nuscenes_converter import create_nuscenes_infos
from deepinteraction_tpu_torch.eval.nuscenes_metrics import DetectionFrame
from deepinteraction_tpu_torch.levers import ENV, EvalLevers
from deepinteraction_tpu_torch.models.detector import DeepInteraction
from deepinteraction_tpu_torch.tools import gate_eval
from deepinteraction_tpu_torch.train.checkpoint import save_checkpoint
from deepinteraction_tpu_torch.train.step import TrainStep
from deepinteraction_tpu_torch.utils.synthetic import init_weights
from deepinteraction_tpu_torch.utils.synthetic_nuscenes import write_synthetic_nuscenes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool():
    spec = importlib.util.spec_from_file_location("jax_gate_eval", os.path.join(REPO, "tools", "gate_eval.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_tables_and_gate_environments():
    jtool = _jax_tool()
    assert gate_eval.PARITY == jtool.PARITY and gate_eval.GATES == jtool.GATES
    caller = {"PATH": "/bin", "DI_I2P_DEDUPE": "8", "DI_DENSE_BF16": "1", "DI_SPARSE_IMPL": "banded"}
    default = gate_eval.gate_env("default", caller)
    assert default == {"PATH": "/bin"}
    assert EvalLevers.from_env(default) == EvalLevers()
    parity = gate_eval.gate_env("parity", caller)
    assert parity == dict(gate_eval.PARITY, PATH="/bin")
    assert EvalLevers.from_env(parity) == EvalLevers.parity()
    for name, overrides in gate_eval.GATES.items():
        if overrides is None:
            continue
        env = gate_eval.gate_env(name, caller)
        assert env == dict(gate_eval.PARITY, **overrides, PATH="/bin"), name
        got = EvalLevers.from_env(env)
        changed = {k for k in ENV if EvalLevers.parity().as_env()[k] != got.as_env()[k]}
        assert changed == set(overrides) & set(ENV), name
    assert gate_eval.GATES["banded_sparse_conv"].keys() - ENV.keys() == {"DI_SPARSE_IMPL"}
    assert "parity" in gate_eval.TPU_ONLY["banded_sparse_conv"]


def _frame(boxes, scores, names):
    n = len(scores)
    return DetectionFrame(boxes=np.asarray(boxes, np.float32), velocity=np.zeros((n, 2), np.float32),
                          names=np.asarray(names), scores=np.asarray(scores, np.float32),
                          attributes=np.asarray([""] * n))


def test_diff_dets_on_hand_made_pickles(tmp_path):
    box = lambda x, y: [x, y, 0.0, 1.0, 1.0, 1.0, 0.0]  # noqa: E731
    parity = {"tokens": ["a", "b"], "frames": [
        _frame([box(0, 0), box(10, 0)], [0.9, 0.5], ["car", "truck"]),
        _frame([box(5, 5)], [0.7], ["pedestrian"]),
    ]}
    gate = {"tokens": ["a", "b"], "frames": [
        # the nearest unused box pairs with each parity box, best score first
        _frame([box(10.3, 0), box(0.1, 0), box(50, 50)], [0.45, 0.8, 0.99], ["truck", "car", "car"]),
        _frame([box(5, 5.2)], [0.7], ["car"]),
    ]}
    paths = []
    for name, obj in (("parity", parity), ("gate", gate)):
        paths.append(str(tmp_path / f"dets_{name}.pkl"))
        with open(paths[-1], "wb") as f:
            pickle.dump(obj, f)
    s = gate_eval.diff_dets(*paths)
    assert s["pairs"] == 3
    np.testing.assert_allclose(s["score_max"], 0.1, rtol=1e-6)
    np.testing.assert_allclose(s["score_mean"], (0.1 + 0.05 + 0.0) / 3, rtol=1e-5)
    np.testing.assert_allclose(s["center_m_max"], 0.3, rtol=1e-5)
    np.testing.assert_allclose(s["center_m_mean"], (0.1 + 0.3 + 0.2) / 3, rtol=1e-5)
    assert s["label_match"] == pytest.approx(2 / 3)
    assert s == _jax_tool().diff_dets(*paths)
    rows = gate_eval.print_diff_table(str(tmp_path))
    assert set(rows) == {"gate"}


def test_gate_eval_runs_parity_and_default_on_cpu(tmp_path, capsys):
    root = str(tmp_path / "nusc")
    write_synthetic_nuscenes(root, num_samples=3, device="cpu")
    _, val = create_nuscenes_infos(root, root, version="v1.0-mini", val_scene_names={"scene-9001"})
    cfg = tiny_config()
    model = DeepInteraction(cfg.model, cfg.data.padded_img_shape)
    init_weights(model, seed=0)
    ckpt = str(tmp_path / "ckpt")
    save_checkpoint(ckpt, TrainStep(cfg, model, total_steps=1, device="cpu"))
    workdir = str(tmp_path / "gates")
    out = str(tmp_path / "gates.json")
    report = gate_eval.main(["tiny", ckpt, "--infos", val, "--gates", "parity", "default", "--device", "cpu",
                             "--num-workers", "0", "--workdir", workdir, "--out", out,
                             "--cfg-options", "data.num_views=6"])
    rows = {r["gate"]: r for r in report["rows"]}
    assert set(rows) == {"parity", "default"} and all(r["rc"] == 0 for r in rows.values())
    assert EvalLevers(**rows["parity"]["levers"]) == EvalLevers.parity()
    assert EvalLevers(**rows["default"]["levers"]) == EvalLevers()
    for r in rows.values():
        assert 0.0 <= r["mAP"] <= 1.0 and np.isfinite(r["NDS"])
    for name in rows:
        with open(os.path.join(workdir, f"dets_{name}.pkl"), "rb") as f:
            assert len(pickle.load(f)["frames"]) == 3
    assert report["dets"]["default"]["pairs"] > 0
    assert os.path.exists(out) and os.path.exists(out.replace(".json", "_dets.json"))
    printed = capsys.readouterr().out
    assert "| gate | mAP | dmAP | NDS | dNDS |" in printed and "| gate vs parity |" in printed

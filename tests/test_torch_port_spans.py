"""The port's program spans (``utils/spans.py``), on the CPU:

- with no profiler, ``span`` returns one shared null context and
  ``grad_span`` hooks nothing;
- under a CPU profiler, spans are ``cpu_op`` events with their names,
  nested as opened, and ``grad_span`` wraps the backward of its tensor's
  operation (if a torch upgrade moves the category, these cases fail);
- the tiny detector's eval forward opens each layer span, with the table
  builds inside the sparse encoder and I2P and P2I inside MMRI;
- one tiny ``TrainStep`` opens each ``di.train.*`` phase once, in order,
  with the matching inside the targets, and every ``di.sync.*`` site of
  the step inside a phase; under the profiler it computes the same bits.
"""

import json

import pytest
import torch

from deepinteraction_tpu_torch import configs
from deepinteraction_tpu_torch.inference import get_bboxes
from deepinteraction_tpu_torch.tools.benchmark import build_model, synthetic_batches
from deepinteraction_tpu_torch.train.step import TrainStep
from deepinteraction_tpu_torch.utils import spans

PHASES = ["di.train.forward", "di.train.targets", "di.train.loss", "di.train.backward", "di.train.grad_norm",
          "di.train.update"]


def profiled(fn, tmp_path):
    """(fn's result, the ``di.*`` events of its CPU trace in start order)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("name", "").startswith("di.")]
    return out, sorted(events, key=lambda e: (e["ts"], -e["dur"]))


def inside(inner, outer) -> bool:
    return outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def test_spans_off():
    assert spans.span("di.a") is spans.span("di.b") is spans._OFF
    x = torch.ones(3, requires_grad=True)
    y = x * 2
    assert spans.grad_span(y, "di.c") is y
    y.sum().backward()  # no hook was registered: nothing to enter or leave
    assert torch.equal(x.grad, torch.full((3,), 2.0))


def test_spans_are_nested_cpu_ops(tmp_path):
    def work():
        with spans.span("di.outer"):
            a = torch.ones(4) + 1
            with spans.span("di.inner"):
                return a * 2

    out, ev = profiled(work, tmp_path)
    assert torch.equal(out, torch.full((4,), 4.0))
    assert [(e["name"], e["cat"]) for e in ev] == [("di.outer", "cpu_op"), ("di.inner", "cpu_op")]
    assert inside(ev[1], ev[0])


def test_grad_span_wraps_the_backward(tmp_path):
    x = torch.arange(6.0, requires_grad=True)
    mask = x.detach() > 2

    def work():
        with spans.span("di.fwd"):
            y = spans.grad_span(x[mask], "di.fwd.grad")
        with spans.span("di.bwd"):
            (y * y).sum().backward()
        return x.grad

    grad, ev = profiled(work, tmp_path)
    assert torch.equal(grad, torch.where(mask, 2 * x.detach(), torch.zeros(6)))
    by = {e["name"]: e for e in ev}
    assert set(by) == {"di.fwd", "di.fwd.grad", "di.bwd"}
    assert inside(by["di.fwd.grad"], by["di.bwd"])  # the CPU runs the backward on the calling thread


@pytest.fixture(scope="module")
def tiny():
    torch.manual_seed(0)
    cfg = configs.tiny_config()
    return cfg, synthetic_batches(cfg, 1, 1, True, "cpu")[0]


def test_eval_layer_spans(tiny, tmp_path):
    cfg, batch = tiny
    model = build_model(cfg, False, "cpu").eval()
    eval_batch = {k: v for k, v in batch.items() if not k.startswith("gt_")}

    def frame():
        preds = model(eval_batch)
        return get_bboxes(preds, cfg.model.pts_bbox_head, cfg.model.bbox_coder, cfg.test_num_proposals)

    _, ev = profiled(frame, tmp_path)
    names = [e["name"] for e in ev]
    layers = ["di.img_branch", "di.voxelize", "di.sparse_encoder", "di.bev", "di.voxelize", "di.mmri",
              "di.decoder", "di.get_bboxes"]
    assert [n for n in names if n in layers] == layers
    by = {e["name"]: e for e in ev}
    enc, mmri = by["di.sparse_encoder"], by["di.mmri"]
    assert all(inside(e, enc) for e in ev if e["name"] == "di.sparse.tables")
    # a submanifold build a stage, a strided one a sample and downsampling
    assert sum(e["name"] == "di.sparse.tables" for e in ev) == 4 + 4
    assert all(inside(e, mmri) for e in ev if e["name"] in ("di.mmri.i2p", "di.mmri.p2i"))
    assert {"di.sync.voxelize.num_kept", "di.sync.sparse.down_sites", "di.sync.i2p.values",
            "di.sync.coder.center_range"} <= set(names)


def test_train_step_phases_and_syncs(tiny, tmp_path):
    cfg, batch = tiny
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the CPU's scatter-adds sum in thread order
    try:
        _check_train_step(cfg, batch, tmp_path)
    finally:
        torch.set_num_threads(threads)


def _check_train_step(cfg, batch, tmp_path):
    def step_once():
        model = build_model(cfg, True, "cpu")
        step = TrainStep(cfg, model, total_steps=10, device="cpu")
        m = step(batch, torch.Generator().manual_seed(0))
        return {k: v.clone() for k, v in m.items()}, [p.detach().clone() for p in step.params]

    plain = step_once()
    (metrics, params), ev = profiled(step_once, tmp_path)
    # the spans change no bit of the step
    assert all(torch.equal(metrics[k], plain[0][k]) for k in metrics)
    assert all(torch.equal(a, b) for a, b in zip(params, plain[1]))
    phases = [e for e in ev if e["name"] in PHASES]
    assert [e["name"] for e in phases] == PHASES
    assert all(a["ts"] + a["dur"] <= b["ts"] for a, b in zip(phases, phases[1:]))
    by = {e["name"]: e for e in ev}
    assert inside(by["di.train.matching"], by["di.train.targets"])
    syncs = [e for e in ev if e["name"].startswith("di.sync.")]
    assert all(any(inside(s, p) for p in phases) for s in syncs)
    sites = {e["name"] for e in syncs}
    assert {"di.sync.lap.cost", "di.sync.lap.num_gt", "di.sync.lap.assignment", "di.sync.targets.origin",
            "di.sync.targets.extent", "di.sync.loss.code_weights", "di.sync.boxes.bev_corners_x"} <= sites
    assert all(inside(by[n], by["di.train.backward"]) for n in sites if n.endswith(".grad"))
    assert "di.sync.i2p.values.grad" in sites

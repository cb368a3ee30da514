"""``spans.read`` on a hand-written trace of two train steps: the main
thread (tid 10) with the harness's and the hooks' ranges and the program's
spans, the autograd engine's thread (tid 11) launching the backward's
kernels (one by ``cuLaunchKernel``, as cuDNN starts some), one GPU
stream (pid 0, tid 7). Times in us."""

from __future__ import annotations

import pytest

from dibench import spans, trace


def _x(cat, name, tid, ts, dur, pid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid, "ts": ts, "dur": dur, "args": args}


def _trace(program_spans: bool = True) -> dict:
    ev = []
    corr = 0

    def launch(tid, ts, kernel_ts, us, cat="kernel", api="cuda_runtime"):
        nonlocal corr
        corr += 1
        ev.append(_x(api, "cuLaunchKernel" if api == "cuda_driver" else "cudaLaunchKernel", tid, ts, 2,
                     correlation=corr))
        ev.append(_x(cat, f"k{corr}", 7, kernel_ts, us, pid=0, correlation=corr))

    for step in range(2):
        t0 = step * 10000
        ev.append(_x("user_annotation", f"ProfilerStep#{step}", 10, t0, 9000))
        ev.append(_x("user_annotation", "step", 10, t0 + 10, 8900))
        ev.append(_x("user_annotation", "imgpts_neck", 10, t0 + 100, 1900))
        launch(10, t0 + 200, t0 + 300, 1000)  # the forward: [300, 1300]
        launch(10, t0 + 2050, t0 + 2100, 100, "gpu_memcpy")  # the matching's copy: [2100, 2200]
        launch(11, t0 + 3100, t0 + 3200, 400)  # the backward, from the autograd thread: [3200, 3600]
        launch(11, t0 + 3700, t0 + 4000, 500)  # [4000, 4500]
        launch(11, t0 + 3800, t0 + 4600, 100, api="cuda_driver")  # [4600, 4700]
        launch(10, t0 + 6100, t0 + 6200, 300)  # the update: [6200, 6500]
        if program_spans:
            ev += [
                _x("cpu_op", "di.train.forward", 10, t0 + 50, 1950),
                _x("cpu_op", "di.train.targets", 10, t0 + 2000, 1000),
                _x("cpu_op", "di.train.matching", 10, t0 + 2040, 500),
                _x("cpu_op", "di.sync.lap.cost", 10, t0 + 2045, 200),
                _x("cpu_op", "di.train.backward", 10, t0 + 3000, 3000),
                _x("cpu_op", "di.sync.i2p.values.grad", 11, t0 + 3650, 100),
                _x("cpu_op", "di.train.update", 10, t0 + 6000, 1000),
            ]
        # an ATen op on the main thread during the backward's idle gap
        ev.append(_x("cpu_op", "aten::nonzero", 10, t0 + 3650, 100))
    return {"traceEvents": ev}


def test_program_spans():
    got = spans.read(_trace())
    assert set(got) == {"di.train.forward", "di.train.targets", "di.train.matching", "di.sync.lap.cost",
                        "di.train.backward", "di.sync.i2p.values.grad", "di.train.update"}
    # the autograd thread's launches belong to the main thread's backward
    assert got["di.train.backward"]["device_ms"] == pytest.approx(1.0)
    assert got["di.train.forward"]["device_ms"] == pytest.approx(1.0)
    assert got["di.train.update"]["device_ms"] == pytest.approx(0.3)
    # the phases' device ms add up to the step's
    phases = ("di.train.forward", "di.train.targets", "di.train.backward", "di.train.update")
    stats = trace.TraceStats(_trace())
    assert sum(got[p]["device_ms"] for p in phases) == pytest.approx(sum(stats.by_scope.values()) / 2)
    # nested spans count their whole time; copies apart
    assert got["di.train.targets"]["device_ms"] == got["di.train.matching"]["device_ms"] == pytest.approx(0.1)
    assert got["di.sync.lap.cost"]["copy_ms"] == pytest.approx(0.1)
    # idle: the backward's [3000, 6000] less the busy [3200, 3600], [4000, 4500] and [4600, 4700]
    assert got["di.train.backward"]["host_ms"] == pytest.approx(3.0)
    assert got["di.train.backward"]["idle_ms"] == pytest.approx(2.0)
    assert got["di.train.forward"]["idle_ms"] == pytest.approx(1.95 - 1.0)
    assert got["di.sync.lap.cost"]["idle_ms"] == pytest.approx(0.2 - 0.1)
    # a span off the main thread is counted, and has no main-thread time
    assert got["di.sync.i2p.values.grad"] == pytest.approx(
        {"count": 1, "host_ms": 0, "device_ms": 0, "copy_ms": 0, "memset_ms": 0, "idle_ms": 0})
    assert spans.syncs(got) == 2


def test_spans_move_no_scope_metric():
    with_spans, bare = trace.TraceStats(_trace()), trace.TraceStats(_trace(program_spans=False))
    for attr in ("by_scope", "by_name", "launches", "busy_s", "window_s", "iterations"):
        assert getattr(with_spans, attr) == getattr(bare, attr), attr
    assert spans.read(_trace(program_spans=False)) == {}
    # idle gaps name the span the main thread was in, where it was in no operator
    assert with_spans.idle_gaps["step: di.train.backward"] > 0
    assert "step: di.train.backward" not in bare.idle_gaps

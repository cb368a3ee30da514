"""The program's own spans in a ``torch.profiler`` Chrome trace.

The port opens a ``di.*`` span around each layer's work, each phase of its
train step, each neighbour-table build of its sparse encoder and each call
that waits for the device (``di.sync.<site>``); in a trace each is a
``cpu_op`` event on the thread that opened it
(``deepinteraction_tpu_torch/utils/spans.py``). ``trace.TraceStats`` does
not read them (its scopes are ``user_annotation`` ranges), so they move no
metric it computes; they name its idle gaps where the main thread was
inside one and in no ATen operator.

:func:`read` gives, for each span name, per traced iteration:

- ``count``: events of that name on any thread;
- ``host_ms``: its time on the main thread (the lane with the most
  ``user_annotation`` ranges, as ``trace.py`` picks it);
- ``device_ms``: device time of the kernels, copies and memsets whose
  launch (a runtime call or a ``cuLaunchKernel``), on any thread,
  happened while the main thread was inside it (so the autograd
  thread's launches, the recomputed I2P chunks included, fall in
  ``di.train.backward``), with its ``copy_ms`` and ``memset_ms`` parts;
- ``idle_ms``: time the device ran nothing while the main thread was
  inside it.

Nested spans each count their whole time. The arithmetic is
``deepinteraction_tpu_torch/tools/analyze_trace.py::program_spans``'s,
copied so that the yardstick does not move with the program.
"""

from __future__ import annotations

import bisect
import collections
from typing import Dict, List, Tuple

from .trace import DEVICE_CATS, STEP, union

PREFIX = "di."
SYNC_PREFIX = "di.sync."
# a device event's launch: a runtime call, or a cuLaunchKernel (cuDNN and
# cuBLAS start some of their kernels that way)
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def overlap(a: List[Tuple[float, float]], b: List[Tuple[float, float]]) -> float:
    """Total length shared by two sorted lists of disjoint intervals."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def read(trace: dict) -> Dict[str, Dict[str, float]]:
    """{span name: {count, host_ms, device_ms, copy_ms, memset_ms, idle_ms}}
    a traced iteration (a ``ProfilerStep#`` range); {} where the trace has
    no ``di.*`` span."""
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    steps = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                   if e.get("cat") == "user_annotation" and STEP.match(e.get("name", "")))
    if not steps:
        raise ValueError("the trace has no ProfilerStep# range")
    runs, start, end = len(steps), steps[0][0], steps[-1][1]
    lanes = collections.Counter((e["pid"], e["tid"]) for e in events
                                if e.get("cat") == "user_annotation" and not STEP.match(e.get("name", "")))
    main = max(lanes, key=lambda lane: lanes[lane]) if lanes else None
    spans = [e for e in events if e.get("cat") == "cpu_op" and e.get("name", "").startswith(PREFIX)
             and start <= e["ts"] <= end]
    count = collections.Counter(e["name"] for e in spans)
    on_main = collections.defaultdict(list)
    for e in spans:
        if (e["pid"], e["tid"]) == main:
            on_main[e["name"]].append((e["ts"], min(e["ts"] + e.get("dur", 0), end)))
    on_main = {n: union(iv) for n, iv in on_main.items()}
    # the main lane cut where any span opens or closes: the names open in
    # each piece
    marks = sorted((t, d, n) for n, iv in on_main.items() for s, e in iv for t, d in ((s, 1), (e, -1)))
    bounds: List[float] = []
    open_sets: List[frozenset] = []
    depth = collections.Counter()
    for t, d, n in marks:
        depth[n] += d
        now = frozenset(k for k, v in depth.items() if v > 0)
        if bounds and bounds[-1] == t:
            open_sets[-1] = now
        else:
            bounds.append(t)
            open_sets.append(now)
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in LAUNCH_CATS and "correlation" in (e.get("args") or {})}
    device = [e for e in events if e.get("cat") in DEVICE_CATS and start <= e["ts"] <= end]
    dev = {n: collections.Counter() for n in count}
    for e in device:
        launch = launches.get((e.get("args") or {}).get("correlation"))
        i = bisect.bisect_right(bounds, launch["ts"]) - 1 if launch else -1
        for n in open_sets[i] if i >= 0 else ():
            dev[n][e["cat"]] += e.get("dur", 0) / 1e3
    busy = union([(max(e["ts"], start), min(e["ts"] + e.get("dur", 0), end)) for e in device])
    out = {}
    for n in sorted(count):
        iv = on_main.get(n, [])
        host = sum(e - s for s, e in iv) / 1e3
        out[n] = {"count": count[n] / runs, "host_ms": host / runs, "device_ms": sum(dev[n].values()) / runs,
                  "copy_ms": dev[n]["gpu_memcpy"] / runs, "memset_ms": dev[n]["gpu_memset"] / runs,
                  "idle_ms": (host - overlap(iv, busy) / 1e3) / runs}
    return out


def syncs(spans: Dict[str, Dict[str, float]]) -> float:
    """``di.sync.*`` events an iteration: the program's host syncs."""
    return sum(v["count"] for n, v in spans.items() if n.startswith(SYNC_PREFIX))

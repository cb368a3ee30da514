"""Aggregate a ``torch.profiler`` Chrome trace into the PERF.md anatomy
tables (the port's counterpart of ``tools/analyze_trace.py``)::

    python -m deepinteraction_tpu_torch.tools.analyze_trace work_dirs/trace_fusion_base [--iters 3] [--top 25] [--ops]

Reads the newest ``*.json.gz`` or ``*.json`` in the directory (what
``tools/trace_model.py`` writes) and prints the device's kernel time, in
total and per run (a run is one traced iteration: ``--iters``, by default
the number of ``ProfilerStep#`` ranges in the trace), grouped two ways:

- by kernel category: the port's own kernels (K1 ``subm_conv_*`` and its
  ``sum_partials``, K2 ``local_attn_*``), cuDNN convolution, GEMM,
  elementwise/reduce, copy/memset, other (nvJPEG and the rest);
- by source: the ``record_function`` scope (``trace_model`` opens one
  around each top-level module's forward) of the host call that launched
  the kernel. A kernel event carries the ``correlation`` id of its launch
  on the host; the launch's scope is the innermost range on its thread
  that contains it.

Then, by program span (the ``di.*`` ranges the port opens,
``utils/spans.py``), per run: how many times each ran on any thread, its
host ms on the main thread (the one with the most ``record_function``
ranges), the device ms of the kernels, copies and memsets launched, from
any thread, while the main thread was inside it (so the autograd thread's
launches fall in ``di.train.backward``), the copy and memset parts of it,
and the device's idle ms while the main thread was inside it. Nested
spans each count their whole time.

With ``--ops``, the kernels with the most time and their launches per run.
A trace with no GPU lanes (taken on the CPU) falls back to the host's
top-level operator events, and says so. The last line is one JSON object
with the same numbers.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import glob
import gzip
import json
import os
import re
from typing import Dict, List, Optional, Tuple

# (category, pattern on the lower-cased kernel name), first match wins
CATEGORIES = [
    ("port K1 (subm_conv)", r"subm_conv|sum_partials"),
    ("port K2 (local_attn)", r"local_attn"),
    ("copy/memset", r"memcpy|memset|copy"),
    ("cuDNN conv", r"cudnn|conv(?!ert)|fprop|dgrad|wgrad|fft"),
    ("GEMM", r"gemm|cublas|cutlass|xmma|matmul|\bmm\b|addmm|bmm|linear"),
    ("elementwise/reduce", r"elementwise|reduce|at::native|cub::|aten::|softmax|norm|index|scatter|gather|sort"),
]
OTHER = "other (nvJPEG, ...)"
# the port's kernel functions (K2's backward is two: a query and a key pass)
PORT_KERNELS = ("subm_conv_gemm", "subm_conv_bf16", "subm_conv_wgrad", "sum_partials", "local_attn_fwd",
                "local_attn_bwd_query", "local_attn_bwd_key")
STEP = re.compile(r"^ProfilerStep#\d+$")
NO_SCOPE = "(no scope)"
SPAN_PREFIX = "di."


def load_trace(outdir: str) -> dict:
    hits = sorted(glob.glob(os.path.join(outdir, "*.json.gz")) + glob.glob(os.path.join(outdir, "*.json")),
                  key=os.path.getmtime)
    if not hits:
        raise SystemExit(f"no *.json.gz or *.json trace under {outdir}")
    opener = gzip.open if hits[-1].endswith(".gz") else open
    with opener(hits[-1], "rt") as f:
        return json.load(f)


def categorize(name: str) -> str:
    low = name.lower()
    for cat, pat in CATEGORIES:
        if re.search(pat, low):
            return cat
    return OTHER


class Scopes:
    """The innermost ``record_function`` range (not a ``ProfilerStep#``)
    around a host timestamp on a thread."""

    def __init__(self, events):
        self.lanes = collections.defaultdict(list)
        for e in events:
            if e.get("ph") == "X" and e.get("cat") == "user_annotation" and not STEP.match(e.get("name", "")):
                self.lanes[(e["pid"], e["tid"])].append((e["ts"], e["ts"] + e.get("dur", 0), e["name"]))
        self.starts = {}
        for lane, ranges in self.lanes.items():
            ranges.sort()
            self.starts[lane] = [r[0] for r in ranges]

    def at(self, pid, tid, ts: float) -> str:
        lane = (pid, tid)
        if lane not in self.lanes:
            return NO_SCOPE
        ranges = self.lanes[lane]
        # the latest-starting range that still contains ts is the innermost
        for i in range(bisect.bisect_right(self.starts[lane], ts) - 1, -1, -1):
            _, end, name = ranges[i]
            if end >= ts:
                return name
        return NO_SCOPE


def union(intervals) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def overlap(a, b) -> float:
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


def program_spans(events, device, launches, main, start: float, end: float, runs: int) -> Dict[str, Dict]:
    """{span name: {count, host_ms, device_ms, copy_ms, memset_ms, idle_ms}}
    per run, for the ``di.*`` ``cpu_op`` events that start in [start, end]:
    ``main`` is the (pid, tid) lane whose time counts; ``device`` the
    device events of the window and ``launches`` their launch calls by
    correlation id."""
    spans = [e for e in events if e.get("cat") == "cpu_op" and e.get("name", "").startswith(SPAN_PREFIX)
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
    bounds, open_sets, depth = [], [], collections.Counter()
    for t, d, n in marks:
        depth[n] += d
        if bounds and bounds[-1] == t:
            open_sets[-1] = frozenset(k for k, v in depth.items() if v > 0)
        else:
            bounds.append(t)
            open_sets.append(frozenset(k for k, v in depth.items() if v > 0))
    dev = {n: collections.Counter() for n in count}
    for e in device:
        launch = launches.get((e.get("args") or {}).get("correlation"))
        i = bisect.bisect_right(bounds, launch["ts"]) - 1 if launch else -1
        for n in open_sets[i] if i >= 0 else ():
            dev[n][e.get("cat")] += e.get("dur", 0) / 1e3
    busy = union((max(e["ts"], start), min(e["ts"] + e.get("dur", 0), end)) for e in device)
    out = {}
    for n in sorted(count):
        host = sum(e - s for s, e in on_main.get(n, ())) / 1e3
        idle = host - overlap(on_main.get(n, []), busy) / 1e3
        out[n] = {"count": count[n] / runs, "host_ms": host / runs,
                  "device_ms": sum(dev[n].values()) / runs, "copy_ms": dev[n]["gpu_memcpy"] / runs,
                  "memset_ms": dev[n]["gpu_memset"] / runs, "idle_ms": idle / runs}
    return out


def analyze(trace: dict, iters: Optional[int] = None) -> Dict:
    """The numbers ``main`` prints: totals, per-run sums by category, by
    scope and by kernel, launches per run."""
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    steps = [e for e in events if e.get("cat") == "user_annotation" and STEP.match(e.get("name", ""))]
    runs = iters or max(len(steps), 1)
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    scopes = Scopes(events)
    on_gpu = bool(device)
    if on_gpu:
        # a launch is a runtime call or a cuLaunchKernel (cuDNN and cuBLAS
        # start some kernels that way)
        launches = {e["args"]["correlation"]: e for e in events
                    if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in (e.get("args") or {})}

        def scope_of(e):
            launch = launches.get((e.get("args") or {}).get("correlation"))
            return scopes.at(launch["pid"], launch["tid"], launch["ts"]) if launch else NO_SCOPE
        work = device
    else:
        # host operators: the top-level ones of each thread, so nested calls
        # are not counted twice (program spans are not operators)
        ops = sorted((e for e in events if e.get("cat") == "cpu_op" and not e["name"].startswith(SPAN_PREFIX)),
                     key=lambda e: (e["pid"], e["tid"], e["ts"]))
        work, end = [], {}
        for e in ops:
            lane = (e["pid"], e["tid"])
            if e["ts"] >= end.get(lane, float("-inf")):
                work.append(e)
                end[lane] = e["ts"] + e.get("dur", 0)

        def scope_of(e):
            return scopes.at(e["pid"], e["tid"], e["ts"])

    by_cat, by_src, by_op = collections.Counter(), collections.Counter(), collections.Counter()
    n_by_op = collections.Counter()
    total = 0.0
    for e in work:
        ms = e.get("dur", 0) / 1e3
        name = e.get("name", "")
        total += ms
        by_cat[categorize(name)] += ms
        by_src[scope_of(e)] += ms
        by_op[name] += ms
        n_by_op[name] += 1
    window = sum(e.get("dur", 0) for e in steps) / 1e3
    port = {k: sum(n for name, n in n_by_op.items() if k in name) / runs
            for k in PORT_KERNELS}
    # the main thread: the one with the most record_function ranges, else with the most spans
    weight = {lane: len(r) for lane, r in scopes.lanes.items()} or collections.Counter(
        (e["pid"], e["tid"]) for e in events if e.get("name", "").startswith(SPAN_PREFIX))
    main = max(weight, key=weight.get) if weight else None
    start = min((e["ts"] for e in steps), default=float("-inf"))
    end = max((e["ts"] + e.get("dur", 0) for e in steps), default=float("inf"))
    in_window = [e for e in device if start <= e["ts"] <= end]
    spans = program_spans(events, in_window, launches if on_gpu else {}, main, start, end, runs)
    if not on_gpu:
        for v in spans.values():
            for k in ("device_ms", "copy_ms", "memset_ms", "idle_ms"):
                del v[k]
    return {
        "lanes": "device kernels" if on_gpu else "host operators (the trace has no GPU lanes)",
        "runs": runs,
        "total_ms": total,
        "ms_per_run": total / runs,
        "window_ms_per_run": window / runs if steps else None,
        "busy_share": total / window if steps and window else None,
        "by_category_ms_per_run": {k: v / runs for k, v in by_cat.most_common()},
        "by_scope_ms_per_run": {k: v / runs for k, v in by_src.most_common()},
        "top_ops": [[name, ms / runs, n_by_op[name] / runs] for name, ms in by_op.most_common()],
        "port_launches_per_run": port,
        "by_span_per_run": spans,
    }


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description="Aggregate a torch.profiler trace of the PyTorch port")
    ap.add_argument("outdir")
    ap.add_argument("--iters", type=int, default=None,
                    help="traced iterations (divides totals; default: the ProfilerStep ranges in the trace)")
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--ops", action="store_true", help="also print the top kernels")
    args = ap.parse_args(argv)

    res = analyze(load_trace(args.outdir), args.iters)
    it = res["runs"]
    if not res["lanes"].startswith("device"):
        print("no GPU lanes in the trace: host operator time (top-level operators) instead")
    what = "device kernel time" if res["lanes"].startswith("device") else "host operator time"
    print(f"{what}: {res['total_ms']:.1f} ms total, {res['ms_per_run']:.1f} ms/run ({it} runs)")
    if res["busy_share"] is not None:
        print(f"ProfilerStep window: {res['window_ms_per_run']:.1f} ms/run, busy {100 * res['busy_share']:.1f} %")
    print("\nby kernel category (ms/run):")
    for cat, ms in list(res["by_category_ms_per_run"].items())[: args.top]:
        print(f"  {ms:8.1f}  {cat}")
    print("\nby source scope (ms/run):")
    for src, ms in list(res["by_scope_ms_per_run"].items())[: args.top]:
        print(f"  {ms:8.1f}  {src}")
    if res["by_span_per_run"]:
        gpu = res["lanes"].startswith("device")
        print("\nby program span (per run; host ms on the main thread"
              + (", device ms of its launches, copy + memset ms, device idle ms):" if gpu else "):"))
        for name, v in sorted(res["by_span_per_run"].items(), key=lambda kv: -kv[1]["host_ms"])[: args.top]:
            cols = f"  x{v['count']:<6g} {v['host_ms']:8.2f}"
            if gpu:
                cols += f" {v['device_ms']:8.2f} {v['copy_ms'] + v['memset_ms']:7.2f} {v['idle_ms']:8.2f}"
            print(f"{cols}  {name}")
    if args.ops:
        print("\ntop kernels (ms/run, count/run):")
        for name, ms, n in res["top_ops"][: args.top]:
            print(f"  {ms:8.1f}  x{n:<6g} {name[:100]}")
    res["top_ops"] = res["top_ops"][: args.top]
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()

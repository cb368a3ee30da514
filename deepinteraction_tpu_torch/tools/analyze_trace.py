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
from typing import Dict, List, Optional

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
PORT_KERNELS = ("subm_conv_gemm", "subm_conv_wgrad", "sum_partials", "local_attn_fwd", "local_attn_bwd_query",
                "local_attn_bwd_key")
STEP = re.compile(r"^ProfilerStep#\d+$")
NO_SCOPE = "(no scope)"


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
        launches = {e["args"]["correlation"]: e for e in events
                    if e.get("cat") == "cuda_runtime" and "correlation" in (e.get("args") or {})}

        def scope_of(e):
            launch = launches.get((e.get("args") or {}).get("correlation"))
            return scopes.at(launch["pid"], launch["tid"], launch["ts"]) if launch else NO_SCOPE
        work = device
    else:
        # host operators: the top-level ones of each thread, so nested calls
        # are not counted twice
        ops = sorted((e for e in events if e.get("cat") == "cpu_op"), key=lambda e: (e["pid"], e["tid"], e["ts"]))
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
    if args.ops:
        print("\ntop kernels (ms/run, count/run):")
        for name, ms, n in res["top_ops"][: args.top]:
            print(f"  {ms:8.1f}  x{n:<6g} {name[:100]}")
    res["top_ops"] = res["top_ops"][: args.top]
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()

"""Capture a device trace of a model's eval forward (+ box decode), or of
its train step (the port's counterpart of ``tools/trace_model.py``)::

    python -m deepinteraction_tpu_torch.tools.trace_model fusion_base --outdir work_dirs/trace_fb
    python -m deepinteraction_tpu_torch.tools.trace_model lidar_only --train --iters 2
    python -m deepinteraction_tpu_torch.tools.analyze_trace work_dirs/trace_fb

The reference's FPS harness is tools/analysis_tools/benchmark.py:64-91;
this is its trace-capturing sibling. The model, the synthetic batch of one
sample and the iteration are ``tools/benchmark.py``'s
(``build_model``, ``synthetic_batches``, ``make_run``), with random weights
from ``cfg.seed`` or all zero with ``--zeros``. It runs one iteration
(``compile+run``: on the card, cuDNN's autotuning and the kernels' load),
two warm ones, then ``--iters`` under ``torch.profiler`` (CPU and CUDA
activities), each in a ``ProfilerStep#i`` range, with a
``record_function`` range around each top-level module's forward (the
scopes ``analyze_trace`` groups by), and writes the Chrome trace to
``<outdir>/trace.json.gz``; then times 5 iterations. Every iteration ends
in ``torch.cuda.synchronize()``. It runs on the card unless given
``--device cpu``; without a card it raises.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time
from typing import List, Optional

from .test import CONFIGS

TRACE_FILE = "trace.json.gz"


def parse_args(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser(description="Trace DeepInteraction (PyTorch port) with torch.profiler")
    ap.add_argument("config", nargs="?", default="fusion_plusplus", choices=sorted(CONFIGS))
    ap.add_argument("--outdir", default=None, help="trace output dir (default work_dirs/trace_<config>)")
    ap.add_argument("--iters", type=int, default=3, help="traced iterations")
    ap.add_argument("--train", action="store_true", help="trace the train step instead")
    ap.add_argument("--zeros", action="store_true", help="all-zero weights and buffers instead of random ones")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


@contextlib.contextmanager
def module_scopes(model):
    """A ``record_function`` range named after each top-level submodule
    around its forward, for the duration of the block."""
    from torch.autograd.profiler import record_function

    open_ranges = {}

    def pre(name):
        def hook(*_):
            rf = record_function(name)
            rf.__enter__()
            open_ranges.setdefault(name, []).append(rf)
        return hook

    def post(name):
        def hook(*_):
            open_ranges[name].pop().__exit__(None, None, None)
        return hook

    handles = []
    for name, mod in model.named_children():
        handles += [mod.register_forward_pre_hook(pre(name)), mod.register_forward_hook(post(name))]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def main(argv: Optional[List[str]] = None) -> str:
    """Trace; returns the trace file's path."""
    import torch
    from torch.autograd.profiler import record_function

    from ..ops import cuda_lib
    from .benchmark import build_model, make_run, synthetic_batches

    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass --device cpu to trace on the CPU")
        cuda_lib.fp32_numerics()
    outdir = args.outdir or os.path.join("work_dirs", f"trace_{args.config}")
    cfg = CONFIGS[args.config]()

    model = build_model(cfg, args.train, device, zeros=args.zeros)
    batches = synthetic_batches(cfg, 1, 1, args.train, device)
    run = make_run(cfg, model, batches, args.train, device)

    def fenced():
        out = run(0)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return out

    t0 = time.perf_counter()
    out = fenced()
    print(f"compile+run: {time.perf_counter() - t0:.1f}s", flush=True)
    if not bool(torch.isfinite(out).all()):
        raise FloatingPointError("the first iteration's output is not finite")
    for _ in range(2):
        t0 = time.perf_counter()
        fenced()
        print(f"warm: {time.perf_counter() - t0:.3f}s", flush=True)

    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with module_scopes(model), torch.profiler.profile(activities=acts) as prof:
        for i in range(args.iters):
            with record_function(f"ProfilerStep#{i}"):
                fenced()
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, TRACE_FILE)
    prof.export_chrome_trace(path)
    print("trace written to", outdir, flush=True)
    t0 = time.perf_counter()
    for _ in range(5):
        fenced()
    print(f"steady-state: {(time.perf_counter() - t0) / 5 * 1e3:.1f} ms/iter", flush=True)
    return path


if __name__ == "__main__":
    main()

"""Speed benchmark CLI (the port's counterpart of ``tools/benchmark.py``,
the reference's tools/analysis_tools/benchmark.py): the eval forward plus
``get_bboxes`` at the test-time proposal count, or with ``--train`` the
full train step (forward, matching, loss, backward, clip, AdamW)::

    python -m deepinteraction_tpu_torch.tools.benchmark fusion_base --synthetic
    python -m deepinteraction_tpu_torch.tools.benchmark fusion_base --train --batch 2 --synthetic
    python -m deepinteraction_tpu_torch.tools.benchmark fusion_base --infos data/nuscenes_infos_val.pkl

The input batches are made resident on the device before timing: from
``--synthetic`` (``utils/synthetic.py::make_synthetic_batch``, at most 4
distinct batches, 2 with ``--train``) or from ``--infos`` through the
loader and the image stage (``ops/images.py::to_device``). Weights are
random from ``cfg.seed``. After one untimed first iteration and
``--warmup`` more, each of ``--samples`` timed iterations is the host clock
around work ending in ``torch.cuda.synchronize()``. It prints the JAX
CLI's summary line, then one JSON line: ms per iteration (mean and
median), frames or steps per second, the peak device memory of the timed
iterations, the first iteration's seconds, the JAX package's ``DI_*`` settings the
model resolved (``levers.py``), the port's kernel launches of the timed
iterations and the card's name.

It runs on the card unless given ``--device cpu`` (then no memory is
reported); without a card it raises. On the card it runs in fp32, TF32
off, with cuDNN autotuning (``ops/cuda_lib.py::fp32_numerics``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import time
from typing import Dict, List, Optional

# the loader's spawned workers import this module: torch and the model are
# imported in main(), so the workers import neither
from ..configs import apply_overrides
from ..data import DataLoader, NuScenesDataset
from .test import CONFIGS


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description="Benchmark DeepInteraction (PyTorch port)")
    p.add_argument("config", choices=sorted(CONFIGS))
    p.add_argument("--infos", default=None)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--samples", type=int, default=50)
    p.add_argument("--warmup", type=int, default=5)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--train", action="store_true",
                   help="time the full train step (fwd + targets + bwd + AdamW) instead of the eval forward")
    p.add_argument("--cfg-options", nargs="*", default=[])
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def build_model(cfg, train: bool, device, zeros: bool = False):
    """The benchmarked detector on ``device``: random weights from
    ``cfg.seed`` (all zero, parameters and buffers, with ``zeros``), the
    test-time proposal count unless ``train``."""
    import torch

    from ..models.detector import DeepInteraction
    from ..utils.synthetic import init_weights

    p = None if train else cfg.test_num_proposals
    model = DeepInteraction(cfg.model, cfg.data.padded_img_shape, num_proposals=p)
    init_weights(model, seed=cfg.seed)
    if zeros:
        with torch.no_grad():
            for t in model.state_dict().values():
                t.zero_()
    return model.to(device)


def synthetic_batches(cfg, n: int, batch: int, train: bool, device) -> list:
    """``n`` distinct synthetic batches of ``batch`` samples (seeds 0..n-1),
    with ground truth for ``train``, resident on ``device``."""
    from ..utils.synthetic import make_synthetic_batch, to_torch

    return [to_torch(make_synthetic_batch(cfg, b=batch, seed=s, with_gt=train), device) for s in range(n)]


def make_run(cfg, model, batches: list, train: bool, device):
    """``run(i)``: one iteration on ``batches[i % len(batches)]``, the train
    step (a ``TrainStep`` built here, generator seeded 0) or the eval
    forward + ``get_bboxes``; returns the loss or the scores."""
    import torch

    from ..inference import get_bboxes
    from ..train.step import TrainStep

    if train:
        step = TrainStep(cfg, model, total_steps=1000, device=device)
        generator = torch.Generator(device=device).manual_seed(0)

        def run(i):
            return step(batches[i % len(batches)], generator)["loss_total"]
    else:
        dcfg, p = cfg.model.pts_bbox_head, cfg.test_num_proposals

        def run(i):
            return get_bboxes(model(batches[i % len(batches)]), dcfg, cfg.model.bbox_coder, p).scores
    return run


def main(argv: Optional[List[str]] = None) -> Dict:
    """Run the benchmark; returns the JSON line's record."""
    import torch

    from ..ops import cuda_lib
    from ..ops.images import to_device
    from .train import launch_counts

    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass --device cpu to benchmark on the CPU")
        cuda_lib.fp32_numerics()

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    cfg = CONFIGS[args.config]()
    if args.cfg_options:
        cfg = apply_overrides(cfg, dict(kv.split("=", 1) for kv in args.cfg_options))
    model = build_model(cfg, args.train, device)

    synthetic = args.synthetic or not args.infos
    if synthetic:
        # train mode holds fewer distinct batches on the device
        batches = synthetic_batches(cfg, min(args.samples, 2 if args.train else 4), args.batch, args.train, device)
    else:
        loader = DataLoader(NuScenesDataset(cfg, args.infos, train=args.train), args.batch, num_workers=4)
        limit = min(args.samples, 2) if args.train else args.samples
        batches = []
        try:
            for b in loader.epoch(0, shuffle=False):
                b.pop("token", None), b.pop("pad_count", None)
                batches.append(to_device(b, cfg.data, device))
                if len(batches) >= limit:
                    break
        finally:
            loader.close()
        if not batches:
            raise ValueError(f"{args.infos} gives no batch of {args.batch}")

    run = make_run(cfg, model, batches, args.train, device)

    t0 = time.perf_counter()
    out = run(0)
    sync()
    first_s = time.perf_counter() - t0
    if not bool(torch.isfinite(out).all()):
        raise FloatingPointError("the first iteration's output is not finite")
    print(f"first iteration: {first_s:.1f}s")
    for i in range(args.warmup):
        run(i)
    sync()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    counts = launch_counts()
    times = []
    for i in range(args.samples):
        t0 = time.perf_counter()
        run(i)
        sync()
        times.append(time.perf_counter() - t0)
    launches = {k: v - counts[k] for k, v in launch_counts().items()}
    dt = sum(times) / len(times)
    kind = "train steps/sec/chip" if args.train else "frames/sec/chip"
    print(f"{args.samples} iters, batch {args.batch}: {dt * 1e3:.1f} ms/iter, {args.batch / dt:.2f} {kind} "
          f"on {device.type}")
    record = {"config": args.config, "mode": "train" if args.train else "eval", "batch": args.batch,
              "input": "synthetic" if synthetic else args.infos, "distinct_batches": len(batches),
              "samples": args.samples, "warmup": args.warmup, "first_iter_s": first_s,
              "ms_per_iter_mean": dt * 1e3, "ms_per_iter_median": statistics.median(times) * 1e3,
              "levers": dataclasses.asdict(model.levers), "launches": launches,
              "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"}
    if args.train:
        record["steps_per_s"] = 1 / dt
    else:
        record["frames_per_s"] = args.batch / dt
    if device.type == "cuda":
        record["peak_memory_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()

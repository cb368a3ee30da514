"""Training CLI (the port's counterpart of ``tools/train.py``): config
selection with dot-path overrides (``--cfg-options``), seeded weights and
dropout, cyclic AdamW (``train/step.py::TrainStep``), per-epoch
checkpoints, JSON-lines logs with the reference's loss keys::

    python -m deepinteraction_tpu_torch.tools.train fusion_base --work-dir work_dirs/base \\
        --infos data/nuscenes/nuscenes_infos_train.pkl --load-from work_dirs/lidar/ckpts \\
        --cfg-options optim.total_epochs=6 data.samples_per_device=2

It runs on the card unless given ``--device cpu``; without a card it
raises. On the card it runs in fp32, TF32 off, with cuDNN autotuning
(``ops/cuda_lib.py::fp32_numerics``). The loader's spawned workers run the
host pipeline (CBGS by ``data.use_cbgs``); the JPEGs are decoded on the
card. It writes ``<work_dir>/config.json``, a ``train_log.jsonl`` line
every ``optim.log_interval_steps`` steps (the step's loss terms,
``matched_ious`` and ``grad_norm``, with ``epoch``, ``iter``, ``step``,
``time``, the step's wall time, and ``data_time``, the loader wait plus
the image stage), a checkpoint under ``<work_dir>/ckpts`` every
``optim.checkpoint_interval_epochs`` epochs and, with ``--eval-infos``, an
``eval_log.jsonl`` line every epoch (``tools/test.py::evaluate`` at the
train-time proposal count). ``--profile-steps N`` exports a
``torch.profiler`` trace of steps 5 to 5+N to ``<work_dir>/trace``. The
last line printed is a JSON summary with the JAX package's ``DI_*``
settings the model resolved (``levers.py``: top views in train and eval,
the eval-only ones in ``--eval-infos``) and the port's kernel launches (the
``ops/subm_conv.py`` and ``ops/local_attention.py`` counters) of the train
steps and of the evaluations.

Data parallel under ``torchrun`` (``deepinteraction_tpu_torch/tools/
dist_train.sh``), one rank a card: the global batch is
``data.samples_per_device`` x the rank count, each rank loading its shard
of every epoch (``data/loader.py``) at the local batch, and each step is the
global batch's step (``train/step.py``: global BN statistics, loss
normalisers and gradient sums). Every rank draws its weights from
``--seed`` and then takes rank 0's (after ``--load-from`` or
``--resume-from``); the dropout generator is seeded from ``--seed`` and the
rank. Only rank 0 writes: ``config.json``, the logs (the metrics are the
global batch's), TensorBoard, the checkpoints and the profiler trace; the
evaluations are sharded over the ranks and scored on rank 0. The summary
line also counts the train steps' collectives and their all-reduced bytes
(``parallel/mesh.py``). The Hungarian matching follows
``model.assigner.lap_impl`` (``ops/hungarian.py``): ``callback``, the
default, solves on the host with scipy; ``auction`` runs the auction kernel
on the card (``--cfg-options model.assigner.lap_impl=auction``), its
launches counted under ``auction_lap``; the summary names the one used
(``lap_impl``). ``cfg.data.gt_database`` is not passed to the dataset, as
the JAX CLI does not pass it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Dict, List, Optional

# the loader's spawned workers import this module: torch and the model are
# imported in main(), so the workers import neither
from ..configs import apply_overrides
from ..data import DataLoader, NuScenesDataset
from .test import CONFIGS, evaluate, launch_counts


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description="Train DeepInteraction (PyTorch port)")
    p.add_argument("config", choices=sorted(CONFIGS))
    p.add_argument("--infos", required=True, help="train info pkl")
    p.add_argument("--work-dir", default=None)
    p.add_argument("--load-from", default=None, help="params-only warm start dir")
    p.add_argument("--resume-from", default=None, help="full-state resume dir")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num-workers", type=int, default=4)
    p.add_argument("--profile-steps", type=int, default=0,
                   help="capture a torch.profiler trace of N steps into <work_dir>/trace")
    p.add_argument("--tensorboard", action="store_true")
    p.add_argument("--eval-infos", default=None,
                   help="val info pkl; evaluate every epoch (reference evaluation interval=1, config "
                   "Fusion_0075_refactor.py:12)")
    p.add_argument("--cfg-options", nargs="*", default=[], help="dot-path overrides, e.g. optim.lr=1e-4")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def _since(start: Dict[str, int]) -> Dict[str, int]:
    return {k: v - start[k] for k, v in launch_counts().items()}


def main(argv: Optional[List[str]] = None) -> Dict:
    """Train; returns the JSON summary that rank 0 prints last: the steps
    taken, the kernel launches of the train steps and of the evaluations,
    the train steps' collectives and all-reduced bytes, and on a card the
    peak device memory of the train steps, over all of them and over those
    after the run's first (which holds cuDNN's autotuning)."""
    import torch

    from ..models.detector import DeepInteraction
    from ..ops import cuda_lib
    from ..ops.images import to_device
    from ..parallel import mesh
    from ..train.checkpoint import load_params, restore_checkpoint, save_checkpoint
    from ..train.step import TrainStep
    from ..utils.synthetic import init_weights

    t_start = time.perf_counter()
    args = parse_args(argv)
    own_group = not mesh.is_distributed()
    device = mesh.init_distributed(args.device)
    rank0, world = mesh.rank() == 0, mesh.world_size()
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass --device cpu to train on the CPU")
        cuda_lib.fp32_numerics()

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    cfg = CONFIGS[args.config]()
    overrides = dict(kv.split("=", 1) for kv in args.cfg_options)
    if overrides:
        cfg = apply_overrides(cfg, overrides)
    work_dir = args.work_dir or cfg.work_dir
    if rank0:
        os.makedirs(work_dir, exist_ok=True)
        with open(os.path.join(work_dir, "config.json"), "w") as f:
            json.dump({"config": args.config, "overrides": overrides}, f)

    dataset = NuScenesDataset(cfg, args.infos, train=True, use_cbgs=cfg.data.use_cbgs, seed=args.seed)
    batch_size = cfg.data.samples_per_device  # the rank's; the global batch is world x this
    loader = DataLoader(dataset, batch_size, num_workers=args.num_workers, process_index=mesh.rank(),
                        process_count=world)
    steps_per_epoch = max(len(dataset) // (batch_size * world), 1)
    total_steps = steps_per_epoch * cfg.optim.total_epochs

    model = DeepInteraction(cfg.model, cfg.data.padded_img_shape)
    init_weights(model, seed=args.seed)
    step = TrainStep(cfg, model, total_steps, device)
    if args.resume_from:
        restore_checkpoint(args.resume_from, step)
        print(f"resumed from {args.resume_from} at step {step.step_count}")
    elif args.load_from:
        load_params(args.load_from, step)
        print(f"warm-started params from {args.load_from}")
    mesh.replicate(model)
    generator = torch.Generator(device=device).manual_seed(mesh.rank_seed(args.seed))

    log_path = os.path.join(work_dir, "train_log.jsonl")
    tb_writer = None
    if args.tensorboard and rank0:
        try:
            from torch.utils.tensorboard import SummaryWriter

            tb_writer = SummaryWriter(os.path.join(work_dir, "tb"))
        except ImportError:
            print("tensorboard logging requested but tensorboard unavailable")

    trace_dir = os.path.join(work_dir, "trace")
    profiler = None

    def stop_trace():
        profiler.stop()
        os.makedirs(trace_dir, exist_ok=True)
        profiler.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
        print("wrote profiler trace to", trace_dir)

    def take_peak() -> int:
        """The peak device memory since the last call, then reset."""
        if device.type != "cuda":
            return 0
        peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        return peak

    first_step = step.step_count
    collectives = {"calls": 0, "bytes": 0}
    train_launches = dict.fromkeys(launch_counts(), 0)
    eval_launches = dict(train_launches)
    take_peak()
    first_peak = steady_peak = 0
    start_epoch = step.step_count // steps_per_epoch
    try:
        for epoch in range(start_epoch, cfg.optim.total_epochs):
            counts = launch_counts()
            calls, n_bytes = mesh.all_reduce.calls, mesh.all_reduce.bytes
            t_data = time.perf_counter()
            for it, host in enumerate(loader.epoch(epoch)):
                if args.profile_steps and rank0 and step.step_count == 5:
                    activities = [torch.profiler.ProfilerActivity.CPU]
                    if device.type == "cuda":
                        activities.append(torch.profiler.ProfilerActivity.CUDA)
                    profiler = torch.profiler.profile(activities=activities)
                    profiler.start()
                if profiler is not None and step.step_count == 5 + args.profile_steps:
                    stop_trace()
                    profiler = None
                batch = to_device(host, cfg.data, device)
                sync()
                data_time = time.perf_counter() - t_data
                t0 = time.perf_counter()
                metrics = step(batch, generator)
                sync()
                step_time = time.perf_counter() - t0
                if step.step_count == first_step + 1:  # the first step holds cuDNN's autotuning workspaces
                    first_peak = take_peak()
                if (it + 1) % cfg.optim.log_interval_steps == 0 and rank0:
                    metrics = {k: v.item() for k, v in metrics.items()}
                    metrics.update(epoch=epoch, iter=it + 1, step=step.step_count, time=step_time,
                                   data_time=data_time)
                    print(f"Epoch[{epoch}][{it + 1}/{steps_per_epoch}] loss={metrics['loss_total']:.4f} "
                          f"heatmap={metrics['loss_heatmap']:.4f} matched_ious={metrics['matched_ious']:.4f}")
                    with open(log_path, "a") as f:
                        f.write(json.dumps(metrics) + "\n")
                    if tb_writer is not None:
                        for k, v in metrics.items():
                            if isinstance(v, float):
                                tb_writer.add_scalar(k, v, metrics["step"])
                t_data = time.perf_counter()
            for k, v in _since(counts).items():
                train_launches[k] += v
            collectives["calls"] += mesh.all_reduce.calls - calls
            collectives["bytes"] += mesh.all_reduce.bytes - n_bytes
            if (epoch + 1) % cfg.optim.checkpoint_interval_epochs == 0 and rank0:
                save_checkpoint(os.path.join(work_dir, "ckpts"), step)
                print(f"saved checkpoint at epoch {epoch}")
            if args.eval_infos:
                steady_peak = max(steady_peak, take_peak())
                counts = launch_counts()
                res = evaluate(model, cfg, cfg.model.pts_bbox_head.num_proposals, args.eval_infos,
                               args.num_workers, device)
                for k, v in _since(counts).items():
                    eval_launches[k] += v
                take_peak()  # the evaluation's
                if res is not None:  # rank 0
                    metrics = dict(res["metrics"], epoch=epoch)
                    print("eval:", json.dumps(metrics, sort_keys=True))
                    with open(os.path.join(work_dir, "eval_log.jsonl"), "a") as f:
                        f.write(json.dumps(metrics) + "\n")
        if profiler is not None:  # the run ended inside the window
            stop_trace()
    finally:
        loader.close()
        if tb_writer is not None:
            tb_writer.close()
        if own_group:
            mesh.destroy_distributed()

    summary = {"config": args.config, "device": str(device), "work_dir": work_dir, "ranks": world,
               "lap_impl": cfg.model.assigner.lap_impl,
               "first_step": first_step, "last_step": step.step_count, "steps": step.step_count - first_step,
               "levers": dataclasses.asdict(model.levers), "launches": train_launches,
               "eval_launches": eval_launches, "collectives": collectives,
               "seconds": time.perf_counter() - t_start}
    if device.type == "cuda":
        steady_peak = max(steady_peak, take_peak())
        summary["peak_memory_gib"] = max(first_peak, steady_peak) / 2**30
        summary["steady_peak_memory_gib"] = steady_peak / 2**30
    if rank0:
        print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()

"""Where the time of a train step goes, on one NVIDIA GPU.

Builds ``--config`` (``lidar_only``, the default, ``fusion_base`` or
``fusion_plusplus``) at full width with random seeded weights, takes
``--warmup`` steps on the B=2 synthetic batch, then reports:

- host-clock splits of one step: each top-level module's forward, the
  matching and targets, the loss, the backward and the AdamW update, each
  fenced by ``torch.cuda.synchronize()`` (the fences add a little);
- a ``torch.profiler`` window over ``--steps`` steps: device time per step,
  the device's busy share of the window, kernel launches and host syncs per
  step, the device time of the port's kernels (K1 ``subm_conv``, K2
  ``local_attn``) and the kernels with the most device time.

Usage: ``python -m deepinteraction_tpu_torch.profile_train [--config
fusion_plusplus] [--steps 3]``.
Prints one JSON object as its last line. Fails without a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import time
from collections import defaultdict

import torch

from .configs import fusion_base_config, fusion_plusplus_config, lidar_only_config
from .models.detector import DeepInteraction
from .targets.assign import build_targets, detection_loss
from .train.step import TrainStep, bev_shape
from .utils.synthetic import init_weights, make_synthetic_batch, to_torch

CONFIGS = {"lidar_only": lidar_only_config, "fusion_base": fusion_base_config,
           "fusion_plusplus": fusion_plusplus_config}
# top-level modules timed by hooks, per config
FUSION_MODULES = ("img_backbone", "img_neck", "pts_middle_encoder", "pts_backbone", "pts_neck", "imgpts_neck",
                  "pts_bbox_head")
MODULES = {
    "lidar_only": ("pts_middle_encoder", "pts_backbone", "pts_neck", "shared_conv", "pts_bbox_head"),
    "fusion_base": FUSION_MODULES,
    "fusion_plusplus": FUSION_MODULES,
}


@contextlib.contextmanager
def fenced_module_times(model: torch.nn.Module, names):
    """Within the block, the host-clock ms of each forward of the submodules
    ``names``, each fenced by ``torch.cuda.synchronize()``: yields
    ``{name: [ms, ...]}``, one entry a call."""
    times = {n: [] for n in names}
    starts = {}

    def pre(name):
        def hook(*_):
            torch.cuda.synchronize()
            starts[name] = time.perf_counter()
        return hook

    def post(name):
        def hook(*_):
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - starts[name]) * 1e3)
        return hook

    handles = []
    for name in names:
        mod = model.get_submodule(name)
        handles += [mod.register_forward_pre_hook(pre(name)), mod.register_forward_hook(post(name))]
    try:
        yield times
    finally:
        for h in handles:
            h.remove()


def timed_step(step: TrainStep, batch, seed: int, modules) -> dict:
    """One step with host-clock splits fenced by synchronize (ms) around
    each of ``modules``' forward and each phase of the step."""
    model, cfg = step.model, step.cfg
    m = cfg.model
    gt = (batch["gt_boxes"], batch["gt_labels"], batch["gt_mask"])
    heads = (m.pts_bbox_head, m.bbox_coder, m.assigner, bev_shape(cfg))
    with fenced_module_times(model, modules) as marks:
        torch.cuda.synchronize()
        t = [time.perf_counter()]
        step.opt.zero_grad(set_to_none=True)
        preds = model(batch, train=True, generator=torch.Generator(device=step.device).manual_seed(seed))
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        targets = build_targets(preds, *gt, *heads)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        losses = detection_loss(preds, *gt, *heads, targets)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        losses["loss_total"].backward()
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        sq = torch.stack([p.grad.pow(2).sum() for p in step.params if p.grad is not None]).sum()
        step.update(torch.sqrt(sq))
        torch.cuda.synchronize()
        t.append(time.perf_counter())
    ms = [(b - a) * 1e3 for a, b in zip(t, t[1:])]
    out = {"forward": ms[0]}
    out.update({f"  {name}": marks[name][0] for name in modules})
    out["  voxelize and the rest of the forward"] = ms[0] - sum(marks[n][0] for n in modules)
    out.update({"matching and targets": ms[1], "loss": ms[2], "backward": ms[3],
                "grad norm, clip and AdamW": ms[4], "step": sum(ms)})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", choices=sorted(CONFIGS), default="lidar_only")
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--splits", type=int, default=3, help="steps with host-clock splits (median)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: no CUDA device")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True

    cfg = CONFIGS[args.config]()
    b = cfg.data.samples_per_device
    model = DeepInteraction(cfg.model, cfg.data.padded_img_shape)
    init_weights(model, seed=0)
    step = TrainStep(cfg, model, 1000, device=dev)
    batch = to_torch(make_synthetic_batch(cfg, b=b, seed=0, with_gt=True), dev)
    for i in range(args.warmup):
        step(batch, torch.Generator(device=dev).manual_seed(i))
    torch.cuda.reset_peak_memory_stats(dev)  # cuDNN's autotuning workspaces stay out
    runs = [timed_step(step, batch, 100 + i, MODULES[args.config]) for i in range(args.splits)]
    splits = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
    for k, v in splits.items():
        print(f"{k:40s} {v:9.3f} ms", flush=True)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(args.steps):
            step(batch, torch.Generator(device=dev).manual_seed(200 + i))
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    n = args.steps
    kernels = defaultdict(float)
    calls = defaultdict(int)
    device_us = 0.0
    for ev in prof.events():
        calls[ev.name] += 1
        # device work only: a record_function range (``Optimizer.step``)
        # also appears on the device, spanning kernels counted already
        if ev.device_type == torch.autograd.DeviceType.CUDA and not ev.is_user_annotation:
            dt = ev.time_range.elapsed_us()
            kernels[ev.name] += dt
            device_us += dt
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:15]
    ours = {k: v for k, v in kernels.items() if "subm_conv" in k or "sum_partials" in k or "local_attn" in k}
    summary = {
        "card": smi,
        "config": f"{args.config}_config, B={b}, train step",
        "splits_ms": splits,
        "profiled_steps": n,
        "window_ms_per_step": window_ms / n,
        "device_ms_per_step": device_us / 1e3 / n,
        "device_busy_share": device_us / 1e3 / window_ms,
        "kernel_launches_per_step": calls.get("cudaLaunchKernel", 0) / n,
        "stream_syncs_per_step": calls.get("cudaStreamSynchronize", 0) / n,
        "memcpy_per_step": calls.get("cudaMemcpyAsync", 0) / n,
        "kernel_device_ms_per_step": {k: v / 1e3 / n for k, v in ours.items()},
        "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
        "top_kernels_ms_per_step": [[k[:90], v / 1e3 / n] for k, v in top],
    }
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Evaluation CLI: checkpoint -> nuScenes val metrics (NDS, mAP, TP errors)
(the port's counterpart of ``tools/test.py``).

Builds the model with the test-time proposal count
(``cfg.test_num_proposals``, the reference's tools/test.py:155), runs it over
the val split from an info pkl, decodes boxes (``get_bboxes``, with NMS
where ``--cfg-options model.pts_bbox_head.nms_type=circle|rotate`` asks for
it), optionally with double-flip TTA and weighted box fusion, and evaluates
with the devkit-free metrics (``eval/nuscenes_metrics.py``)::

    python -m deepinteraction_tpu_torch.tools.test fusion_base \\
        --infos data/nuscenes/nuscenes_infos_val.pkl --checkpoint work_dirs/ckpt

It runs on the card unless given ``--device cpu``; without a card it
raises. On the card it runs in fp32, TF32 off, with cuDNN autotuning
(``ops/cuda_lib.py::fp32_numerics``). The loader's workers run the host pipeline; the JPEGs are decoded
on the card (nvJPEG). ``--checkpoint`` takes a port checkpoint directory
(``train/checkpoint.py``; ``tools/convert_torch_ckpt.py`` makes one from a
reference ``.pth``); without it the weights are random from ``cfg.seed``.
The loop is :func:`evaluate`, which the train CLI's ``--eval-infos`` runs
too.

Under ``torchrun`` (``deepinteraction_tpu_torch/tools/dist_test.sh``) each
rank evaluates its stride shard of the val split (``data/loader.py``), with
no collective in the forward, and ``parallel/input.py::gather_results``
brings the (token, frame) pairs to rank 0, the rank shards in rank order
(the JAX CLI's order). Rank 0 alone scores, writes ``--out`` and prints the
metrics; its timings are its own shard's. The last line printed is a JSON
summary with the timings, the JAX package's ``DI_*`` settings the model
resolved (``levers.py``; with none set, the JAX package's defaults), the
metrics and this process's kernel launches.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pickle
import time
from typing import Dict, List, Optional

import numpy as np

# the loader's spawned workers import this module: torch and the model are
# imported in main(), so the workers import neither
from ..configs import (
    apply_overrides,
    fusion_base_config,
    fusion_plusplus_config,
    lidar_only_config,
    tiny_config,
    tiny_lidar_config,
    tiny_pp_config,
)
from ..data import DataLoader, NuScenesDataset
from ..eval.nuscenes_metrics import DetectionFrame, evaluate_detections
from ..eval.results import default_attribute, ego_origin_in_lidar, gt_frame_from_info, predictions_to_frame
from ..parallel.input import gather_results

CONFIGS = {
    "fusion_base": fusion_base_config,
    "fusion_plusplus": fusion_plusplus_config,
    "lidar_only": lidar_only_config,
    "tiny": tiny_config,
    "tiny_pp": tiny_pp_config,
    "tiny_lidar": tiny_lidar_config,
}


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description="Evaluate DeepInteraction (PyTorch port)")
    p.add_argument("config", choices=sorted(CONFIGS))
    p.add_argument("--infos", required=True, help="val info pkl")
    p.add_argument("--checkpoint", default=None, help="port checkpoint directory")
    p.add_argument("--out", default=None, help="write raw detections pkl here")
    p.add_argument("--num-workers", type=int, default=4)
    p.add_argument("--tta", action="store_true",
                   help="double-flip test-time augmentation + weighted box fusion")
    p.add_argument("--cfg-options", nargs="*", default=[])
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def launch_counts() -> Dict[str, int]:
    """The port's kernel launch counters (each wrapper counts the launches
    of its kernel in this process; the sparse encoder's six table wrappers
    too)."""
    from ..ops import hungarian, local_attention as la
    from ..ops import sparse_conv as sc
    from ..ops import subm_conv as smc

    return {f.__name__: f.launches for f in (smc.subm_conv_gemm, smc.subm_conv_gemm_bf16, smc.subm_conv_dgrad,
                                             smc.subm_conv_wgrad, la.local_attn_fwd, la.local_attn_fwd_bf16,
                                             la.local_attn_bwd, hungarian.auction_lap, sc.dense_index_map,
                                             sc.subm_neighbor_table, sc.strided_neighbor_table, sc.banded_overflow,
                                             sc.downsample_sites, sc.inverse_table)}


def _frame_from_fused(boxes, scores, labels, class_names) -> DetectionFrame:
    names = np.asarray([class_names[int(j)] for j in labels])
    vel = boxes[:, 7:9]
    attrs = np.asarray([default_attribute(n, float(np.linalg.norm(v))) for n, v in zip(names, vel)])
    return DetectionFrame(boxes=boxes[:, :7], velocity=vel, names=names, scores=scores, attributes=attrs)


def evaluate(model, cfg, num_proposals: int, infos: str, num_workers: int, device, tta: bool = False,
             out: Optional[str] = None) -> Dict:
    """Evaluate ``model`` (on ``device``) over the val split of the info pkl
    ``infos`` at the proposal count ``num_proposals``, loading through
    ``num_workers`` spawned workers: decode boxes (``get_bboxes``, or
    double-flip TTA with ``tta``), write the raw frames to ``out`` if
    given, and score them with the nuScenes metrics. Under a process group
    each rank evaluates its shard of the split and rank 0 gathers, writes
    and scores them; the other ranks return ``None``.

    Returns the metrics, the frames and their tokens (every rank's), the
    raw detections of this rank's batches (on the CPU; not with ``tta``),
    and this rank's timings: fps; the
    seconds of set-up (the dataset and loader), of the first batch and of
    the metrics; ms/frame after the first batch, split into loader wait,
    decode (the image stage: JPEG decode, resize, normalise, pad, and the
    batch's copy to the device), forward and post-processing
    (``get_bboxes`` with any NMS, the copy to the host, the frames); and on
    a card the peak device memory since the caller last reset it (through
    the first batch) and of the batches after the first."""
    import torch

    from ..eval.tta import tta_inference
    from ..inference import Detections, get_bboxes
    from ..ops.images import to_device
    from ..parallel.mesh import rank, world_size

    t_start = time.perf_counter()
    device = torch.device(device)
    dataset = NuScenesDataset(cfg, infos, train=False)
    if not len(dataset):
        raise ValueError(f"{infos} holds no samples")
    batch_size = cfg.data.samples_per_device
    loader = DataLoader(dataset, batch_size, num_workers=num_workers, process_index=rank(),
                        process_count=world_size())
    dcfg, p = cfg.model.pts_bbox_head, num_proposals

    def forward(batch):
        return get_bboxes(model(batch), dcfg, cfg.model.bbox_coder, p)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    pred_frames, tokens, detections = [], [], []
    splits = {"loader": [], "decode": [], "forward": [], "post": []}
    frames_per_batch = []
    t0 = time.perf_counter()
    n_frames = 0
    batches = loader.epoch(0, shuffle=False)
    try:
        while True:
            ta = time.perf_counter()
            batch = next(batches, None)
            if batch is None:
                break
            tb = time.perf_counter()
            pad = batch.pop("pad_count", 0)
            toks = batch.pop("token")
            arrays = to_device(batch, cfg.data, device)
            sync()
            tc = time.perf_counter()
            b = len(toks) - pad
            if tta:
                fused = tta_inference(forward, arrays)
                td = time.perf_counter()  # the forwards and their fusion are not separable here
                for i in range(b):
                    pred_frames.append(_frame_from_fused(*fused[i], cfg.data.class_names))
            else:
                preds = model(arrays)
                sync()
                td = time.perf_counter()
                det = Detections(*(t.cpu() for t in get_bboxes(preds, dcfg, cfg.model.bbox_coder, p)))
                detections.append(det)
                for i in range(b):
                    pred_frames.append(predictions_to_frame(det.boxes[i].numpy(), det.scores[i].numpy(),
                                                            det.labels[i].numpy(), det.keep[i].numpy(),
                                                            cfg.data.class_names))
            tokens.extend(toks[:b])
            te = time.perf_counter()
            for k, (s, e) in zip(splits, ((ta, tb), (tb, tc), (tc, td), (td, te))):
                splits[k].append((e - s) * 1e3)
            frames_per_batch.append(b)
            n_frames += b
            if len(frames_per_batch) == 1:
                first_batch_s = te - t0
                if device.type == "cuda":  # the first batch holds cuDNN's autotuning workspaces
                    first_peak = torch.cuda.max_memory_allocated(device)
                    torch.cuda.reset_peak_memory_stats(device)
            if n_frames % 100 < batch_size and rank() == 0:
                print(f"{n_frames}/{len(dataset.infos)} frames, {n_frames / (time.perf_counter() - t0):.2f} fps")
    finally:
        loader.close()
    elapsed = time.perf_counter() - t0
    t_metrics = time.perf_counter()
    gathered = gather_results(list(zip(tokens, pred_frames)))
    if gathered is None:
        return None
    tokens = [t for t, _ in gathered]
    pred_frames = [f for _, f in gathered]

    if out:
        with open(out, "wb") as f:
            pickle.dump({"tokens": tokens, "frames": pred_frames}, f)

    info_by_token = {i["token"]: i for i in dataset.infos}
    gt_frames = [gt_frame_from_info(info_by_token[t]) for t in tokens]
    # the devkit's range filter measures from the ego pose, not the lidar mount
    for pf, t in zip(pred_frames, tokens):
        pf.ego_translation = ego_origin_in_lidar(info_by_token[t])
    metrics = evaluate_detections(gt_frames, pred_frames, cfg.data.class_names)
    metrics_s = time.perf_counter() - t_metrics

    # ms/frame after the first batch (the workers' start-up and cuDNN's
    # autotuning land in the first); fps over every batch, as the JAX CLI
    # prints it
    steady = slice(1, None) if len(frames_per_batch) > 1 else slice(None)
    n_steady = sum(frames_per_batch[steady])
    ms_per_frame = {k: sum(v[steady]) / n_steady for k, v in splits.items()}
    timing = {"fps": n_frames / elapsed, "frames": n_frames, "seconds": elapsed,
              "setup_s": t0 - t_start, "first_batch_s": first_batch_s, "metrics_s": metrics_s,
              "first_batch_ms": {k: v[0] for k, v in splits.items()},
              "ms_per_frame": ms_per_frame, "ms_per_frame_total": sum(ms_per_frame.values()),
              "steady_frames": n_steady}
    if device.type == "cuda":
        steady_peak = torch.cuda.max_memory_allocated(device)
        timing["peak_memory_gib"] = max(first_peak, steady_peak) / 2**30
        timing["steady_peak_memory_gib"] = steady_peak / 2**30
    return {"metrics": metrics, "tokens": tokens, "frames": pred_frames, "detections": detections,
            "timing": timing}


def main(argv: Optional[List[str]] = None) -> Dict:
    """Run the evaluation; returns :func:`evaluate`'s result, its set-up
    time counting the config, the model and the checkpoint too, and its
    peak memory the whole run's (``None`` on a rank other than 0)."""
    import torch

    from ..models.detector import DeepInteraction
    from ..ops import cuda_lib
    from ..parallel.mesh import destroy_distributed, init_distributed, is_distributed
    from ..train.checkpoint import load_weights
    from ..utils.synthetic import init_weights

    t_start = time.perf_counter()
    args = parse_args(argv)
    own_group = not is_distributed()
    device = init_distributed(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass --device cpu to evaluate on the CPU")
        cuda_lib.fp32_numerics()
        torch.cuda.reset_peak_memory_stats(device)
    cfg = CONFIGS[args.config]()
    if args.cfg_options:
        cfg = apply_overrides(cfg, dict(kv.split("=", 1) for kv in args.cfg_options))

    p = cfg.test_num_proposals
    model = DeepInteraction(cfg.model, cfg.data.padded_img_shape, num_proposals=p).to(device).eval()
    if args.checkpoint:
        load_weights(args.checkpoint, model)
        print(f"loaded params from {args.checkpoint}")
    else:
        init_weights(model, seed=cfg.seed)

    t_eval = time.perf_counter()
    try:
        res = evaluate(model, cfg, p, args.infos, args.num_workers, device, tta=args.tta, out=args.out)
    finally:
        if own_group:
            destroy_distributed()
    if res is None:
        return None
    res["timing"]["setup_s"] += t_eval - t_start
    print(json.dumps(res["metrics"], indent=2, sort_keys=True))
    print(json.dumps({"timing": res["timing"], "device": str(device), "config": args.config, "tta": args.tta,
                      "levers": dataclasses.asdict(model.levers), "launches": launch_counts(),
                      "metrics": res["metrics"]}))
    return res


if __name__ == "__main__":
    main()

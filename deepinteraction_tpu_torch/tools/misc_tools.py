"""Misc tools (the port's counterpart of ``tools/misc_tools.py``; reference
``tools/misc/*``): print_config, fuse_conv_bn, visualize_results and
browse_dataset::

    python -m deepinteraction_tpu_torch.tools.misc_tools print_config fusion_base
    python -m deepinteraction_tpu_torch.tools.misc_tools fuse_conv_bn fusion_base --checkpoint ck/ --out fused/
    python -m deepinteraction_tpu_torch.tools.misc_tools visualize_results --detections det.pkl \\
        --infos val.pkl --out viz/
    python -m deepinteraction_tpu_torch.tools.misc_tools browse_dataset tiny --infos train.pkl --out viz/

``fuse_conv_bn`` is an offline conversion on the CPU (``utils/fuse_bn.py``):
it loads a port checkpoint into a :class:`~..train.step.TrainStep`, folds,
and saves the folded checkpoint at step 0. The two visualisers need
matplotlib (imported when they run; they raise without it).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pickle
from typing import List, Optional

import numpy as np

from ..data.dataset import NuScenesDataset, load_infos
from .test import CONFIGS


def print_config(args):
    cfg = CONFIGS[args.config]()
    print(json.dumps(dataclasses.asdict(cfg), indent=2, default=str))


def fuse(args):
    from ..models.detector import DeepInteraction
    from ..train.checkpoint import load_params, save_checkpoint
    from ..train.step import TrainStep
    from ..utils.fuse_bn import fuse_conv_bn
    from ..utils.synthetic import init_weights

    cfg = CONFIGS[args.config]()
    model = DeepInteraction(cfg.model, cfg.data.padded_img_shape)
    init_weights(model, seed=0)
    step = TrainStep(cfg, model, 1, device="cpu")
    if args.checkpoint:
        load_params(args.checkpoint, step)
    n = fuse_conv_bn(model)
    print(f"fused {n} conv+bn pairs")
    save_checkpoint(args.out, step)


def _pyplot():
    try:
        import matplotlib
    except ImportError as e:
        raise RuntimeError("the visualisers need matplotlib, which is not installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _draw_bev(ax, boxes, color, label=None):
    for b in boxes:
        x, y, dx, dy, yaw = b[0], b[1], b[3], b[4], b[6]
        c, s = np.cos(yaw), np.sin(yaw)
        corners = np.array([[dx / 2, dy / 2], [dx / 2, -dy / 2], [-dx / 2, -dy / 2], [-dx / 2, dy / 2],
                            [dx / 2, dy / 2]])
        rot = corners @ np.array([[c, s], [-s, c]])
        ax.plot(rot[:, 0] + x, rot[:, 1] + y, color=color, linewidth=0.7, label=label)
        label = None


def visualize_results(args):
    plt = _pyplot()
    with open(args.detections, "rb") as f:
        det = pickle.load(f)
    infos = {i["token"]: i for i in load_infos(args.infos)}
    os.makedirs(args.out, exist_ok=True)
    for token, frame in list(zip(det["tokens"], det["frames"]))[: args.limit]:
        fig, ax = plt.subplots(figsize=(8, 8))
        info = infos.get(token)
        if info is not None and len(info.get("gt_boxes", ())):
            _draw_bev(ax, info["gt_boxes"], "tab:green", "gt")
        keep = frame.scores > args.score_thr
        _draw_bev(ax, frame.boxes[keep], "tab:red", "pred")
        ax.set_xlim(-60, 60)
        ax.set_ylim(-60, 60)
        ax.set_aspect("equal")
        ax.legend(loc="upper right")
        fig.savefig(os.path.join(args.out, f"{token}.png"), dpi=100, bbox_inches="tight")
        plt.close(fig)
    print("wrote", min(len(det["tokens"]), args.limit), "BEV plots to", args.out)


def browse_dataset(args):
    plt = _pyplot()
    cfg = CONFIGS[args.config]()
    ds = NuScenesDataset(cfg, args.infos, train=True, use_cbgs=False)
    os.makedirs(args.out, exist_ok=True)
    for i in range(min(len(ds), args.limit)):
        s = ds[i]
        fig, ax = plt.subplots(figsize=(8, 8))
        pts = s["points"][s["points_mask"]]
        ax.scatter(pts[:, 0], pts[:, 1], s=0.2, c=pts[:, 2], cmap="viridis")
        if "gt_boxes" in s:
            _draw_bev(ax, s["gt_boxes"][s["gt_mask"]], "tab:red", "gt")
        ax.set_aspect("equal")
        fig.savefig(os.path.join(args.out, f"sample{i}.png"), dpi=100, bbox_inches="tight")
        plt.close(fig)
    print("wrote", min(len(ds), args.limit), "pipeline visualizations to", args.out)


def main(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description="Misc tools (PyTorch port)")
    sub = p.add_subparsers(dest="cmd", required=True)
    configs = sorted(CONFIGS)

    pc = sub.add_parser("print_config")
    pc.add_argument("config", choices=configs)
    pc.set_defaults(fn=print_config)

    fb = sub.add_parser("fuse_conv_bn")
    fb.add_argument("config", choices=configs)
    fb.add_argument("--checkpoint", default=None)
    fb.add_argument("--out", required=True)
    fb.set_defaults(fn=fuse)

    vr = sub.add_parser("visualize_results")
    vr.add_argument("--detections", required=True)
    vr.add_argument("--infos", required=True)
    vr.add_argument("--out", required=True)
    vr.add_argument("--score-thr", type=float, default=0.1)
    vr.add_argument("--limit", type=int, default=20)
    vr.set_defaults(fn=visualize_results)

    bd = sub.add_parser("browse_dataset")
    bd.add_argument("config", choices=configs)
    bd.add_argument("--infos", required=True)
    bd.add_argument("--out", required=True)
    bd.add_argument("--limit", type=int, default=10)
    bd.set_defaults(fn=browse_dataset)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()

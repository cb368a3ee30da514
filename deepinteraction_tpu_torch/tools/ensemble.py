"""Multi-model ensembling (the port's counterpart of ``tools/ensemble.py``):
merge detection pkls per sample with weighted box fusion
(``eval/tta.py::merge_detections``) and print the nuScenes metrics. Each
member is the ``--out`` of ``tools/test.py`` (with or without ``--tta``)::

    python -m deepinteraction_tpu_torch.tools.ensemble --infos val.pkl --out fused.pkl \\
        member1.pkl member2.pkl ...

Host code only (numpy): no device is used.
"""

from __future__ import annotations

import argparse
import json
import pickle
from typing import List, Optional

import numpy as np

from ..configs import DataConfig
from ..data.dataset import load_infos
from ..eval.nuscenes_metrics import DetectionFrame, evaluate_detections
from ..eval.results import default_attribute, gt_frame_from_info
from ..eval.tta import merge_detections


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description="Ensemble detection pkls (PyTorch port)")
    p.add_argument("members", nargs="+", help="detections pkls from tools/test.py --out")
    p.add_argument("--infos", required=True, help="val info pkl for evaluation")
    p.add_argument("--out", default=None)
    p.add_argument("--radius", type=float, default=0.5, help="fusion cluster radius (m)")
    p.add_argument("--classes", nargs="*", default=None, help="class names (default: nuScenes 10)")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> dict:
    """Fuse the members, write ``--out`` if given, print and return the
    metrics."""
    args = parse_args(argv)
    class_names = tuple(args.classes) if args.classes else DataConfig().class_names

    members = []
    for path in args.members:
        with open(path, "rb") as f:
            members.append(pickle.load(f))
    tokens = members[0]["tokens"]
    for m in members[1:]:
        if m["tokens"] != tokens:
            raise ValueError("members cover different samples")

    name_to_idx = {n: i for i, n in enumerate(class_names)}
    fused_frames = []
    for si in range(len(tokens)):
        boxes_l, scores_l, labels_l = [], [], []
        for m in members:
            fr = m["frames"][si]
            boxes_l.append(np.concatenate([fr.boxes, fr.velocity.reshape(len(fr.boxes), -1)], axis=1))
            scores_l.append(np.asarray(fr.scores))
            labels_l.append(np.asarray([name_to_idx[n] for n in fr.names]))
        fb, fs, fl = merge_detections(boxes_l, scores_l, labels_l, radius=args.radius)
        names = np.asarray([class_names[int(i)] for i in fl])
        vel = fb[:, 7:9] if fb.shape[1] >= 9 else np.zeros((len(fb), 2))
        attrs = np.asarray([default_attribute(n, float(np.linalg.norm(v))) for n, v in zip(names, vel)])
        fused_frames.append(DetectionFrame(boxes=fb[:, :7], velocity=vel, names=names, scores=fs,
                                           attributes=attrs))

    if args.out:
        with open(args.out, "wb") as f:
            pickle.dump({"tokens": tokens, "frames": fused_frames}, f)

    by_tok = {i["token"]: i for i in load_infos(args.infos)}
    gts = [gt_frame_from_info(by_tok[t]) for t in tokens]
    metrics = evaluate_detections(gts, fused_frames, class_names)
    print(json.dumps(metrics, indent=2, sort_keys=True))
    return metrics


if __name__ == "__main__":
    main()

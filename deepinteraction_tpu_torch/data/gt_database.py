"""GT database creation, ObjectSample (copy-paste) augmentation and the
Fading hook (the port's numpy copy of
``deepinteraction_tpu/data/gt_database.py``).

Rebuild of the reference's offline ``create_groundtruth_database``
(tools/data_converter/create_gt_database.py:109) and mmdet3d's
``ObjectSample`` transform, plus the ``Fading`` hook
(core/hook/fading.py:6-23) that disables GT paste at a given epoch.
The shipped DeepInteraction configs train without ObjectSample (both are
fusion fine-tunes), but the hook and the database are part of the
reference's API and matter for LiDAR pretraining from scratch.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np

from .pipeline import load_sweep_points


def points_in_box(points: np.ndarray, box: np.ndarray) -> np.ndarray:
    """Mask of points inside one (x, y, z_bottom, dx, dy, dz, yaw) box."""
    d = points[:, :3] - box[:3]
    c, s = np.cos(-box[6]), np.sin(-box[6])
    lx = c * d[:, 0] - s * d[:, 1]
    ly = s * d[:, 0] + c * d[:, 1]
    lz = d[:, 2]
    return (
        (np.abs(lx) <= box[3] / 2)
        & (np.abs(ly) <= box[4] / 2)
        & (lz >= 0)
        & (lz <= box[5])
    )


def create_gt_database(
    infos: Sequence[dict],
    out_dir: str,
    num_sweeps: int = 10,
    min_points: int = 5,
) -> str:
    """Crop every GT's points into per-class .bin files plus an index pkl;
    returns the index's path."""
    os.makedirs(os.path.join(out_dir, "gt_database"), exist_ok=True)
    index: Dict[str, List[dict]] = {}
    for info in infos:
        pts = load_sweep_points(info, num_sweeps, None)
        for gi, (box, name) in enumerate(zip(info["gt_boxes"], info["gt_names"])):
            mask = points_in_box(pts, np.asarray(box, np.float32))
            n = int(mask.sum())
            if n < min_points:
                continue
            obj = pts[mask].copy()
            obj[:, :3] -= np.asarray(box[:3], np.float32)  # box-local
            fn = f"gt_database/{info['token']}_{name}_{gi}.bin"
            obj.astype(np.float32).tofile(os.path.join(out_dir, fn))
            vel = np.asarray(info.get("gt_velocity", np.zeros((len(info["gt_boxes"]), 2))))[gi]
            index.setdefault(str(name), []).append(
                {
                    "path": fn,
                    "box": np.asarray(box, np.float32),
                    "velocity": np.asarray(vel, np.float32),
                    "num_points": n,
                }
            )
    path = os.path.join(out_dir, "gt_database_infos.pkl")
    with open(path, "wb") as f:
        pickle.dump(index, f)
    return path


class ObjectSampler:
    """mmdet3d DataBaseSampler-style GT paste: sample per-class objects up
    to the configured counts, reject BEV-colliding candidates, paste their
    points and boxes into the scene."""

    def __init__(
        self,
        db_info_path: str,
        data_root: str,
        sample_groups: Dict[str, int],
        min_points: int = 5,
    ):
        with open(db_info_path, "rb") as f:
            self.index = pickle.load(f)
        self.root = data_root
        self.groups = dict(sample_groups)
        self.min_points = min_points

    @staticmethod
    def _collide(a: np.ndarray, boxes: np.ndarray) -> bool:
        """Cheap BEV circle test (center distance vs half-diagonals)."""
        if not len(boxes):
            return False
        ra = 0.5 * np.hypot(a[3], a[4])
        rb = 0.5 * np.hypot(boxes[:, 3], boxes[:, 4])
        d = np.linalg.norm(boxes[:, :2] - a[:2], axis=1)
        return bool((d < ra + rb).any())

    def __call__(
        self,
        points: np.ndarray,
        gt_boxes: np.ndarray,
        gt_labels: np.ndarray,
        class_names: Sequence[str],
        rng: np.random.Generator,
    ):
        name_to_idx = {n: i for i, n in enumerate(class_names)}
        counts = {n: int((gt_labels == name_to_idx.get(n, -1)).sum()) for n in self.groups}
        new_pts, new_boxes, new_labels = [], [], []
        all_boxes = np.asarray(gt_boxes, np.float32).reshape(-1, gt_boxes.shape[-1])
        for name, target in self.groups.items():
            pool = self.index.get(name, ())
            need = max(target - counts.get(name, 0), 0)
            if not pool or need == 0 or name not in name_to_idx:
                continue
            for j in rng.choice(len(pool), min(need, len(pool)), replace=False):
                entry = pool[int(j)]
                box = entry["box"].copy()
                if self._collide(box, all_boxes):
                    continue
                obj = np.fromfile(
                    os.path.join(self.root, entry["path"]), np.float32
                ).reshape(-1, points.shape[1])
                obj = obj.copy()
                obj[:, :3] += box[:3]
                full = np.concatenate([box, entry["velocity"]])[: gt_boxes.shape[-1]]
                new_pts.append(obj)
                new_boxes.append(full)
                new_labels.append(name_to_idx[name])
                all_boxes = np.concatenate([all_boxes, full[None]], 0)
        if not new_boxes:
            return points, gt_boxes, gt_labels
        # remove scene points inside pasted boxes (mmdet3d semantics)
        keep = np.ones(len(points), bool)
        for b in new_boxes:
            keep &= ~points_in_box(points, np.asarray(b))
        points = np.concatenate([points[keep]] + new_pts, 0)
        gt_boxes = np.concatenate([gt_boxes, np.asarray(new_boxes, np.float32)], 0)
        gt_labels = np.concatenate([gt_labels, np.asarray(new_labels, gt_labels.dtype)])
        return points, gt_boxes, gt_labels


def fading_active(epoch: int, fade_epoch: Optional[int]) -> bool:
    """Reference Fading hook: ObjectSample is popped from the live pipeline
    once ``epoch >= fade_epoch`` (core/hook/fading.py:18-23)."""
    return fade_epoch is None or epoch < fade_epoch

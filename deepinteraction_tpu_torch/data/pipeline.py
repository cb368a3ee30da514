"""Online host pipeline: info dict -> static-shape sample (port of
``deepinteraction_tpu/data/pipeline.py``, numpy only).

Functional numpy rebuild of the reference's declarative pipeline
(config Fusion_0075_refactor.py:24-92 + transform_3d.py semantics):
LoadPointsFromFile(5) -> LoadPointsFromMultiSweeps(10) -> LoadAnnotations3D
-> LoadMultiViewImageFromFiles -> GlobalRotScaleTrans -> RandomFlip3D ->
Points/ObjectRangeFilter -> ObjectNameFilter -> PointShuffle -> static-shape
padding (fixed N points, fixed G boxes).

The image stage is split in two. The host part here reads each camera's
JPEG **bytes** (``jpeg``) and keeps ``lidar2img`` as the calibration gives
it, with the train flip in ``img_flip``; ``ops/images.py::process_images``
decodes, resizes, normalises and pads the images on the batch's device and
folds the resize and the flip into ``lidar2img`` (``DataLoader.to_device``
runs it). Sweeps load through the native reader (``data/native``, the
JAX package's default path: each sweep moved into the key frame in double
precision), so the points are JAX's bit for bit;
``load_sweep_points_plain`` is the float32 numpy version, for tests. GT
paste (``sampler``, ``data/gt_database.py``) runs before the global
augmentation while the Fading hook keeps it active.

Deliberate deviations from the reference, kept from the JAX package:

- Augmentations are folded into a single 4x4 ``lidar_aug`` matrix (and its
  inverse) consumed by the model, instead of mmdet3d's
  ``transformation_3d_flow`` metadata + ``apply_3d_transformation`` replay.
- RandomFlip3D(sync_2d=True) in the reference flips the images but never
  updates lidar2img; here the horizontal image flip is folded into
  lidar2img (x' = W - x) so camera features stay consistent. Test-time
  behavior is identical (no flips fire).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..configs import Config
from . import native


def load_points(path: str, load_dim: int = 5) -> np.ndarray:
    pts = np.fromfile(path, dtype=np.float32).reshape(-1, load_dim)
    return pts


def _sweep_choice(num_available: int, num_sweeps: int, rng):
    if num_available <= num_sweeps:
        return np.arange(num_available)
    if rng is not None:
        return rng.choice(num_available, num_sweeps, replace=False)
    return np.arange(num_sweeps)


_NO_RANGE = (-1e9, -1e9, -1e9, 1e9, 1e9, 1e9)


def load_sweep_points(
    info: dict,
    num_sweeps: int,
    rng: Optional[np.random.Generator],
    load_dim: int = 5,
) -> np.ndarray:
    """Key points + transformed sweeps with relative timestamps
    (mmdet3d LoadPointsFromMultiSweeps semantics: key ts column zeroed,
    sweep ts = (key_ts - sweep_ts)/1e6; random sweep choice in train,
    first-n in eval), through the native reader: each sweep moved into the
    key frame in double precision, as the JAX package's default path."""
    sweeps = info["sweeps"]
    chosen = [sweeps[int(i)] for i in _sweep_choice(len(sweeps), num_sweeps, rng)]
    ts_key = info["timestamp"] / 1e6
    paths = [info["lidar_path"]] + [s["data_path"] for s in chosen]
    rots = np.stack([np.eye(3)] + [np.asarray(s["sensor2lidar_rotation"]) for s in chosen])
    trans = np.stack([np.zeros(3)] + [np.asarray(s["sensor2lidar_translation"]) for s in chosen])
    ts = np.asarray([0.0] + [ts_key - s["timestamp"] / 1e6 for s in chosen])
    # JAX's cap, 400 000 rows a cloud; the range box keeps every point, so
    # a buffer of the rows on disk holds them all and leaves no padding
    cap = native.MAX_CLOUD_ROWS * (1 + len(chosen))
    rows = sum(min(os.path.getsize(p) // (4 * load_dim), native.MAX_CLOUD_ROWS) for p in paths)
    pts, _, n = native.assemble_points(paths, rots, trans, ts, _NO_RANGE, min(cap, rows), load_dim)
    return pts[:n]


def load_sweep_points_plain(
    info: dict,
    num_sweeps: int,
    rng: Optional[np.random.Generator],
    load_dim: int = 5,
) -> np.ndarray:
    """Plain version of :func:`load_sweep_points`: the same sweeps in
    float32 numpy (``pts @ R.T + t``), within an ulp of the native reader."""
    sweeps = info["sweeps"]
    choices = _sweep_choice(len(sweeps), num_sweeps, rng)
    ts_key = info["timestamp"] / 1e6

    key = load_points(info["lidar_path"], load_dim)
    key[:, 4] = 0.0
    out = [key]
    for i in choices:
        sw = sweeps[int(i)]
        pts = load_points(sw["data_path"], load_dim)
        r = np.asarray(sw["sensor2lidar_rotation"], np.float32)
        t = np.asarray(sw["sensor2lidar_translation"], np.float32)
        pts[:, :3] = pts[:, :3] @ r.T + t
        pts[:, 4] = ts_key - sw["timestamp"] / 1e6
        out.append(pts)
    return np.concatenate(out, axis=0)


def lidar2img_matrices(info: dict) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """Per-camera 4x4 lidar->image and cam->lidar matrices, the construction
    of CustomNuScenesDataset.get_data_info (nuscenes_dataset.py:50-83; the ++
    polar block consumes cam2lidar)."""
    mats, c2ls, paths = [], [], []
    for cam in info["cams"].values():
        r = np.asarray(cam["sensor2lidar_rotation"], np.float64)
        t = np.asarray(cam["sensor2lidar_translation"], np.float64)
        l2c = np.eye(4)
        l2c[:3, :3] = r.T
        l2c[:3, 3] = -r.T @ t
        viewpad = np.eye(4)
        intr = np.asarray(cam["cam_intrinsic"], np.float64)
        viewpad[: intr.shape[0], : intr.shape[1]] = intr
        mats.append(viewpad @ l2c)
        c2l = np.eye(4)
        c2l[:3, :3] = r
        c2l[:3, 3] = t
        c2ls.append(c2l)
        paths.append(cam["data_path"])
    return np.asarray(mats, np.float32), np.asarray(c2ls, np.float32), paths


def rot_z(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], np.float32)


def global_rot_scale_trans(
    points: np.ndarray,
    boxes: np.ndarray,
    rng: np.random.Generator,
    rot_range: Tuple[float, float],
    scale_range: Tuple[float, float],
    trans_std: Sequence[float],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """mmdet3d GlobalRotScaleTrans: rotate about z, uniform scale, gaussian
    translate — applied to points, box centers/dims/yaw/velocity.

    Returns (points, boxes, aug_4x4) with aug(p) = s*R @ p + t.
    """
    theta = float(rng.uniform(*rot_range))
    scale = float(rng.uniform(*scale_range))
    trans = rng.normal(scale=np.asarray(trans_std)).astype(np.float32)

    r = rot_z(theta)
    points = points.copy()
    points[:, :3] = points[:, :3] @ r.T * scale + trans
    if boxes.size:
        boxes = boxes.copy()
        boxes[:, :3] = boxes[:, :3] @ r.T * scale + trans
        boxes[:, 3:6] *= scale
        boxes[:, 6] += theta
        if boxes.shape[1] >= 9:
            boxes[:, 7:9] = boxes[:, 7:9] @ r[:2, :2].T * scale
    aug = np.eye(4, dtype=np.float32)
    aug[:3, :3] = r * scale
    aug[:3, 3] = trans
    return points, boxes, aug


def random_flip(
    points: np.ndarray,
    boxes: np.ndarray,
    rng: np.random.Generator,
    ratio_h: float,
    ratio_v: float,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, bool]:
    """BEV flips (mmdet3d RandomFlip3D): 'horizontal' mirrors y, 'vertical'
    mirrors x. Returns (points, boxes, flip_4x4, flip_h fired)."""
    flip_h = bool(rng.uniform() < ratio_h)
    flip_v = bool(rng.uniform() < ratio_v)
    points = points.copy()
    boxes = boxes.copy() if boxes.size else boxes
    f = np.eye(4, dtype=np.float32)
    if flip_h:
        points[:, 1] *= -1
        f[1, 1] = -1
        if boxes.size:
            boxes[:, 1] *= -1
            boxes[:, 6] = -boxes[:, 6]
            if boxes.shape[1] >= 9:
                boxes[:, 8] *= -1
    if flip_v:
        points[:, 0] *= -1
        f[0, 0] = -1
        if boxes.size:
            boxes[:, 0] *= -1
            boxes[:, 6] = np.pi - boxes[:, 6]
            if boxes.shape[1] >= 9:
                boxes[:, 7] *= -1
    return points, boxes, f, flip_h


def filter_points_range(points: np.ndarray, pcr: Sequence[float]) -> np.ndarray:
    m = (
        (points[:, 0] >= pcr[0])
        & (points[:, 0] <= pcr[3])
        & (points[:, 1] >= pcr[1])
        & (points[:, 1] <= pcr[4])
        & (points[:, 2] >= pcr[2])
        & (points[:, 2] <= pcr[5])
    )
    return points[m]


def filter_objects_range(
    boxes: np.ndarray, labels: np.ndarray, pcr: Sequence[float]
) -> Tuple[np.ndarray, np.ndarray]:
    """mmdet3d ObjectRangeFilter: keep boxes whose BEV center is in range;
    also limits yaw to [-pi, pi)."""
    if not boxes.size:
        return boxes, labels
    m = (
        (boxes[:, 0] >= pcr[0])
        & (boxes[:, 0] <= pcr[3])
        & (boxes[:, 1] >= pcr[1])
        & (boxes[:, 1] <= pcr[4])
    )
    boxes, labels = boxes[m], labels[m]
    boxes[:, 6] = (boxes[:, 6] + np.pi) % (2 * np.pi) - np.pi
    return boxes, labels


def read_jpegs(paths: Sequence[str]) -> List[np.ndarray]:
    """Each camera's JPEG file as its bytes (``uint8``)."""
    out = []
    for path in paths:
        if not os.path.exists(path):
            raise FileNotFoundError(f"failed to read {path}")
        out.append(np.fromfile(path, np.uint8))
    return out


def pad_to(arr: np.ndarray, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pad/truncate leading dim to n, returning (padded, valid_mask)."""
    k = min(arr.shape[0], n)
    out = np.zeros((n,) + arr.shape[1:], arr.dtype)
    out[:k] = arr[:k]
    mask = np.zeros((n,), bool)
    mask[:k] = True
    return out, mask


def build_sample(
    info: dict,
    cfg: Config,
    train: bool,
    rng: Optional[np.random.Generator] = None,
    class_names: Optional[Sequence[str]] = None,
    sampler=None,  # data.gt_database.ObjectSampler (GT paste)
    epoch: int = 0,
) -> Dict[str, np.ndarray]:
    """The host pipeline for one sample: the detector's batch dict
    (models/detector.py docstring) without the leading batch dim, with the
    cameras' JPEG bytes (``jpeg``) and ``img_flip`` in place of ``images``
    and ``img2lidar``, which the image stage makes."""
    d = cfg.data
    class_names = class_names or d.class_names
    pcr = cfg.model.pts_voxel_layer.point_cloud_range
    rng = rng or np.random.default_rng(0)

    points = load_sweep_points(info, d.num_sweeps, rng if train else None, d.load_dim)

    if train and "gt_boxes" in info:
        valid = info.get("valid_flag", np.ones(len(info["gt_boxes"]), bool))
        boxes7 = np.asarray(info["gt_boxes"], np.float32)[valid]
        vel = np.asarray(info["gt_velocity"], np.float32)[valid]
        names = np.asarray(info["gt_names"])[valid]
        boxes = np.concatenate([boxes7, np.nan_to_num(vel)], axis=1)
        name_to_idx = {n: i for i, n in enumerate(class_names)}
        labels = np.asarray([name_to_idx.get(n, -1) for n in names], np.int64)
        keep = labels >= 0  # ObjectNameFilter
        boxes, labels = boxes[keep], labels[keep]
    else:
        boxes = np.zeros((0, 9), np.float32)
        labels = np.zeros((0,), np.int64)

    lidar2img, cam2lidar, img_paths = lidar2img_matrices(info)

    aug = np.eye(4, dtype=np.float32)
    flip_h = False
    if train and sampler is not None:
        from .gt_database import fading_active  # gt_database imports this module

        if fading_active(epoch, d.fade_epoch):
            points, boxes, labels = sampler(points, boxes, labels, class_names, rng)
    if train:
        points, boxes, a = global_rot_scale_trans(
            points, boxes, rng, d.rot_range, d.scale_ratio_range, d.translation_std
        )
        points, boxes, f, flip_h = random_flip(
            points, boxes, rng, d.flip_ratio_horizontal, d.flip_ratio_vertical
        )
        aug = f @ a

    points = filter_points_range(points, pcr)
    boxes, labels = filter_objects_range(boxes, labels, pcr)
    if train:
        rng.shuffle(points, axis=0)

    pts, pmask = pad_to(points.astype(np.float32), d.max_points)
    sample = {
        "points": pts,
        "points_mask": pmask,
        "jpeg": read_jpegs(img_paths),
        "lidar2img": lidar2img,  # before the image stage's resize and flip
        "img_flip": np.asarray(flip_h),
        "cam2lidar": cam2lidar,
        "lidar_aug": aug,
        "lidar_aug_inv": np.linalg.inv(aug.astype(np.float64)).astype(np.float32),
    }
    if train:
        gt, gmask = pad_to(boxes.astype(np.float32), d.max_gt_boxes)
        lab, _ = pad_to(labels.astype(np.int32), d.max_gt_boxes)
        sample["gt_boxes"] = gt
        sample["gt_labels"] = lab
        sample["gt_mask"] = gmask
    else:
        sample["token"] = info["token"]
    return sample


def collate(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack per-sample dicts into a batch ('token' and 'jpeg' -> lists)."""
    out: Dict[str, np.ndarray] = {}
    for k in samples[0]:
        if k in ("token", "jpeg"):
            out[k] = [s[k] for s in samples]
        else:
            out[k] = np.stack([s[k] for s in samples], axis=0)
    return out

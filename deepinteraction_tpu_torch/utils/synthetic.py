"""Synthetic batches, and seeded weights, with no JAX.

:func:`make_synthetic_batch` is a pure-numpy copy of
``deepinteraction_tpu/utils/testing.py::make_synthetic_batch``: the same seed
gives byte-identical arrays (``tests/test_torch_port_package.py`` checks it).
The JAX module cannot be imported where JAX is missing, because
``deepinteraction_tpu/utils/__init__.py`` imports JAX.

:func:`init_weights` fills a port model with the recipe of
``deepinteraction_tpu/utils/testing.py::fast_init_variables``, leaf by leaf
in the Flax tree's flatten order, so the same seed gives the same weights.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from deepinteraction_tpu.configs import Config


def make_synthetic_batch(
    cfg: Config, b: int = 1, seed: int = 0, with_gt: bool = False
) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    d = cfg.data
    v = d.num_views
    h, w = d.padded_img_shape
    n = d.max_points
    pcr = cfg.model.pts_voxel_layer.point_cloud_range

    pts = np.empty((b, n, 5), np.float32)
    pts[..., 0] = rng.uniform(pcr[0] * 0.9, pcr[3] * 0.9, size=(b, n))
    pts[..., 1] = rng.uniform(pcr[1] * 0.9, pcr[4] * 0.9, size=(b, n))
    pts[..., 2] = rng.uniform(pcr[2] * 0.8, pcr[5] * 0.8, size=(b, n))
    pts[..., 3] = rng.uniform(0.0, 255.0, size=(b, n))
    pts[..., 4] = 0.0
    mask = rng.uniform(size=(b, n)) > 0.3

    imgs = rng.normal(size=(b, v, h, w, 3)).astype(np.float32)

    l2i = np.zeros((b, v, 4, 4), np.float32)
    focal = 0.6 * w
    for i in range(v):
        intr = np.eye(4, dtype=np.float32)
        intr[0, 0] = focal
        intr[1, 1] = focal
        intr[0, 2] = w / 2
        intr[1, 2] = h / 2
        ang = 2.0 * np.pi * i / v
        # camera i looks outward at azimuth `ang`; rows of lidar2cam are the
        # camera axes in the lidar frame: x right, y down, z forward
        rot = np.eye(4, dtype=np.float32)
        c, s = np.cos(ang), np.sin(ang)
        rot[0, :3] = (s, -c, 0.0)
        rot[1, :3] = (0.0, 0.0, -1.0)
        rot[2, :3] = (c, s, 0.0)
        l2i[:, i] = intr @ rot
    eye = np.broadcast_to(np.eye(4, dtype=np.float32), (b, 4, 4)).copy()

    c2l = np.linalg.inv(l2i.astype(np.float64)).astype(np.float32)
    batch = {
        "points": pts,
        "points_mask": mask,
        "images": imgs,
        "lidar2img": l2i,
        "img2lidar": np.linalg.inv(l2i),
        "cam2lidar": c2l,
        "lidar_aug": eye,
        "lidar_aug_inv": eye,
    }
    if with_gt:
        g = d.max_gt_boxes
        gt = np.zeros((b, g, 9), np.float32)
        gt[..., 0] = rng.uniform(pcr[0] * 0.7, pcr[3] * 0.7, size=(b, g))
        gt[..., 1] = rng.uniform(pcr[1] * 0.7, pcr[4] * 0.7, size=(b, g))
        gt[..., 2] = rng.uniform(-2.0, 0.0, size=(b, g))
        gt[..., 3:6] = rng.uniform(0.5, 4.0, size=(b, g, 3))
        gt[..., 6] = rng.uniform(-np.pi, np.pi, size=(b, g))
        gt[..., 7:9] = rng.normal(scale=0.5, size=(b, g, 2))
        n_real = max(2, g // 2)
        batch["gt_boxes"] = gt
        batch["gt_labels"] = rng.integers(
            0, cfg.model.pts_bbox_head.num_classes, size=(b, g)
        ).astype(np.int32)
        batch["gt_mask"] = (np.arange(g)[None] < n_real) & np.ones((b, 1), bool)
    return batch


def to_torch(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """numpy batch -> tensors on ``device`` (float64 matrices become f32,
    as JAX's default 32-bit mode makes them)."""
    out = {}
    for k, a in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(a))
        if t.dtype == torch.float64:
            t = t.float()
        out[k] = t.to(device)
    return out


def init_weights(model: torch.nn.Module, seed: int = 0) -> None:
    """Fill ``model`` in place with seeded init-like weights.

    The recipe of ``fast_init_variables``: norm scales and running variances
    get ones, biases and running means zeros, everything else normal noise
    with std 1/sqrt(fan_in), fan_in = prod(flax_shape[:-1]). Leaves are drawn
    in the Flax flatten order (sorted paths), so a seed gives the weights
    ``fast_init_variables`` gives the JAX model.
    """
    from ..convert import flax_leaf_shapes, params_from_flax

    shapes = flax_leaf_shapes(model)
    rng = np.random.default_rng(seed)
    leaves = {}
    for path in sorted(shapes, key=lambda p: tuple(p.split("/"))):
        shape = shapes[path]
        name = path.rsplit("/", 1)[-1].lower()
        if "scale" in name or "var" in name:
            leaves[path] = np.ones(shape, np.float32)
        elif "bias" in name or "mean" in name:
            leaves[path] = np.zeros(shape, np.float32)
        else:
            fan_in = int(np.prod(shape[:-1])) if len(shape) >= 2 else 1
            std = 1.0 / max(1.0, float(fan_in)) ** 0.5
            leaves[path] = rng.normal(scale=std, size=shape).astype(np.float32)
    model.load_state_dict(params_from_flax(leaves, model))

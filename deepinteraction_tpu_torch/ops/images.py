"""The image stage of the data pipeline, on the batch's device (port of
``deepinteraction_tpu/data/pipeline.py::process_images``, ``:229-264``).

The host reads each camera's JPEG bytes (``data/pipeline.py``); here they
are decoded (``ops/jpeg.py``: nvJPEG on the card, cv2 on the CPU), turned to
float, resized to ``img_scale`` (``F.interpolate``, bilinear, half-pixel
centres, no antialias: the arithmetic of ``cv2.resize(INTER_LINEAR)`` on
float32), flipped where the train pipeline flipped the scene, normalised
and zero-padded into the batch's [B, V, H, W, 3] layout. The resize scale,
from each decoded size, and the flip are folded into ``lidar2img`` on the
host in float32, with the JAX package's arithmetic, and ``img2lidar`` is
its float64 inverse.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..configs import DataConfig
from ..utils.spans import span
from . import jpeg


def fold_scale(lidar2img: np.ndarray, size_hw: Tuple[int, int], d: DataConfig, flip: bool) -> np.ndarray:
    """One view's lidar2img [4, 4] float32 with the resize from a decoded
    image of ``size_hw`` to ``img_scale`` and the horizontal flip folded in
    (``transform_3d.py:129-134`` of the reference)."""
    target_w, target_h = d.img_scale
    h0, w0 = size_hw
    scale = np.eye(4, dtype=np.float32)
    scale[0, 0] = target_w / w0
    scale[1, 1] = target_h / h0
    m = scale @ lidar2img
    if flip:
        fm = np.eye(4, dtype=np.float32)
        fm[0, 0] = -1.0
        fm[0, 2] = float(target_w)
        m = fm @ m
    return m


def prepare_images(pixels: Sequence[torch.Tensor], flips: Sequence[bool], d: DataConfig) -> torch.Tensor:
    """Decoded RGB ``uint8`` images [h, w, 3] (one device) -> float32
    [N, pad_h, pad_w, 3]: resized to ``img_scale``, flipped where asked,
    normalised, zero-padded. Images of one size are resized in one call."""
    with span("di.image_stage"):
        target_w, target_h = d.img_scale
        ph, pw = d.padded_img_shape
        dev = pixels[0].device
        with span("di.sync.images.mean"):
            mean = torch.tensor(d.img_norm_mean, dtype=torch.float32, device=dev)
        with span("di.sync.images.std"):
            std = torch.tensor(d.img_norm_std, dtype=torch.float32, device=dev)
        out = torch.zeros((len(pixels), ph, pw, 3), dtype=torch.float32, device=dev)
        groups = {}
        for i, p in enumerate(pixels):
            groups.setdefault(tuple(p.shape), []).append(i)
        for idx in groups.values():
            x = torch.stack([pixels[i] for i in idx]).permute(0, 3, 1, 2).float()
            x = F.interpolate(x, size=(target_h, target_w), mode="bilinear", align_corners=False, antialias=False)
            x = x.permute(0, 2, 3, 1)
            with span("di.sync.images.flip"):
                flip = torch.tensor([bool(flips[i]) for i in idx], device=dev)
            x = torch.where(flip[:, None, None, None], x.flip(2), x)
            x = (x - mean) / std
            with span("di.sync.images.rows"):  # the list of rows goes to the device
                out[idx, :target_h, :target_w] = x
        return out


def process_images(jpegs: Sequence[Sequence], lidar2img: np.ndarray, flips: Sequence[bool], d: DataConfig,
                   device) -> Tuple[torch.Tensor, np.ndarray, np.ndarray]:
    """A batch's JPEGs (``jpegs[b][v]``, bytes), its lidar2img [B, V, 4, 4]
    float32 before any resize and the per-sample flips -> images
    [B, V, pad_h, pad_w, 3] on ``device``, lidar2img and img2lidar
    [B, V, 4, 4] float32 (numpy). One batched decode for the whole batch."""
    b, v = len(jpegs), len(jpegs[0])
    pixels: List[torch.Tensor] = jpeg.decode([j for views in jpegs for j in views], device)
    flat_flips = [bool(flips[i // v]) for i in range(b * v)]
    mats = np.stack([fold_scale(lidar2img[i // v, i % v], tuple(p.shape[:2]), d, flat_flips[i])
                     for i, p in enumerate(pixels)]).reshape(b, v, 4, 4)
    images = prepare_images(pixels, flat_flips, d)
    ph, pw = d.padded_img_shape
    img2lidar = np.linalg.inv(mats.astype(np.float64)).astype(np.float32)
    return images.reshape(b, v, ph, pw, 3), mats, img2lidar


def to_device(batch: Dict, d: DataConfig, device) -> Dict[str, torch.Tensor]:
    """A host batch (``collate``'s output) as the detector's tensors on
    ``device``: the image stage decodes, resizes, normalises and pads the
    JPEGs there and folds the resize into ``lidar2img``; every other array
    is copied as it is. ``token`` and ``pad_count`` stay on the host side
    and are not returned."""
    images, lidar2img, img2lidar = process_images(batch["jpeg"], batch["lidar2img"], batch["img_flip"], d, device)
    skip = ("jpeg", "img_flip", "token", "pad_count", "lidar2img")
    out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items() if k not in skip}
    out["images"] = images
    out["lidar2img"] = torch.from_numpy(lidar2img).to(device)
    out["img2lidar"] = torch.from_numpy(img2lidar).to(device)
    return out

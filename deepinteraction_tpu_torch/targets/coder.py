"""TransFusion box codec (port of ``deepinteraction_tpu/targets/coder.py``).
Boxes are (x, y, z_bottom, dx, dy, dz, yaw, vx, vy); the heads predict the
center in BEV grid units, gravity-center z, log dims and (sin, cos) yaw."""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from ..configs import BBoxCoderConfig
from ..utils.spans import span


class DecodedBoxes(NamedTuple):
    boxes: torch.Tensor  # [..., P, 9]
    scores: torch.Tensor  # [..., P]
    labels: torch.Tensor  # [..., P] int32
    in_range: torch.Tensor  # [..., P] bool


class TransFusionBBoxCoder:
    def __init__(self, cfg: BBoxCoderConfig):
        self.cfg = cfg

    def encode(self, boxes: torch.Tensor) -> torch.Tensor:
        """[..., G, >=7] real-world boxes -> [..., G, code_size] targets."""
        c = self.cfg
        sx = c.out_size_factor * c.voxel_size[0]
        sy = c.out_size_factor * c.voxel_size[1]
        t = [
            (boxes[..., 0] - c.pc_range[0]) / sx,
            (boxes[..., 1] - c.pc_range[1]) / sy,
            boxes[..., 2] + boxes[..., 5] * 0.5,  # bottom -> gravity z
            torch.log(torch.clamp(boxes[..., 3], min=1e-9)),
            torch.log(torch.clamp(boxes[..., 4], min=1e-9)),
            torch.log(torch.clamp(boxes[..., 5], min=1e-9)),
            torch.sin(boxes[..., 6]),
            torch.cos(boxes[..., 6]),
        ]
        if c.code_size == 10:
            t += [boxes[..., 7], boxes[..., 8]]
        return torch.stack(t, -1)

    def decode(self, preds: Dict[str, torch.Tensor]) -> DecodedBoxes:
        """Channels-last head outputs: center [..., P, 2] (grid units),
        height [..., P, 1] (gravity z), dim [..., P, 3] (log), rot
        [..., P, 2] (sin, cos), vel [..., P, 2], heatmap [..., P, cls]."""
        c = self.cfg
        hm = preds["heatmap"]
        labels = torch.argmax(hm, -1).int()
        scores = hm.max(-1).values
        sx = c.out_size_factor * c.voxel_size[0]
        sy = c.out_size_factor * c.voxel_size[1]
        x = preds["center"][..., 0] * sx + c.pc_range[0]
        y = preds["center"][..., 1] * sy + c.pc_range[1]
        dims = torch.exp(preds["dim"])
        z = preds["height"][..., 0] - dims[..., 2] * 0.5
        yaw = torch.atan2(preds["rot"][..., 0], preds["rot"][..., 1])
        parts = [x, y, z, dims[..., 0], dims[..., 1], dims[..., 2], yaw]
        if preds.get("vel") is not None:
            parts += [preds["vel"][..., 0], preds["vel"][..., 1]]
        boxes = torch.stack(parts, -1)
        with span("di.sync.coder.center_range"):
            pcr = boxes.new_tensor(c.post_center_range)
        ctr = boxes[..., :3]
        in_range = (ctr >= pcr[:3]).all(-1) & (ctr <= pcr[3:]).all(-1)
        if c.score_threshold is not None:
            in_range = in_range & (scores > c.score_threshold)
        return DecodedBoxes(boxes, scores, labels, in_range)

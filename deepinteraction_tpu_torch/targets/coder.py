"""TransFusion box decoding (port of the decode half of
``deepinteraction_tpu/targets/coder.py``)."""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from deepinteraction_tpu.configs import BBoxCoderConfig


class DecodedBoxes(NamedTuple):
    boxes: torch.Tensor  # [..., P, 9]
    scores: torch.Tensor  # [..., P]
    labels: torch.Tensor  # [..., P] int32
    in_range: torch.Tensor  # [..., P] bool


class TransFusionBBoxCoder:
    def __init__(self, cfg: BBoxCoderConfig):
        self.cfg = cfg

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
        pcr = boxes.new_tensor(c.post_center_range)
        ctr = boxes[..., :3]
        in_range = (ctr >= pcr[:3]).all(-1) & (ctr <= pcr[3:]).all(-1)
        if c.score_threshold is not None:
            in_range = in_range & (scores > c.score_threshold)
        return DecodedBoxes(boxes, scores, labels, in_range)

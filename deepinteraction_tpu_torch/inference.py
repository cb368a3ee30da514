"""Predictions dict -> scored boxes (port of
``deepinteraction_tpu/inference.py::get_bboxes``). Fixed-size outputs plus
a keep mask. With ``nms_type`` set (``"circle"`` or ``"rotate"``), the
nuScenes per-class NMS tasks run as in the reference
(deepinteraction_decoder.py:575-619), through ``ops/nms.py::nms_keep``:
the suppression matrices of the whole batch are built on its device and
walked greedily on the host after one transfer."""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch
import torch.nn.functional as F

from .configs import BBoxCoderConfig, DecoderConfig
from .ops.nms import nms_keep
from .targets.coder import TransFusionBBoxCoder
from .utils.spans import span


class Detections(NamedTuple):
    boxes: torch.Tensor  # [B, P, 9]
    scores: torch.Tensor  # [B, P]
    labels: torch.Tensor  # [B, P] int32
    keep: torch.Tensor  # [B, P] bool


def get_bboxes(
    preds: Dict[str, torch.Tensor],
    dcfg: DecoderConfig,
    ccfg: BBoxCoderConfig,
    num_proposals: int,
) -> Detections:
    p = num_proposals
    with span("di.get_bboxes"):
        one_hot = F.one_hot(preds["query_labels"].long(), dcfg.num_classes).float()
        score = torch.sigmoid(preds["heatmap"][:, -p:]) * preds["query_heatmap_score"] * one_hot
        dec = TransFusionBBoxCoder(ccfg).decode(
            {k: preds[k][:, -p:] for k in ("center", "height", "dim", "rot", "vel")}
            | {"heatmap": score}
        )
        keep = dec.in_range
        if dcfg.nms_type is not None:
            keep = nms_keep(dec.boxes, dec.scores, dec.labels, keep, dcfg.nms_type, dcfg.pre_maxsize)
        return Detections(dec.boxes, dec.scores, dec.labels, keep)

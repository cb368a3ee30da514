"""Predictions dict -> scored boxes (port of
``deepinteraction_tpu/inference.py::get_bboxes``). Fixed-size outputs plus
a keep mask. NMS is not ported: ``fusion_base`` runs without it
(``nms_type=None``)."""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch
import torch.nn.functional as F

from deepinteraction_tpu.configs import BBoxCoderConfig, DecoderConfig

from .targets.coder import TransFusionBBoxCoder


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
    if dcfg.nms_type is not None:
        raise NotImplementedError(
            f"nms_type={dcfg.nms_type!r}: ops/nms.py is not ported yet (ROADMAP queue 1)"
        )
    p = num_proposals
    one_hot = F.one_hot(preds["query_labels"].long(), dcfg.num_classes).float()
    score = torch.sigmoid(preds["heatmap"][:, -p:]) * preds["query_heatmap_score"] * one_hot
    dec = TransFusionBBoxCoder(ccfg).decode(
        {k: preds[k][:, -p:] for k in ("center", "height", "dim", "rot", "vel")}
        | {"heatmap": score}
    )
    return Detections(dec.boxes, dec.scores, dec.labels, dec.in_range)

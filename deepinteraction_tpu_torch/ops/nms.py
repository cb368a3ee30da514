"""Greedy circle and rotated-BEV NMS (port of
``deepinteraction_tpu/ops/nms.py`` and of the per-class NMS tasks of
``deepinteraction_tpu/inference.py``), with the JAX package's keep masks.

The JAX package runs the greedy pass as a ``fori_loop`` of one step per
candidate inside its jitted graph. Here :func:`batched_keep` builds the
suppression matrices of every task of a whole batch on the batch's device
(:func:`circle_suppression`, or rotated BEV IoU above the threshold),
copies them to the host in one transfer and walks them there with
:func:`greedy_keep` in numpy, as the reference runs circle NMS on the
host: one host sync a batch instead of a launch per candidate.
:func:`nms_keep` runs the nuScenes tasks through it, and :func:`circle_nms`
and :func:`rotated_nms` are its one-task, one-sample calls.

Candidates are visited in the order of ``torch.argsort(-scores,
stable=True)``: JAX's argsort is stable, so equal scores keep index order.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..utils.spans import span
from .rotated_iou import iou_bev

# nuScenes per-class NMS tasks (deepinteraction_decoder.py:575-580): a task
# with radius <= 0 keeps its valid boxes
NUSC_TASKS = (
    {"indices": tuple(range(8)), "radius": -1.0},
    {"indices": (8,), "radius": 0.175},
    {"indices": (9,), "radius": 0.175},
)


def score_order(scores: torch.Tensor) -> torch.Tensor:
    """Descending score order [..., N], ties in index order."""
    return torch.argsort(-scores, dim=-1, stable=True)


def circle_suppression(centers: torch.Tensor, radius: float) -> torch.Tensor:
    """[..., N, 2] score-sorted centres -> [..., N, N] bool, True where box i
    suppresses box j. Keeps the reference quirk (mmdet3d ``circle_nms``):
    the squared centre distance is compared against the radius itself, not
    its square."""
    d2 = ((centers[..., :, None, :] - centers[..., None, :, :]) ** 2).sum(-1)
    return d2 <= radius


def greedy_keep(suppress: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Greedy selection over score-sorted candidates on the host.

    suppress [..., N, N] bool (i suppresses j), valid [..., N] bool -> keep
    [..., N] bool: a valid candidate is kept unless a kept candidate before
    it suppresses it (``deepinteraction_tpu/ops/nms.py::_greedy_keep``)."""
    sup = suppress.reshape(-1, *suppress.shape[-2:])
    keep = np.zeros(sup.shape[:2], bool)
    for t, (s, v) in enumerate(zip(sup, valid.reshape(keep.shape))):
        removed = ~v
        for i in range(len(v)):
            if not removed[i]:
                keep[t, i] = True
                removed = removed | s[i]
    return keep.reshape(valid.shape)


def batched_keep(boxes: torch.Tensor, scores: torch.Tensor, task_valid: torch.Tensor,
                 thresholds: Sequence[float], nms_type: str, pre_max_size: int | None = None) -> torch.Tensor:
    """Greedy NMS of T tasks over a batch, with one host transfer.

    boxes [B, N, D] (centres first; D >= 7 for ``rotate``), scores [B, N],
    task_valid [T, B, N] bool, one threshold a task (``circle``: the radius;
    ``rotate``: the BEV IoU above which a box suppresses) -> keep [T, B, N]
    bool in input order. A sample's tasks share its score order. With
    ``rotate``, ``pre_max_size`` masks out every candidate past that rank;
    it does not truncate the arrays."""
    if nms_type not in ("circle", "rotate"):
        raise ValueError(f"nms_type must be None, 'circle' or 'rotate', got {nms_type!r}")
    n = boxes.shape[1]
    order = score_order(scores)  # [B, N]
    sorted_boxes = torch.gather(boxes, 1, order[..., None].expand_as(boxes))
    by_task = order.expand_as(task_valid)
    valid = torch.gather(task_valid, 2, by_task)
    if nms_type == "circle":
        sup = torch.stack([circle_suppression(sorted_boxes[..., :2], r) for r in thresholds])
    else:
        iou = iou_bev(sorted_boxes, sorted_boxes)  # [B, N, N], shared by the tasks
        sup = torch.stack([iou > t for t in thresholds])  # mmdet3d nms_gpu's overlap test
        if pre_max_size is not None:
            valid = valid & (torch.arange(n, device=boxes.device) < pre_max_size)
    with span("di.sync.nms.suppression"):
        host = torch.cat([sup.flatten(), valid.flatten()]).cpu().numpy()  # the batch's one transfer
    keep_sorted = greedy_keep(host[: sup.numel()].reshape(sup.shape), host[sup.numel():].reshape(valid.shape))
    out = torch.zeros_like(task_valid)
    with span("di.sync.nms.keep"):
        keep = torch.from_numpy(keep_sorted).to(boxes.device)
    return out.scatter(2, by_task, keep)


def nms_keep(boxes: torch.Tensor, scores: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor,
             nms_type: str, pre_max_size: int, tasks=NUSC_TASKS) -> torch.Tensor:
    """The keep mask [B, P] of the per-class NMS tasks over boxes [B, P, 9]:
    a task with radius <= 0 keeps its valid boxes, every other task runs
    circle or rotated NMS over its own classes (``inference.py:62-83`` of
    the JAX package)."""
    masks = []
    for t in tasks:
        with span("di.sync.nms.task_classes"):
            classes = labels.new_tensor(t["indices"])
        masks.append(torch.isin(labels, classes) & valid)
    keep = torch.zeros_like(valid)
    for t, m in zip(tasks, masks):
        if t["radius"] <= 0:
            keep = keep | m
    nms = [(t["radius"], m) for t, m in zip(tasks, masks) if t["radius"] > 0]
    if nms:
        radii, task_valid = zip(*nms)
        keep = keep | batched_keep(boxes, scores, torch.stack(task_valid), radii, nms_type, pre_max_size).any(0)
    return keep


def circle_nms(centers: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor, radius: float) -> torch.Tensor:
    """CenterPoint circle NMS. centers [N, 2], scores [N], valid [N] bool ->
    [N] bool keep mask in input order."""
    return batched_keep(centers[None], scores[None], valid[None, None], (radius,), "circle")[0, 0]


def rotated_nms(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor, iou_threshold: float,
                pre_max_size: int | None = None) -> torch.Tensor:
    """Rotated-BEV-IoU greedy NMS. boxes [N, 7+], scores [N], valid [N] ->
    [N] bool keep mask in input order."""
    return batched_keep(boxes[None], scores[None], valid[None, None], (iou_threshold,), "rotate",
                        pre_max_size)[0, 0]

"""Target assignment and the head's total loss (port of
``deepinteraction_tpu/targets/assign.py``: ``build_targets`` and
``detection_loss``; the reference's ``get_targets`` / ``loss`` and
``HungarianAssigner3D``).

One [B, L, P, G] cost tensor on the device (focal class cost, normalised
BEV L1, rotated 3D IoU), one host round trip for the Hungarian matching,
then the targets and losses on the device. GT boxes arrive padded to G with
a mask. In LiDAR-only mode (``num_mmpi=0``) there is one output layer and no
on-image mask.

Under a process group (``parallel/mesh.py``) every loss normaliser is summed
over the ranks before it divides, as JAX's data-parallel program sums it
over the global batch: ``matched_ious``' match count (one all-reduce in
:func:`build_targets`), the heatmap's positives and each layer's ``npos``
(one in :func:`detection_loss`). A rank's loss terms are
then its local sums over the global normalisers, whose sum over the ranks
is the global loss.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from ..configs import AssignerConfig, BBoxCoderConfig, DecoderConfig
from ..ops.gaussian import draw_heatmap, gaussian_radius
from ..ops.hungarian import hungarian_assign
from ..ops.rotated_iou import iou_3d
from ..parallel.mesh import all_reduce
from .coder import TransFusionBBoxCoder
from .losses import clip_sigmoid, gaussian_focal_loss, sigmoid_focal_loss, weighted_l1_loss

BIG = 1e8


class Targets(NamedTuple):
    labels: torch.Tensor  # [B, L*P] int
    label_weights: torch.Tensor  # [B, L*P]
    bbox_targets: torch.Tensor  # [B, L*P, code_size]
    bbox_weights: torch.Tensor  # [B, L*P, code_size]
    ious: torch.Tensor  # [B, L*P]
    heatmap: torch.Tensor  # [B, ncls, Hb, Wb]
    mean_iou: torch.Tensor  # []
    assign: torch.Tensor  # [B, L, P] matched GT index or -1


def _focal_cls_cost(scores, labels, gmask, alpha, gamma, weight):
    """mmdet FocalLossCost. scores [P, C] sigmoid; labels [G] -> [P, G]."""
    eps = 1e-12
    neg = -torch.log(1.0 - scores + eps) * (1.0 - alpha) * scores**gamma
    pos = -torch.log(scores + eps) * alpha * (1.0 - scores) ** gamma
    cost = (pos - neg)[:, labels.long()]
    return torch.where(gmask[None, :], cost * weight, cost.new_full((), BIG))


@torch.no_grad()
def build_targets(
    preds: Dict[str, torch.Tensor],
    gt_boxes: torch.Tensor,  # [B, G, 9]
    gt_labels: torch.Tensor,  # [B, G]
    gt_mask: torch.Tensor,  # [B, G]
    dcfg: DecoderConfig,
    ccfg: BBoxCoderConfig,
    acfg: AssignerConfig,
    bev_shape: Tuple[int, int],
) -> Targets:
    if acfg.lap_impl != "callback":
        raise ValueError(f"model.assigner.lap_impl={acfg.lap_impl!r}: the port matches with scipy on the host "
                         "('callback'); the JAX package's on-device auction LAP is not ported")
    coder = TransFusionBBoxCoder(ccfg)
    nl = max(dcfg.num_mmpi, 1)
    p = preds["center"].shape[1] // nl
    b, g = gt_boxes.shape[:2]
    ncls = dcfg.num_classes
    dev = gt_boxes.device

    def layer(t):
        return t.detach().reshape(b, nl, p, t.shape[-1])

    heads = ("center", "height", "dim", "rot", "vel", "heatmap")
    boxes = coder.decode({k: layer(preds[k]) for k in heads}).boxes  # [B, L, P, 9]
    scores = torch.sigmoid(layer(preds["heatmap"]))

    pcr = ccfg.pc_range
    origin = gt_boxes.new_tensor([pcr[0], pcr[1]])
    # BBoxBEVL1Cost: centers normalised by the extent of the BEV grid
    extent = gt_boxes.new_tensor([
        bev_shape[1] * ccfg.voxel_size[0] * ccfg.out_size_factor,
        bev_shape[0] * ccfg.voxel_size[1] * ccfg.out_size_factor,
    ])
    cost = torch.empty(b, nl, p, g, device=dev)
    iou = torch.empty(b, nl, p, g, device=dev, dtype=boxes.dtype)
    for i in range(b):
        ng = (gt_boxes[i, :, :2] - origin) / extent
        for li in range(nl):
            nb = (boxes[i, li, :, :2] - origin) / extent
            reg = (nb[:, None] - ng[None]).abs().sum(-1) * acfg.reg_cost_weight
            iou[i, li] = iou_3d(boxes[i, li, :, :7], gt_boxes[i, :, :7])
            cls_c = _focal_cls_cost(scores[i, li], gt_labels[i], gt_mask[i], acfg.cls_cost_alpha,
                                    acfg.cls_cost_gamma, acfg.cls_cost_weight)
            c = cls_c + reg - iou[i, li] * acfg.iou_cost_weight
            cost[i, li] = torch.where(gt_mask[i][None, :], c, c.new_full((), BIG))

    num_gt = gt_mask.int().sum(-1)  # [B]
    assign = hungarian_assign(cost, num_gt[:, None].expand(b, nl))  # [B, L, P]
    matched = assign >= 0
    safe = assign.clamp(min=0).long()

    enc = coder.encode(gt_boxes)  # [B, G, code]
    code = enc.shape[-1]
    flat = safe.reshape(b, nl * p)
    bbox_t = torch.gather(enc, 1, flat[..., None].expand(b, nl * p, code)).reshape(b, nl, p, code)
    bbox_t = torch.where(matched[..., None], bbox_t, bbox_t.new_zeros(()))
    bbox_w = matched[..., None].float().expand(b, nl, p, code)
    labels_t = torch.gather(gt_labels.long(), 1, flat).reshape(b, nl, p)
    labels_t = torch.where(matched, labels_t, torch.full_like(labels_t, ncls))
    label_w = torch.ones(b, nl, p, device=dev)  # pos_weight <= 0: all ones
    iou_t = torch.gather(iou, -1, safe[..., None])[..., 0]
    iou_t = torch.clamp(torch.where(matched, iou_t, iou_t.new_zeros(())), 0.0, 1.0)

    hb, wb = bev_shape
    sx = ccfg.voxel_size[0] * ccfg.out_size_factor
    sy = ccfg.voxel_size[1] * ccfg.out_size_factor
    heatmaps = []
    for i in range(b):
        gtb = gt_boxes[i]
        w = gtb[:, 3] / sx
        ln = gtb[:, 4] / sy
        ok = gt_mask[i] & (w > 0) & (ln > 0)
        radius = gaussian_radius((ln, w), dcfg.gaussian_overlap)
        radius = torch.clamp(radius.int(), min=dcfg.min_radius)
        centers = torch.stack([(gtb[:, 0] - pcr[0]) / sx, (gtb[:, 1] - pcr[1]) / sy], -1)
        heatmaps.append(draw_heatmap(centers, radius, gt_labels[i], ok, num_classes=ncls,
                                     height=hb, width=wb))

    # the global match count: this rank's term is its share of the global mean
    npos = all_reduce(matched.sum().to(iou_t.dtype))
    return Targets(
        labels=labels_t.reshape(b, nl * p),
        label_weights=label_w.reshape(b, nl * p),
        bbox_targets=bbox_t.reshape(b, nl * p, code),
        bbox_weights=bbox_w.reshape(b, nl * p, code),
        ious=iou_t.reshape(b, nl * p),
        heatmap=torch.stack(heatmaps),
        mean_iou=iou_t.sum() / torch.clamp(npos, min=1),
        assign=assign,
    )


def detection_loss(
    preds: Dict[str, torch.Tensor],
    gt_boxes: torch.Tensor,
    gt_labels: torch.Tensor,
    gt_mask: torch.Tensor,
    dcfg: DecoderConfig,
    ccfg: BBoxCoderConfig,
    acfg: AssignerConfig,
    bev_shape: Tuple[int, int],
    targets: Targets | None = None,
) -> Dict[str, torch.Tensor]:
    """The head's loss terms and ``loss_total`` (reference
    ``deepinteraction_decoder.py:484-547``); ``targets`` defaults to
    :func:`build_targets` of these predictions."""
    t = targets or build_targets(preds, gt_boxes, gt_labels, gt_mask, dcfg, ccfg, acfg, bev_shape)
    nl = max(dcfg.num_mmpi, 1)
    p = preds["center"].shape[1] // nl
    b = gt_boxes.shape[0]

    label_w = t.label_weights.reshape(b, nl, p)
    bbox_w = t.bbox_weights.reshape(b, nl, p, -1)
    om = preds["on_image_masks"].float()
    if om.shape[0] == nl:
        # ++: the cumulative mask weighs every layer
        masks = om.permute(1, 0, 2)
        label_w = label_w * masks
        bbox_w = bbox_w * masks[..., None]
    elif om.shape[0] > 0:
        # v1: even (image) layers only; off-image queries carry no loss
        label_w, bbox_w = label_w.clone(), bbox_w.clone()
        for li in range(0, nl, 2):
            label_w[:, li] *= om[li // 2]
            bbox_w[:, li] *= om[li // 2][..., None]

    losses: Dict[str, torch.Tensor] = {}
    hm_pred = clip_sigmoid(preds["dense_heatmap"])  # [B, Hb, Wb, ncls]
    hm_tgt = t.heatmap.permute(0, 2, 3, 1)
    # the normalisers: the heatmap's positives, then each layer's npos
    norms = torch.stack([(hm_tgt == 1.0).float().sum()] + [bbox_w[:, li].amax(-1).sum() for li in range(nl)]
                        ).to(hm_pred.dtype)
    norms = all_reduce(norms)
    losses["loss_heatmap"] = dcfg.loss_heatmap_weight * gaussian_focal_loss(hm_pred, hm_tgt, norms[0])

    labels = t.labels.reshape(b, nl, p)
    bbox_t = t.bbox_targets.reshape(b, nl, p, -1)
    code_w = bbox_t.new_tensor(dcfg.code_weights)
    heat = preds["heatmap"].reshape(b, nl, p, -1)
    reg_parts = torch.cat(
        [preds["center"], preds["height"], preds["dim"], preds["rot"], preds["vel"]], -1
    ).reshape(b, nl, p, -1)
    total = 0.0
    for li in range(nl):
        npos = norms[1 + li]
        lcls = dcfg.loss_cls_weight * sigmoid_focal_loss(
            heat[:, li], labels[:, li], label_w[:, li], npos, dcfg.loss_cls_gamma, dcfg.loss_cls_alpha
        )
        lbox = dcfg.loss_bbox_weight * weighted_l1_loss(
            reg_parts[:, li], bbox_t[:, li], bbox_w[:, li] * code_w, npos
        )
        losses[f"layer_{li}_loss_cls"] = lcls
        losses[f"layer_{li}_loss_bbox"] = lbox
        total = total + lcls + lbox
    losses["matched_ious"] = t.mean_iou
    losses["loss_total"] = total + losses["loss_heatmap"]
    return losses

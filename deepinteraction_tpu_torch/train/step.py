"""One train step (the port's counterpart of ``deepinteraction_tpu/train/
step.py::make_train_step``).

- AdamW with the reference's cyclic learning rate and cyclic beta1
  (``schedules.cyclic_cosine``), both set on the param group before each
  update from the count of updates made so far. ``torch.optim.AdamW``
  corrects its bias with the group's current beta1, as optax's ``adamw``
  under ``inject_hyperparams`` does.
- Global-norm gradient clip at ``cfg.optim.grad_clip_norm`` with optax's
  rule: ``g * max_norm / norm`` where ``norm >= max_norm``.
- ``freeze_img`` / ``freeze_pts`` freeze the JAX package's module sets by
  ``requires_grad_(False)``: no gradient is computed for them, and the grad
  norm and clip cover the trainable parameters only. Frozen BatchNorms
  normalise with batch statistics in train mode, but their running
  statistics are restored after the forward, as the JAX step keeps them.
  The same prefixes serve DeepInteraction++ (``fusion_plusplus``): there
  ``FROZEN_IMG`` holds Swin-T and the FPN, and ``FROZEN_PTS`` the neck's
  ``shared_conv_pts``; what trains is the rest of ``FusionTransformerPP``
  and the V2 decoder outside the warm-started head parts.
- The Hungarian matching costs one host round trip per step (``ops/
  hungarian.py``), as in the reference.
- Under a process group (``parallel/mesh.py``) each rank runs its local
  batch; the BN statistics and the loss normalisers are the global batch's
  (``models/layers.py``, ``targets/assign.py``), and between the backward
  and the update one all-reduce sums the trainable parameters' gradients
  and the metrics over the ranks, in one flat buffer in parameter order.
  ``grad_norm`` and the clip are then the global gradient's, and every
  rank applies the same update. So N ranks at batch B take the step that
  one process takes at batch N x B.

The step runs on the card unless the caller asks for the CPU
(``device="cpu"``); without a card, ``device="cuda"`` raises.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from ..configs import Config
from ..parallel.mesh import all_reduce, is_distributed
from ..targets.assign import Targets, build_targets, detection_loss
from .schedules import cyclic_cosine

FROZEN_IMG = ("img_backbone", "img_neck")
# the reference's freeze_pts set (deepinteraction.py:71-97): the LiDAR trunk
# plus the warm-started head parts and the fusion neck's shared LiDAR conv
FROZEN_PTS = (
    "pts_middle_encoder",
    "pts_backbone",
    "pts_neck",
    "pts_bbox_head.decoder0",
    "pts_bbox_head.class_encoding",
    "pts_bbox_head.pred0",
    "pts_bbox_head.heatmap_head_0",
    "pts_bbox_head.heatmap_head_1",
    "imgpts_neck.shared_conv_pts",
)


def frozen_prefixes(cfg: Config) -> Tuple[str, ...]:
    """Module-name prefixes frozen by the config's freeze flags."""
    return (FROZEN_IMG if cfg.model.freeze_img else ()) + (FROZEN_PTS if cfg.model.freeze_pts else ())


def is_frozen(name: str, frozen: Tuple[str, ...]) -> bool:
    return any(name == f or name.startswith(f + ".") for f in frozen)


def bev_shape(cfg: Config) -> Tuple[int, int]:
    nx, ny, _ = cfg.model.pts_voxel_layer.grid_size
    osf = cfg.model.bbox_coder.out_size_factor
    return (ny // osf, nx // osf)


class TrainStep:
    """``step(batch, generator) -> metrics``: forward in train mode, the
    detection loss, backward, clip, AdamW update. ``batch`` holds the
    detector inputs plus ``gt_boxes`` [B, G, 9], ``gt_labels`` [B, G] and
    ``gt_mask`` [B, G]; ``generator`` draws the dropout masks and lives on
    the step's device. ``metrics`` holds the loss terms and ``grad_norm``
    (before the clip) as device tensors. :meth:`backward` and :meth:`update`
    are the two halves of a step."""

    def __init__(self, cfg: Config, model: nn.Module, total_steps: int, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("TrainStep: no CUDA device; pass device='cpu' to train on the CPU")
        self.cfg = cfg
        self.model = model.to(self.device)
        self.frozen = frozen_prefixes(cfg)
        for name, p in model.named_parameters():
            if is_frozen(name, self.frozen):
                p.requires_grad_(False)
        self.params = [p for p in model.parameters() if p.requires_grad]
        # the frozen BN statistics; non-persistent buffers (Swin's relative
        # position index) are constants of the module and are not touched
        persistent = model.state_dict(keep_vars=True)
        self.frozen_buffers = [b for n, b in model.named_buffers() if n in persistent and is_frozen(n, self.frozen)]
        o = cfg.optim
        self.lr = cyclic_cosine(o.lr, *o.lr_target_ratio, o.lr_step_ratio_up, total_steps)
        self.b1 = cyclic_cosine(
            o.momentum_base, *o.momentum_target_ratio, o.momentum_step_ratio_up, total_steps
        )
        self.opt = torch.optim.AdamW(self.params, lr=self.lr(0), betas=(self.b1(0), 0.999),
                                     eps=1e-8, weight_decay=o.weight_decay)
        self.step_count = 0

    def backward(self, batch: Dict[str, torch.Tensor], generator: torch.Generator | None = None,
                 targets: Targets | None = None) -> Tuple[Dict[str, torch.Tensor], Targets]:
        """Forward, loss and backward: leaves the raw gradients in ``.grad``
        and returns (metrics, the assignment's targets). ``targets`` reuses
        an earlier assignment instead of matching anew (to compare two
        backward passes on one matching)."""
        cfg = self.cfg
        batch = {k: v.to(self.device) for k, v in batch.items()}
        self.opt.zero_grad(set_to_none=True)
        saved = [b.clone() for b in self.frozen_buffers]
        preds = self.model(batch, train=True, generator=generator)
        with torch.no_grad():
            for b, s in zip(self.frozen_buffers, saved):
                b.copy_(s)
        m = cfg.model
        if targets is None:
            targets = build_targets(preds, batch["gt_boxes"], batch["gt_labels"], batch["gt_mask"],
                                    m.pts_bbox_head, m.bbox_coder, m.assigner, bev_shape(cfg))
        losses = detection_loss(preds, batch["gt_boxes"], batch["gt_labels"], batch["gt_mask"],
                                m.pts_bbox_head, m.bbox_coder, m.assigner, bev_shape(cfg), targets)
        losses["loss_total"].backward()
        metrics = {k: v.detach() for k, v in losses.items()}
        if is_distributed():
            metrics = self._all_reduce(metrics)
        sq = [p.grad.pow(2).sum() for p in self.params if p.grad is not None]
        metrics["grad_norm"] = torch.sqrt(torch.stack(sq).sum()) if sq else torch.zeros((), device=self.device)
        return metrics, targets

    @torch.no_grad()
    def _all_reduce(self, metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Sum the trainable gradients (into ``.grad``) and ``metrics`` over
        the ranks in one collective; returns the summed metrics."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        flat = all_reduce(torch.cat([g.reshape(-1) for g in grads] + [torch.stack(list(metrics.values()))]))
        off = 0
        for p in self.params:
            p.grad = flat[off:off + p.numel()].view_as(p)
            off += p.numel()
        return dict(zip(metrics, flat[off:]))

    @torch.no_grad()
    def update(self, grad_norm: torch.Tensor) -> None:
        """Clip the gradients by their global norm, then one AdamW update at
        this step's learning rate and beta1."""
        max_norm = self.cfg.optim.grad_clip_norm
        scale = torch.where(grad_norm < max_norm, torch.ones_like(grad_norm), max_norm / grad_norm)
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            p.grad.mul_(scale)
        group = self.opt.param_groups[0]
        group["lr"] = self.lr(self.step_count)
        group["betas"] = (self.b1(self.step_count), 0.999)
        self.opt.step()
        self.step_count += 1

    def __call__(self, batch: Dict[str, torch.Tensor], generator: torch.Generator | None = None
                 ) -> Dict[str, torch.Tensor]:
        metrics, _ = self.backward(batch, generator)
        self.update(metrics["grad_norm"])
        return metrics

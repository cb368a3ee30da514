"""DeepInteraction detector (port of ``deepinteraction_tpu/models/
detector.py``).

- ``fusion_base``, eval and train: dual voxelization, sparse middle
  encoder, SECOND + SECONDFPN, ResNet + FPN, the MMRI v1 encoder and the
  MMPI v1 decoder.
- DeepInteraction++ (``imgpts_neck.variant == "pp"``, ``fusion_plusplus``),
  eval and train: the same LiDAR branch, the image backbone the config
  names (Swin-T there) + FPN levels 0-1, ``FusionTransformerPP`` on those
  two levels and on all three SECONDFPN maps (each interaction layer
  recomputed in the backward under train), and the V2 MMPI decoder.
- LiDAR-only (``cfg.lidar_only``, TransFusion-L), eval and train: one
  voxelization, the sparse encoder, SECOND + SECONDFPN, ``shared_conv`` and
  the query decoder with one heatmap head and no MMPI block.

``forward(batch)`` is the eval call, under ``torch.no_grad()``.
``forward(batch, train=True, generator=g)`` keeps the autograd graph,
voxelizes the voxels and the I2P pillars at their train capacities
``max_voxels[0]``, normalises with batch statistics (updating the running
ones; the image backbone only when ``img_backbone.frozen_stages < 0``, as
in JAX) and draws the dropout masks from ``g``. Swin-T in ``fusion_plusplus``
has ``frozen_stages=-1``, so it runs in train mode (its DropPath at 0.2
drawn from ``g``) although ``freeze_img`` freezes its parameters: with no
parameter and no input that needs a gradient, autograd records nothing
through it.

Batch dict (tensors): points [B, N, 5], points_mask [B, N], images
[B, V, H, W, 3], lidar2img / img2lidar [B, V, 4, 4], lidar_aug /
lidar_aug_inv [B, 4, 4].
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ..configs import ModelConfig
from ..levers import EvalLevers
from ..ops.voxelize import hard_simple_vfe, voxelize_batched
from ..utils.spans import span
from .decoder import Decoder
from .fpn import FPN
from .fusion_transformer import FusionTransformerPP
from .layers import Conv2d
from .mmri_encoder import MMRIEncoder
from .resnet import ResNet
from .second import SECOND, SECONDFPN
from .sparse_encoder import SparseEncoder
from .swin import SwinTransformer


class DeepInteraction(nn.Module):
    """``levers``: the JAX package's ``DI_*`` settings
    (:class:`~deepinteraction_tpu_torch.levers.EvalLevers`); ``None``
    reads them from the environment once, here, as the JAX package reads
    its own, so with no ``DI_*`` variable set the model computes what the
    JAX package computes by default. The two Pallas kernels' bf16
    numerics (K1's and K2's bf16 variants) apply where the batch is on
    CUDA (``EvalLevers.bf16_kernels``), as JAX applies them on its TPU;
    ``DI_SPARSE_IMPL=s2d`` on every device (``EvalLevers.k1_numerics``)."""

    def __init__(self, cfg: ModelConfig, input_shape, num_proposals: int | None = None,
                 levers: EvalLevers | None = None):
        super().__init__()
        self.cfg = cfg
        self.input_shape = tuple(input_shape)
        self.num_proposals = num_proposals
        self.levers = lv = EvalLevers.from_env() if levers is None else levers
        neck_levers = dict(i2p_views=lv.i2p_views, i2p_sample=lv.i2p_sample, warp_views=lv.warp_views,
                           depth_fill_lite=lv.depth_fill_lite, i2p_dtype=lv.i2p_dtype)
        if not cfg.lidar_only:
            ib = cfg.img_backbone
            if ib.type == "resnet":
                self.img_backbone = ResNet(ib.depth, ib.out_indices)
            elif ib.type == "swin":
                self.img_backbone = SwinTransformer(ib.embed_dims, ib.depths, ib.num_heads, ib.window_size,
                                                    ib.out_indices, ib.drop_path_rate, ib.drop_rate,
                                                    ib.attn_drop_rate)
            else:
                raise ValueError(f"unknown image backbone {ib.type!r}")
            self.img_neck = FPN(
                [self.img_backbone.out_channels[i] for i in cfg.img_backbone.out_indices],
                cfg.img_neck.out_channels,
                cfg.img_neck.num_outs,
            )
        self.pts_middle_encoder = SparseEncoder(cfg.pts_middle_encoder, lv.banded_t, lv.banded_windows())
        nz, _, _ = self.pts_middle_encoder.out_shape()
        bev_c = cfg.pts_middle_encoder.output_channels * nz
        pb = cfg.pts_backbone
        self.pts_backbone = SECOND(bev_c, pb.out_channels, pb.layer_nums, pb.layer_strides)
        self.pts_neck = SECONDFPN(pb.out_channels, cfg.pts_neck.out_channels, cfg.pts_neck.upsample_strides)
        if cfg.lidar_only:
            c = cfg.pts_bbox_head.hidden_channel
            self.shared_conv = Conv2d(sum(cfg.pts_neck.out_channels), c, 3, 1, 1)
        elif cfg.imgpts_neck.variant == "pp":
            self.imgpts_neck = FusionTransformerPP(
                cfg.imgpts_neck,
                cfg.img_neck.out_channels,
                sum(cfg.pts_neck.out_channels),
                cfg.pts_neck.out_channels[0],
                cfg.pts_voxel_layer.point_cloud_range,
                self.input_shape,
                msda_joint_points=lv.msda_joint_points,
                msda_eval_points=lv.msda_eval_points,
                **neck_levers,
            )
        else:
            self.imgpts_neck = MMRIEncoder(
                cfg.imgpts_neck,
                cfg.img_neck.out_channels,
                sum(cfg.pts_neck.out_channels),
                cfg.pts_voxel_layer.point_cloud_range,
                self.input_shape,
                i2p_dedupe=lv.i2p_dedupe,
                **neck_levers,
            )
        self.pts_bbox_head = Decoder(cfg.pts_bbox_head, cfg.bbox_coder, self.input_shape)

    def forward(self, batch: Dict[str, torch.Tensor], train: bool = False,
                generator: torch.Generator | None = None) -> Dict[str, torch.Tensor]:
        fn = self._lidar_only if self.cfg.lidar_only else self._fusion
        cuda = batch["points"].is_cuda
        k1, k2 = self.levers.bf16_kernels(train, cuda)
        bf16 = "banded" if k1 else self.levers.k1_numerics(train, cuda), k2
        if train:
            return fn(batch, True, generator, bf16)
        with torch.no_grad():
            return fn(batch, False, None, bf16)

    def _lidar_bev(self, batch, train: bool, k1: str, dense_dtype=None):
        """Voxelize -> sparse encoder (K1's numerics ``k1``, ``EvalLevers.
        k1_numerics``) -> SECOND + SECONDFPN outputs (with ``dense_dtype``, SECOND and
        SECONDFPN run in it and the outputs come back in fp32)."""
        vl = self.cfg.pts_voxel_layer
        cap = vl.max_voxels[0] if train else vl.max_voxels[1]
        vo = voxelize_batched(
            batch["points"], batch["points_mask"], voxel_size=vl.voxel_size,
            point_cloud_range=vl.point_cloud_range, max_num_points=vl.max_num_points,
            max_voxels=cap,
        )
        vvalid = torch.arange(cap, device=vo.coords.device)[None] < vo.num_voxels[:, None]
        vfe = hard_simple_vfe(vo.voxels, vo.num_points)
        with span("di.sparse_encoder"):
            bev = self.pts_middle_encoder(vfe, vo.coords, vvalid, train, bf16=k1 == "banded", s2d=k1 == "s2d")
        if dense_dtype is not None:
            bev = bev.to(dense_dtype)
        with span("di.bev"):
            outs = self.pts_neck(self.pts_backbone(bev, train), train)
        return outs if dense_dtype is None else [f.float() for f in outs]

    def _lidar_only(self, batch, train: bool, generator, bf16):
        """JAX ``DeepInteraction._lidar_only``: ``shared_conv`` on the
        512-channel neck map, then the decoder on it. ``bf16``: (K1's
        numerics, K2's bf16)."""
        pts_conv = self.shared_conv(self._lidar_bev(batch, train, bf16[0])[0])
        with span("di.decoder"):
            return self.pts_bbox_head((pts_conv, pts_conv), None, batch, num_proposals=self.num_proposals,
                                      train=train, generator=generator)

    def _fusion(self, batch, train: bool, generator, bf16):
        """JAX ``DeepInteraction.__call__``: image branch, LiDAR BEV, I2P
        pillars, the MMRI encoder (v1, K2's bf16 variant with ``bf16[1]``)
        or ``FusionTransformerPP`` (++, no K2), then the MMPI decoder."""
        cfg = self.cfg
        b, v = batch["images"].shape[:2]
        pp = cfg.imgpts_neck.variant == "pp"

        # the JAX package's DI_DENSE_BF16 (eval): ResNet, FPN, SECOND and
        # SECONDFPN on bf16 activations (Conv2d casts its parameters to
        # them, BN normalises in fp32 and rounds back), their outputs back
        # in fp32; Swin-T stays fp32, as in JAX
        dense = torch.bfloat16 if (self.levers.dense_bf16 and not train) else None
        imgs = batch["images"].reshape(b * v, *batch["images"].shape[2:])
        train_img = train and cfg.img_backbone.frozen_stages < 0
        with span("di.img_branch"):
            if dense is not None and cfg.img_backbone.type == "resnet":
                imgs = imgs.to(dense)
            feats = self.img_backbone(imgs, train_img, generator)
            if dense is not None:
                feats = [f.to(dense) for f in feats]
            # ++ reads FPN levels 0-1, v1 level 0
            img_feats = [f.reshape(b, v, *f.shape[1:]) for f in self.img_neck(feats, num_levels=2 if pp else 1)]
            if dense is not None:
                img_feats = [f.float() for f in img_feats]

        neck_outs = self._lidar_bev(batch, train, bf16[0], dense)

        pl = cfg.pts_pillar_layer
        cap = pl.max_voxels[0] if train else pl.max_voxels[1]
        po = voxelize_batched(
            batch["points"], batch["points_mask"], voxel_size=pl.voxel_size,
            point_cloud_range=pl.point_cloud_range, max_num_points=pl.max_num_points,
            max_voxels=cap,
        )
        mmri_batch = dict(batch)
        mmri_batch.update(
            pillars=po.voxels,
            pillar_counts=po.num_points,
            pillar_coords=po.coords,
            pillar_valid=torch.arange(cap, device=imgs.device)[None] < po.num_voxels[:, None],
        )
        if pp:
            with span("di.ppneck"):
                new_img, (pts_conv, new_pts) = self.imgpts_neck(img_feats, neck_outs, mmri_batch, train, generator)
        else:
            with span("di.mmri"):
                new_img, (pts_conv, new_pts) = self.imgpts_neck(img_feats[0], neck_outs[0], mmri_batch, train,
                                                                bf16[1])
        with span("di.decoder"):
            return self.pts_bbox_head((pts_conv, new_pts), new_img, mmri_batch, num_proposals=self.num_proposals,
                                      train=train, generator=generator)

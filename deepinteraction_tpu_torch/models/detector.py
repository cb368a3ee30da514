"""DeepInteraction detector, ``fusion_base`` eval path (port of
``deepinteraction_tpu/models/detector.py``): dual voxelization, sparse
middle encoder, SECOND + SECONDFPN, ResNet + FPN, the MMRI v1 encoder and
the MMPI v1 decoder.

Batch dict (tensors): points [B, N, 5], points_mask [B, N], images
[B, V, H, W, 3], lidar2img / img2lidar [B, V, 4, 4], lidar_aug /
lidar_aug_inv [B, 4, 4].
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from deepinteraction_tpu.configs import ModelConfig

from ..ops.voxelize import hard_simple_vfe, voxelize_batched
from .decoder import Decoder
from .fpn import FPN
from .mmri_encoder import MMRIEncoder
from .resnet import ResNet
from .second import SECOND, SECONDFPN
from .sparse_encoder import SparseEncoder


class DeepInteraction(nn.Module):
    def __init__(self, cfg: ModelConfig, input_shape, num_proposals: int | None = None):
        super().__init__()
        if cfg.lidar_only:
            raise NotImplementedError("LiDAR-only mode is not ported yet (ROADMAP queue 1)")
        if cfg.imgpts_neck.variant == "pp" or cfg.img_backbone.type != "resnet":
            raise NotImplementedError(
                "the DeepInteraction++ path (Swin, FusionTransformerPP) is not "
                "ported yet (ROADMAP queue 1)"
            )
        self.cfg = cfg
        self.input_shape = tuple(input_shape)
        self.num_proposals = num_proposals
        self.img_backbone = ResNet(cfg.img_backbone.depth, cfg.img_backbone.out_indices)
        self.img_neck = FPN(
            [self.img_backbone.out_channels[i] for i in cfg.img_backbone.out_indices],
            cfg.img_neck.out_channels,
            cfg.img_neck.num_outs,
        )
        self.pts_middle_encoder = SparseEncoder(cfg.pts_middle_encoder)
        nz, _, _ = self.pts_middle_encoder.out_shape()
        bev_c = cfg.pts_middle_encoder.output_channels * nz
        pb = cfg.pts_backbone
        self.pts_backbone = SECOND(bev_c, pb.out_channels, pb.layer_nums, pb.layer_strides)
        self.pts_neck = SECONDFPN(pb.out_channels, cfg.pts_neck.out_channels, cfg.pts_neck.upsample_strides)
        self.imgpts_neck = MMRIEncoder(
            cfg.imgpts_neck,
            cfg.img_neck.out_channels,
            sum(cfg.pts_neck.out_channels),
            cfg.pts_voxel_layer.point_cloud_range,
            self.input_shape,
        )
        self.pts_bbox_head = Decoder(cfg.pts_bbox_head, cfg.bbox_coder, self.input_shape)

    @torch.no_grad()
    def forward(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        b, v = batch["images"].shape[:2]

        imgs = batch["images"].reshape(b * v, *batch["images"].shape[2:])
        fpn0 = self.img_neck(self.img_backbone(imgs), num_levels=1)[0]
        img_feats = fpn0.reshape(b, v, *fpn0.shape[1:])

        vl = cfg.pts_voxel_layer
        vo = voxelize_batched(
            batch["points"], batch["points_mask"], voxel_size=vl.voxel_size,
            point_cloud_range=vl.point_cloud_range, max_num_points=vl.max_num_points,
            max_voxels=vl.max_voxels[1],
        )
        vvalid = torch.arange(vl.max_voxels[1], device=imgs.device)[None] < vo.num_voxels[:, None]
        bev = self.pts_middle_encoder(hard_simple_vfe(vo.voxels, vo.num_points), vo.coords, vvalid)
        pts_feats = self.pts_neck(self.pts_backbone(bev))[0]

        pl = cfg.pts_pillar_layer
        po = voxelize_batched(
            batch["points"], batch["points_mask"], voxel_size=pl.voxel_size,
            point_cloud_range=pl.point_cloud_range, max_num_points=pl.max_num_points,
            max_voxels=pl.max_voxels[1],
        )
        mmri_batch = dict(batch)
        mmri_batch.update(
            pillars=po.voxels,
            pillar_counts=po.num_points,
            pillar_coords=po.coords,
            pillar_valid=torch.arange(pl.max_voxels[1], device=imgs.device)[None] < po.num_voxels[:, None],
        )
        new_img, (pts_conv, new_pts) = self.imgpts_neck(img_feats, pts_feats, mmri_batch)
        return self.pts_bbox_head((pts_conv, new_pts), new_img, mmri_batch, num_proposals=self.num_proposals)

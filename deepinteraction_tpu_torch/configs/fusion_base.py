"""Experiment configs (the port's own copy of the config functions of
``deepinteraction_tpu/configs/fusion_base.py`` that the port runs).

``fusion_base_config`` is the field-for-field translation of the
reference's DeepInteraction-base experiment
(``projects/configs/nuscenes/Fusion_0075_refactor.py``); ``tiny_config`` the
same topology at tiny capacities for tests; ``lidar_only_config`` and
``tiny_lidar_config`` the cameras-disabled TransFusion-L detector;
``tiny_pp_config`` the DeepInteraction++ topology at tiny capacities (the
full-size one is ``fusion_plusplus.py``).
"""

from __future__ import annotations

import dataclasses

from .base import (
    BBoxCoderConfig,
    Config,
    DataConfig,
    DecoderConfig,
    FPNConfig,
    ImageBackboneConfig,
    MMRIEncoderConfig,
    ModelConfig,
    OptimConfig,
    SECONDConfig,
    SECONDFPNConfig,
    SparseEncoderConfig,
    VoxelizationConfig,
    AssignerConfig,
)

PC_RANGE = (-54.0, -54.0, -5.0, 54.0, 54.0, 3.0)
VOXEL_SIZE = (0.075, 0.075, 0.2)
OUT_SIZE_FACTOR = 8
PILLAR_SIZE = (
    VOXEL_SIZE[0] * OUT_SIZE_FACTOR,
    VOXEL_SIZE[1] * OUT_SIZE_FACTOR,
    PC_RANGE[5] - PC_RANGE[2],
)


def fusion_base_config() -> Config:
    """DeepInteraction-base on nuScenes (reference: Fusion_0075_refactor.py)."""
    model = ModelConfig(
        freeze_img=True,
        freeze_pts=True,
        img_backbone=ImageBackboneConfig(type="resnet", depth=50, frozen_stages=1),
        img_neck=FPNConfig(in_channels=(256, 512, 1024, 2048), out_channels=256, num_outs=5),
        pts_voxel_layer=VoxelizationConfig(
            voxel_size=VOXEL_SIZE,
            point_cloud_range=PC_RANGE,
            max_num_points=10,
            max_voxels=(120000, 160000),
        ),
        pts_pillar_layer=VoxelizationConfig(
            voxel_size=PILLAR_SIZE,
            point_cloud_range=PC_RANGE,
            max_num_points=20,
            # reference eval cap is 60000 (Fusion_0075_refactor.py:155) but
            # the 0.6 m pillar grid only HAS 180*180 = 32400 cells — the
            # static capacity is clamped to the true maximum, cutting the
            # I2P attention's padded workload by half at eval
            max_voxels=(30000, 32400),
        ),
        pts_middle_encoder=SparseEncoderConfig(
            in_channels=5,
            sparse_shape=(41, 1440, 1440),
            encoder_channels=((16, 16, 32), (32, 32, 64), (64, 64, 128), (128, 128)),
            output_channels=128,
            stage_capacities=(120000, 90000, 60000, 30000),
        ),
        pts_backbone=SECONDConfig(
            in_channels=256,
            out_channels=(128, 256),
            layer_nums=(5, 5),
            layer_strides=(1, 2),
        ),
        pts_neck=SECONDFPNConfig(
            in_channels=(128, 256), out_channels=(256, 256), upsample_strides=(1, 2)
        ),
        imgpts_neck=MMRIEncoderConfig(
            variant="v1",
            num_layers=2,
            in_channels_img=256,
            in_channels_pts=512,
            hidden_channel=128,
            bn_momentum=0.1,
            local_attn_kernel=9,
            i2p_max_keys=120,
        ),
        bbox_coder=BBoxCoderConfig(
            pc_range=PC_RANGE[:2],
            voxel_size=VOXEL_SIZE[:2],
            out_size_factor=OUT_SIZE_FACTOR,
            post_center_range=(-61.2, -61.2, -10.0, 61.2, 61.2, 10.0),
            score_threshold=0.0,
            code_size=10,
        ),
        assigner=AssignerConfig(),
        pts_bbox_head=DecoderConfig(
            variant="v1",
            num_views=6,
            out_size_factor_img=4,
            num_proposals=200,
            hidden_channel=128,
            num_classes=10,
            num_mmpi=4,
            num_heads=8,
            nms_kernel_size=3,
            ffn_channel=256,
            dropout=0.1,
        ),
    )
    return Config(model=model, data=DataConfig(), optim=OptimConfig(total_epochs=6))


def tiny_config() -> Config:
    """Tiny-capacity config with the same topology, for tests and dry-runs.

    BEV grid 16x16 (128x128 voxel grid / 8), images 64x32, 2 views, small
    channel widths, tiny static capacities — small enough to jit on a 1-core
    CPU host in seconds.
    """
    pc_range = (-8.0, -8.0, -5.0, 8.0, 8.0, 3.0)
    voxel_size = (0.125, 0.125, 0.2)  # grid 128 x 128 x 40 (z chain matches ref)
    osf = 8  # BEV 16 x 16
    pillar = (voxel_size[0] * osf, voxel_size[1] * osf, pc_range[5] - pc_range[2])
    model = ModelConfig(
        freeze_img=False,
        freeze_pts=False,
        img_backbone=ImageBackboneConfig(type="resnet", depth=18, frozen_stages=-1),
        img_neck=FPNConfig(in_channels=(64, 128, 256, 512), out_channels=64, num_outs=5),
        pts_voxel_layer=VoxelizationConfig(
            voxel_size=voxel_size,
            point_cloud_range=pc_range,
            max_num_points=5,
            max_voxels=(2000, 2000),
        ),
        pts_pillar_layer=VoxelizationConfig(
            voxel_size=pillar,
            point_cloud_range=pc_range,
            max_num_points=8,
            max_voxels=(256, 256),
        ),
        pts_middle_encoder=SparseEncoderConfig(
            in_channels=5,
            sparse_shape=(41, 128, 128),
            encoder_channels=((16, 16, 32), (32, 32, 64), (64, 64, 128), (128, 128)),
            output_channels=128,
            stage_capacities=(2000, 1500, 1000, 500),
        ),
        pts_backbone=SECONDConfig(
            in_channels=256, out_channels=(64, 128), layer_nums=(2, 2), layer_strides=(1, 2)
        ),
        pts_neck=SECONDFPNConfig(
            in_channels=(64, 128), out_channels=(128, 128), upsample_strides=(1, 2)
        ),
        imgpts_neck=MMRIEncoderConfig(
            variant="v1",
            num_layers=1,
            in_channels_img=64,
            in_channels_pts=256,
            hidden_channel=64,
            local_attn_kernel=5,
            i2p_max_keys=16,
        ),
        bbox_coder=BBoxCoderConfig(
            pc_range=pc_range[:2],
            voxel_size=voxel_size[:2],
            out_size_factor=osf,
            post_center_range=(-10.0, -10.0, -5.0, 10.0, 10.0, 5.0),
            score_threshold=0.0,
            code_size=10,
        ),
        pts_bbox_head=DecoderConfig(
            variant="v1",
            num_views=2,
            out_size_factor_img=4,
            num_proposals=8,
            hidden_channel=64,
            num_classes=10,
            num_mmpi=4,
            num_heads=4,
            nms_kernel_size=3,
            ffn_channel=64,
            dropout=0.0,
        ),
    )
    data = dataclasses.replace(
        DataConfig(),
        img_scale=(64, 32),
        num_views=2,
        max_points=4096,
        max_gt_boxes=8,
        samples_per_device=1,
    )
    return Config(model=model, data=data, optim=OptimConfig(total_epochs=1), test_num_proposals=8)


def lidar_only_config() -> Config:
    """Cameras-disabled LiDAR detector (TransFusion-L lineage): the model
    family the reference warm-starts its fusion fine-tune from
    (load_from='pretrained/r50_fpn_voxel_0075.pth', config L273) and
    BASELINE config #2."""
    cfg = fusion_base_config()
    model = dataclasses.replace(
        cfg.model,
        lidar_only=True,
        freeze_img=False,
        freeze_pts=False,
        pts_bbox_head=dataclasses.replace(
            cfg.model.pts_bbox_head, lidar_only=True, num_mmpi=0
        ),
    )
    return dataclasses.replace(
        cfg, model=model, optim=dataclasses.replace(cfg.optim, total_epochs=20)
    )


def tiny_lidar_config() -> Config:
    """Tiny LiDAR-only topology for tests."""
    cfg = tiny_config()
    model = dataclasses.replace(
        cfg.model,
        lidar_only=True,
        pts_bbox_head=dataclasses.replace(
            cfg.model.pts_bbox_head, lidar_only=True, num_mmpi=0
        ),
    )
    return dataclasses.replace(cfg, model=model)


def tiny_pp_config() -> Config:
    """Tiny DeepInteraction++ topology (FusionTransformer neck, polar I2P,
    V2 MMPI blocks) for tests and dry-runs."""
    cfg = tiny_config()
    model = dataclasses.replace(
        cfg.model,
        imgpts_neck=dataclasses.replace(
            cfg.model.imgpts_neck,
            variant="pp",
            num_layers=1,
            num_levels=2,
            num_heads=4,
            use_polar_i2p=True,
            polar_radius_range=(1.0, 9.0, 1.0),
            polar_num_z_bins=4,
        ),
        pts_bbox_head=dataclasses.replace(cfg.model.pts_bbox_head, variant="pp"),
    )
    return dataclasses.replace(cfg, model=model)

"""DeepInteraction++ experiment config (the port's own copy of
``deepinteraction_tpu/configs/fusion_plusplus.py``).

Translation of ``projects/configs/nuscenes/Fusion_0075_plusplus.py``: Swin-T
image backbone, FusionTransformer MMRI encoder (deformable attention + polar
I2P), V2 MMPI blocks with look-forward center update, 9 epochs.
"""

from __future__ import annotations

import dataclasses

from .base import Config, ImageBackboneConfig
from .fusion_base import fusion_base_config


def fusion_plusplus_config() -> Config:
    cfg = fusion_base_config()
    model = dataclasses.replace(
        cfg.model,
        img_backbone=ImageBackboneConfig(
            type="swin",
            embed_dims=96,
            depths=(2, 2, 6, 2),
            num_heads=(3, 6, 12, 24),
            window_size=7,
            out_indices=(0, 1, 2, 3),
            frozen_stages=-1,
            # reference Fusion_0075_plusplus.py:157-159
            drop_path_rate=0.2,
            drop_rate=0.0,
            attn_drop_rate=0.0,
        ),
        img_neck=dataclasses.replace(cfg.model.img_neck, in_channels=(96, 192, 384, 768)),
        imgpts_neck=dataclasses.replace(
            cfg.model.imgpts_neck,
            variant="pp",
            num_levels=2,
            use_polar_i2p=True,
        ),
        pts_bbox_head=dataclasses.replace(cfg.model.pts_bbox_head, variant="pp"),
    )
    return dataclasses.replace(
        cfg, model=model, optim=dataclasses.replace(cfg.optim, total_epochs=9)
    )

"""The port's configs: a copy of the JAX package's schema and of the config
functions the port runs, so that the port imports nothing of
``deepinteraction_tpu``."""

from .base import (
    AssignerConfig,
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
)
from .fusion_base import fusion_base_config, lidar_only_config, tiny_config, tiny_lidar_config, tiny_pp_config
from .fusion_plusplus import fusion_plusplus_config

__all__ = [
    "AssignerConfig",
    "BBoxCoderConfig",
    "Config",
    "DataConfig",
    "DecoderConfig",
    "FPNConfig",
    "ImageBackboneConfig",
    "MMRIEncoderConfig",
    "ModelConfig",
    "OptimConfig",
    "SECONDConfig",
    "SECONDFPNConfig",
    "SparseEncoderConfig",
    "VoxelizationConfig",
    "fusion_base_config",
    "fusion_plusplus_config",
    "lidar_only_config",
    "tiny_config",
    "tiny_lidar_config",
    "tiny_pp_config",
]

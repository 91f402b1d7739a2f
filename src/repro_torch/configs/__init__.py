"""Configurations of the port: `ArchConfig` and the ten architectures."""
from repro_torch.configs.base import (
    ArchConfig, MoEConfig, ShapeConfig, SHAPES, TrainConfig, reduced,
    supports_shape,
)
from repro_torch.configs.registry import ARCHS, get_arch

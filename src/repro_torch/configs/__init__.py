from .base import (
    ArchConfig, MoEConfig, MLAConfig, SSMConfig, RWKVConfig, EncDecConfig,
    ShapeConfig, SHAPES, get_config, list_configs, register, REGISTRY,
)

__all__ = [
    "ArchConfig", "MoEConfig", "MLAConfig", "SSMConfig", "RWKVConfig",
    "EncDecConfig", "ShapeConfig", "SHAPES", "get_config", "list_configs",
    "register", "REGISTRY",
]

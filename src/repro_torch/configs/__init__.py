"""Configurations (port of ``repro.configs``): ``FederationConfig``,
``ModelConfig`` with its MoE / SSM / RWKV parts, the input shapes, and
``get_config`` / ``reduced``."""
from repro_torch.configs.base import (
    ARCH_IDS,
    INPUT_SHAPES,
    AttentionConfig,
    FederationConfig,
    ModelConfig,
    MoEConfig,
    RWKVConfig,
    ShapeConfig,
    SSMConfig,
    applicable_shapes,
    get_config,
    long_context_capable,
    reduced,
)

__all__ = ["ARCH_IDS", "INPUT_SHAPES", "AttentionConfig", "FederationConfig",
           "ModelConfig", "MoEConfig", "RWKVConfig", "ShapeConfig",
           "SSMConfig", "applicable_shapes", "get_config",
           "long_context_capable", "reduced"]

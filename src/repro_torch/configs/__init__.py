"""Configurations (port of ``repro.configs``): ``FederationConfig``, the
dense and RWKV families' ``ModelConfig`` and ``get_config`` /
``reduced``."""
from repro_torch.configs.base import (
    ARCH_IDS,
    AttentionConfig,
    FederationConfig,
    ModelConfig,
    RWKVConfig,
    get_config,
    reduced,
)

__all__ = ["ARCH_IDS", "AttentionConfig", "FederationConfig", "ModelConfig",
           "RWKVConfig", "get_config", "reduced"]

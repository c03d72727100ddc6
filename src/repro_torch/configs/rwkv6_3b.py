"""RWKV6 'Finch' 3B — attention-free, data-dependent decay [arXiv:2404.05892]."""
from repro_torch.configs.base import AttentionConfig, ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    num_layers=32,
    d_model=2560,
    d_ff=8960,
    vocab_size=65536,
    attention=AttentionConfig(num_heads=40, num_kv_heads=40, head_dim=64),
    rwkv=RWKVConfig(head_dim=64, decay_lora=64),
    source="Finch: RWKV-6 [arXiv:2404.05892]",
)

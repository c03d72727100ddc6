"""Jamba-1.5-Large 398B — hybrid Mamba+attention 1:7 interleave, MoE 16e top-2
[arXiv:2403.19887]."""
from repro_torch.configs.base import AttentionConfig, ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    d_ff=24576,
    vocab_size=65536,
    attention=AttentionConfig(num_heads=64, num_kv_heads=8, head_dim=128, pattern="full"),
    moe=MoEConfig(num_experts=16, top_k=2),
    moe_every=2,      # MoE FFN every other layer
    attn_every=8,     # one attention layer per 8 (1:7 Mamba:attn)
    ssm=SSMConfig(state_dim=16, conv_width=4, expand=2),
    source="Jamba-1.5 [arXiv:2403.19887]",
)

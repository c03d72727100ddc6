"""Mixtral 8x22B — MoE 8 experts top-2, sliding-window attention
[arXiv:2401.04088]."""
from repro_torch.configs.base import AttentionConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    d_ff=16384,
    vocab_size=32768,
    attention=AttentionConfig(
        num_heads=48, num_kv_heads=8, head_dim=128, pattern="swa", window=4096
    ),
    moe=MoEConfig(num_experts=8, top_k=2),
    moe_every=1,
    source="Mixtral of Experts [arXiv:2401.04088]",
)

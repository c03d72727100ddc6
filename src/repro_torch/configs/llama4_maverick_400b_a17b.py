"""Llama-4 Maverick 400B (17B active) — MoE 128 experts top-1, interleaved
dense/MoE, chunked (block-local) attention, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E]."""
from repro_torch.configs.base import AttentionConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    d_ff=8192,
    vocab_size=202048,
    attention=AttentionConfig(
        num_heads=40, num_kv_heads=8, head_dim=128, pattern="chunked", window=8192
    ),
    moe=MoEConfig(num_experts=128, top_k=1),
    moe_every=2,  # MoE every other layer (dense/MoE interleave)
    source="hf:meta-llama/Llama-4-Scout-17B-16E (Maverick layout)",
)

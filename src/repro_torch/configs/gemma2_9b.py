"""Gemma-2 9B — local/global alternating attention, logit softcaps
[arXiv:2408.00118]."""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    num_layers=42,
    d_model=3584,
    d_ff=14336,
    vocab_size=256000,
    attention=AttentionConfig(
        num_heads=16,
        num_kv_heads=8,
        head_dim=256,
        pattern="local_global",
        window=4096,
        logit_softcap=50.0,
    ),
    tie_embeddings=True,
    final_softcap=30.0,
    source="Gemma 2 [arXiv:2408.00118]",
)

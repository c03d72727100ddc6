"""Granite-Code 34B — dense llama-arch, MQA (kv=1), non-gated MLP [arXiv:2405.04324]."""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    family="dense",
    num_layers=88,
    d_model=6144,
    d_ff=24576,
    vocab_size=49152,
    attention=AttentionConfig(num_heads=48, num_kv_heads=1, head_dim=128, pattern="full"),
    gated_mlp=False,
    source="Granite Code Models [arXiv:2405.04324]",
)

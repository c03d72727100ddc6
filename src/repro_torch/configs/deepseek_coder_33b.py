"""DeepSeek-Coder 33B — dense llama-arch GQA [arXiv:2401.14196]."""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    family="dense",
    num_layers=62,
    d_model=7168,
    d_ff=19200,
    vocab_size=32256,
    attention=AttentionConfig(num_heads=56, num_kv_heads=8, head_dim=128, pattern="full"),
    source="DeepSeek-Coder [arXiv:2401.14196]",
)

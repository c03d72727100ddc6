"""SeamlessM4T-medium — encoder-decoder, multimodal speech/text
[arXiv:2308.11596]. The mel-spectrogram + conv feature extractor frontend is
a stub: input_specs provides precomputed frame embeddings."""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    num_layers=12,            # decoder layers
    encoder_layers=12,
    d_model=1024,
    d_ff=4096,
    vocab_size=256206,
    attention=AttentionConfig(num_heads=16, num_kv_heads=16, head_dim=64, pattern="full"),
    num_audio_frames=1024,    # stubbed conformer frame embeddings
    gated_mlp=False,
    source="SeamlessM4T [arXiv:2308.11596]",
)

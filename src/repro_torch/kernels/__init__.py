"""The port's kernels, behind ``dispatch``, with their plain versions in
``ref``: the fused aggregation (``masked_agg``, a Triton kernel; the
submodule also holds the ``masked_agg`` wrapper), flash attention
(``flash_attention``, CUDA C++ in ``csrc/``, forward and backward) and the
WKV6 recurrence (``rwkv6_chunk``, CUDA C++ in ``csrc/``, forward); the
CUDA sources are built by ``build``."""
from repro_torch.kernels.dispatch import (
    FUSED_OPS,
    attention,
    fused_agg,
    resolve_backend,
    resolve_use_kernel,
    use_kernel_default,
    wkv6,
)
from repro_torch.kernels.masked_agg import fused_masked_agg
from repro_torch.kernels.ref import (
    OP_ALL,
    OP_KNOWN_P,
    OP_MEAN,
    flash_attention_ref,
    fused_masked_agg_ref,
    masked_agg_ref,
    rwkv6_chunk_plain,
    rwkv6_chunk_ref,
)

__all__ = [
    "FUSED_OPS",
    "OP_ALL",
    "OP_KNOWN_P",
    "OP_MEAN",
    "attention",
    "flash_attention_ref",
    "fused_agg",
    "fused_masked_agg",
    "fused_masked_agg_ref",
    "masked_agg_ref",
    "resolve_backend",
    "resolve_use_kernel",
    "rwkv6_chunk_plain",
    "rwkv6_chunk_ref",
    "use_kernel_default",
    "wkv6",
]

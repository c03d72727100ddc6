"""The port's kernels, behind ``dispatch``, with their plain versions in
``ref``: the fused aggregation (``masked_agg``, a Triton kernel; the
submodule also holds the ``masked_agg`` wrapper) and flash attention
(``flash_attention``, CUDA C++ in ``csrc/``, forward and backward)."""
from repro_torch.kernels.dispatch import (
    FUSED_OPS,
    attention,
    fused_agg,
    resolve_backend,
    resolve_use_kernel,
    use_kernel_default,
)
from repro_torch.kernels.masked_agg import fused_masked_agg
from repro_torch.kernels.ref import (
    OP_ALL,
    OP_KNOWN_P,
    OP_MEAN,
    flash_attention_ref,
    fused_masked_agg_ref,
    masked_agg_ref,
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
    "use_kernel_default",
]

"""The port's kernels: the fused aggregation (``masked_agg``, a Triton
kernel) behind ``dispatch``, with its plain version in ``ref``. The
submodule ``masked_agg`` also holds the ``masked_agg`` wrapper."""
from repro_torch.kernels.dispatch import (
    FUSED_OPS,
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
    fused_masked_agg_ref,
    masked_agg_ref,
)

__all__ = [
    "FUSED_OPS",
    "OP_ALL",
    "OP_KNOWN_P",
    "OP_MEAN",
    "fused_agg",
    "fused_masked_agg",
    "fused_masked_agg_ref",
    "masked_agg_ref",
    "resolve_backend",
    "resolve_use_kernel",
    "use_kernel_default",
]

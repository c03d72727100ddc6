"""FedPBC in PyTorch: the port of the JAX package ``repro`` to CUDA.

Module for module it mirrors ``repro`` (``repro_torch/core/federated.py``
is the counterpart of ``repro/core/federated.py``), imports ``torch`` and
numpy only, and runs on the card unless a caller passes ``device="cpu"``.
The server aggregation is a hand-written Triton kernel
(``repro_torch.kernels.masked_agg``) and the LM's attention a hand-written
CUDA kernel, forward and backward (``repro_torch.kernels.flash_attention``);
on CPU tensors their plain PyTorch versions (``repro_torch.kernels.ref``,
``repro_torch.models.attention``) run instead.
"""
__all__ = ["resolve_device"]


def __getattr__(name):
    # lazy, so that the gate's static half (repro_torch.analysis) imports
    # no torch
    if name == "resolve_device":
        from repro_torch.device import resolve_device
        return resolve_device
    raise AttributeError(name)

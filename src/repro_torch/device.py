"""Device resolution for the port's entry points.

Entry points take ``device=None``, which means the card. Without CUDA they
raise instead of carrying on on the CPU; a caller that wants the CPU (the
tests) passes ``device="cpu"``.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on the card by default and CUDA is not "
            "available here; pass device='cpu' to run on the CPU")
    return dev


def set_fp32_matmul_precision() -> None:
    """Full fp32 products on the card: TF32 would keep ~3 decimal digits and
    break agreement with the fp32 reference, so both switches are set
    explicitly rather than left to PyTorch's defaults."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


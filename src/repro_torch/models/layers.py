"""Basic model layers (port of ``repro.models.layers``): norms, rope, MLPs,
softcap, init helpers.

Weights carry any leading model axes (``w [*L, d_in, d_out]``) and
activations the same leading axes (``x [*L, ..., d_in]``): ``x @ w`` is then
one batched product over every client model at once. Where the reference
rounds to the working dtype, so does the port: the norm and rope compute in
fp32 and cast back to ``x.dtype``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6):
    """``x [*L, ..., d]``, ``weight [*L, d]`` (zero-init: the scale is
    ``1 + weight``)."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    w = weight.float()
    w = w.reshape(w.shape[:-1] + (1,) * (x.dim() - w.dim()) + w.shape[-1:])
    return ((1.0 + w) * out).to(x.dtype)


def init_dense(gen: torch.Generator, d_in: int, d_out: int, dtype,
               scale=None) -> torch.Tensor:
    scale = scale if scale is not None else d_in ** -0.5
    return (torch.randn(d_in, d_out, generator=gen, device=gen.device)
            * scale).to(dtype)


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """positions ``[...]`` int -> cos, sin ``[..., head_dim // 2]`` fp32."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=positions.device) / half))
    ang = positions[..., None].float() * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """Rotate-half rope: ``x [..., T, H, D]``; cos/sin ``[T, D/2]``
    broadcast over heads."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1).to(x.dtype)


def mlp_apply(p, x: torch.Tensor, gated: bool = True) -> torch.Tensor:
    """``p`` leaves ``[*L, d, f]`` / ``[*L, f, d]``; ``x [*L, N, d]``."""
    h = x @ p["up"]
    if gated:
        h = F.silu(x @ p["gate"]) * h
    else:
        h = F.gelu(h, approximate="tanh")   # jax.nn.gelu's default
    return h @ p["down"]


def softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return logits
    return cap * torch.tanh(logits / cap)

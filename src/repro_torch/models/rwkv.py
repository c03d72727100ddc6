"""RWKV6 ("Finch") block (port of ``repro.models.rwkv``): linear attention
with data-dependent per-channel decay [arXiv:2404.05892].

Recurrence per head (k-dim K, v-dim V):
    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    o_t = r_t @ (S_{t-1} + diag(u) k_t^T v_t)
with w_t = exp(-exp(decay(x_t))) in (0,1)^K, data-dependent via a LoRA.

The recurrence goes through ``repro_torch.kernels.dispatch.wkv6`` in the
kernel's ``[B, H, T, D]`` layout: one launch of the CUDA WKV6 chunk kernel
per call for CUDA tensors, the plain chunked version for CPU tensors or
``backend="torch"``. The reference's own chunked scan (``_wkv_chunk_scan``)
is that plain version here, not a second path. Leaves as the reference's
``rwkv_init``: one model, no leading axes; ``decay_base``, ``bonus_u`` and
``ln_x`` are fp32 in any model.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import dispatch
from repro_torch.models.layers import rms_norm

# the leaves kept in fp32 whatever the model's dtype
FP32_LEAVES = ("decay_base", "bonus_u", "ln_x")


def _dims(cfg: ModelConfig):
    hd = cfg.rwkv.head_dim
    nh = cfg.d_model // hd
    return nh, hd


def rwkv_leaves(cfg: ModelConfig):
    """(name, shape) of one layer's time- and channel-mix leaves, in the
    reference's ``rwkv_init`` order."""
    d, f = cfg.d_model, cfg.d_ff
    nh, hd = _dims(cfg)
    lora = cfg.rwkv.decay_lora
    return ([(f"mix_{c}", (d,)) for c in "rkvwg"]
            + [(f"w{c}", (d, d)) for c in "rkvgo"]
            + [("decay_a", (d, lora)), ("decay_b", (lora, d)),
               ("decay_base", (d,)), ("bonus_u", (nh, hd)), ("ln_x", (d,)),
               ("cmix_r", (d,)), ("cmix_k", (d,)),
               ("ck", (d, f)), ("cv", (f, d)), ("cr", (d, d))])


def init_leaf(gen: torch.Generator, name: str, shape, dtype) -> torch.Tensor:
    """One ``rwkv_leaves`` leaf by the reference's init law, drawn from
    ``gen``: mixes 0.5, ``decay_base`` -4, ``bonus_u`` N(0, 0.1^2),
    ``ln_x`` zero (these three fp32), dense N(0, 1/d_in)."""
    dev = gen.device
    if name.startswith(("mix_", "cmix_")):
        return torch.full(shape, 0.5, dtype=dtype, device=dev)
    if name == "decay_base":
        return torch.full(shape, -4.0, dtype=torch.float32, device=dev)
    if name == "bonus_u":
        return torch.randn(shape, generator=gen, device=dev) * 0.1
    if name == "ln_x":
        return torch.zeros(shape, dtype=torch.float32, device=dev)
    return (torch.randn(shape, generator=gen, device=dev)
            * shape[0] ** -0.5).to(dtype)


def _token_shift(x, mix, last=None):
    """x [B,T,D]; returns lerp(x_{t-1}, x_t, mix). last: [B,1,D] carry or
    None (zeros before the first step)."""
    if last is None:
        prev = F.pad(x, (0, 0, 1, 0))[:, :-1]
    else:
        prev = torch.cat([last, x[:, :-1]], 1)
    return x + (prev - x) * (1.0 - mix)


def rwkv_time_mix(p: Dict[str, torch.Tensor], x: torch.Tensor,
                  cfg: ModelConfig, state=None, *,
                  backend: Optional[str] = None):
    """x [B,T,D]. state: None or {'s': [B,H,D,D] fp32, 'last': [B,1,D]}.
    Returns ``(out [B,T,D], {'s', 'last'})``. ``backend``: the WKV6
    recurrence's (``dispatch.wkv6``)."""
    b, t, d = x.shape
    nh, hd = _dims(cfg)
    last = state["last"] if state is not None else None
    xr, xk, xv, xw, xg = (_token_shift(x, p[f"mix_{c}"], last)
                          for c in "rkvwg")

    def heads(y):                               # [B,T,D] -> [B,H,T,hd] fp32
        return y.reshape(b, t, nh, hd).transpose(1, 2).float().contiguous()

    r, k, v = heads(xr @ p["wr"]), heads(xk @ p["wk"]), heads(xv @ p["wv"])
    g = F.silu((xg @ p["wg"]).float())
    decay = p["decay_base"] + (torch.tanh((xw @ p["decay_a"]).float())
                               @ p["decay_b"].float())
    w = heads(torch.exp(-torch.exp(decay)))     # in (0,1)
    s0 = state["s"] if state is not None else torch.zeros(
        b, nh, hd, hd, dtype=torch.float32, device=x.device)
    o, s_t = dispatch.wkv6(r, k, v, w, p["bonus_u"], s0, backend=backend)
    o = o.transpose(1, 2).reshape(b, t, d)
    o = rms_norm(o, p["ln_x"], eps=1e-5) * g
    out = o.to(x.dtype) @ p["wo"]
    return out, {"s": s_t, "last": x[:, -1:]}


def rwkv_channel_mix(p: Dict[str, torch.Tensor], x: torch.Tensor,
                     state=None):
    """x [B,T,D]; state: None or the last input ``[B,1,D]``. Returns
    ``(out [B,T,D], x[:, -1:])``."""
    xk = _token_shift(x, p["cmix_k"], state)
    xr = _token_shift(x, p["cmix_r"], state)
    k = torch.square(torch.relu(xk @ p["ck"]))
    kv = k @ p["cv"]
    return (torch.sigmoid((xr @ p["cr"]).float()).to(x.dtype) * kv,
            x[:, -1:])

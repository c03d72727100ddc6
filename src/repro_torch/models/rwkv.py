"""RWKV6 ("Finch") block (port of ``repro.models.rwkv``): linear attention
with data-dependent per-channel decay [arXiv:2404.05892].

Recurrence per head (k-dim K, v-dim V):
    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    o_t = r_t @ (S_{t-1} + diag(u) k_t^T v_t)
with w_t = exp(-exp(decay(x_t))) in (0,1)^K, data-dependent via a LoRA.

The recurrence goes through ``repro_torch.kernels.dispatch.wkv6`` in the
kernel's ``[B, H, T, D]`` layout: one call of the CUDA WKV6 kernels per
layer for CUDA tensors (under autograd, the chunked forward and the
backward kernels), the plain chunked version for CPU tensors or
``backend="torch"``. The reference's own chunked scan (``_wkv_chunk_scan``)
is that plain version here, not a second path. Leaves as the reference's
``rwkv_init``; ``decay_base``, ``bonus_u`` and ``ln_x`` are fp32 in any
model.

Both mixes take one model (``x [b, T, d]``, leaves without leading axes:
serving) or G models at once (``x [G, b, T, d]``, every leaf ``[G, ...]``:
training), each product one batched matmul over the models. The time mix
folds the models into the head axis of its one WKV6 call, ``[b, G * H, T,
D]`` with ``u [G * H, D]``, so each model's bonus reaches its own heads.

Under a sequence split (``seq``, a ``sharding.pool.SequenceAxis``; the
sharded LM sweep's ``activation_spec=P(None, "model", None)``) ``x`` is
this rank's chunk of every sequence: each token shift's carry is the
previous rank's last input row (``seq.prev_rows``), and the WKV6 state
entering the chunk is ``seq.carry_in`` of every earlier rank's chunk-final
state (one WKV6 call from zero) and its summed log decay ``sum_t log
w_t`` on the key axis; the chunk's outputs are a second WKV6 call from
that state.
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


def _per_model(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``w [*L, d]`` broadcast against ``x [*L, ..., d]``."""
    return w.reshape(w.shape[:-1] + (1,) * (x.dim() - w.dim())
                     + w.shape[-1:])


def _token_shift(x, mix, last=None):
    """x [*L, B, T, D]; returns lerp(x_{t-1}, x_t, mix). last: [*L, B, 1, D]
    carry or None (zeros before the first step)."""
    if last is None:
        # zeros before the first step, as a cat (DTensor refuses the pad's
        # constant_pad_nd on some releases)
        prev = torch.cat([torch.zeros_like(x[..., :1, :]), x[..., :-1, :]],
                         -2)
    else:
        prev = torch.cat([last, x[..., :-1, :]], -2)
    return x + (prev - x) * (1.0 - _per_model(mix, x))


def _models(p: Dict[str, torch.Tensor], x: torch.Tensor, state):
    """One model's leaves and ``x [b, T, d]`` lifted to one model of G
    (``[1, ...]``): ``(p, x, last, one)``; G models' are returned as
    they are."""
    last = state["last"] if state is not None else None
    if x.dim() == 4:
        return p, x, last, False
    p = {k: v[None] for k, v in p.items()}
    return p, x[None], None if last is None else last[None], True


def rwkv_time_mix(p: Dict[str, torch.Tensor], x: torch.Tensor,
                  cfg: ModelConfig, state=None, *,
                  backend: Optional[str] = None, seq=None):
    """x ``[b, T, d]`` (one model) or ``[G, b, T, d]`` (G models, leaves
    ``[G, ...]``). state: None or {'s': [b, H, D, D] fp32, 'last':
    [b, 1, d]} (one model). Returns ``(out like x, {'s': [b, G * H, D, D],
    'last'})``. ``backend``: the WKV6 recurrence's (``dispatch.wkv6``).
    ``seq``: a sequence axis whose rank holds this chunk (``state`` None;
    the module docstring): the returned state is the chunk's last."""
    p, x, last, one = _models(p, x, state)
    G, b, t, d = x.shape
    nh, hd = _dims(cfg)
    if seq is not None:
        last = seq.prev_rows(x, 1, -2)
    xr, xk, xv, xw, xg = (_token_shift(x, p[f"mix_{c}"], last)
                          for c in "rkvwg")

    def mm(y, w):                               # [G,b,T,.] @ [G,.,e]
        return y.reshape(G, b * t, -1) @ w

    def heads(y):                       # [G,b*T,d] -> [b,G*H,T,hd] fp32
        return y.reshape(G, b, t, nh, hd).permute(1, 0, 3, 2, 4).contiguous(
        ).float().reshape(b, G * nh, t, hd)

    r, k, v = heads(mm(xr, p["wr"])), heads(mm(xk, p["wk"])), \
        heads(mm(xv, p["wv"]))
    g = F.silu(mm(xg, p["wg"]).float())
    decay = _per_model(p["decay_base"], g) + (
        torch.tanh(mm(xw, p["decay_a"]).float()) @ p["decay_b"].float())
    w = heads(torch.exp(-torch.exp(decay)))     # in (0,1)
    u = p["bonus_u"].reshape(G * nh, hd).float()
    if u.data_ptr() % 16:          # a view into a parameter buffer
        u = u.clone()
    s0 = state["s"] if state is not None else torch.zeros(
        b, G * nh, hd, hd, dtype=torch.float32, device=x.device)
    if seq is not None:
        _, s_local = dispatch.wkv6(r, k, v, w, u, s0, backend=backend)
        # the chunk's decay on the key axis, as the recurrence takes it
        log_w = torch.log(w.clamp_min(1e-12)).sum(2)[..., None]
        s0 = seq.carry_in(s_local, log_w)
    o, s_t = dispatch.wkv6(r, k, v, w, u, s0, backend=backend)
    o = o.reshape(b, G, nh, t, hd).permute(1, 0, 3, 2, 4).reshape(
        G, b * t, d)
    o = rms_norm(o, p["ln_x"], eps=1e-5) * g
    out = (o.to(x.dtype) @ p["wo"]).reshape(G, b, t, d)
    new_last = x[..., -1:, :]
    if one:
        return out[0], {"s": s_t, "last": new_last[0]}
    return out, {"s": s_t, "last": new_last}


def rwkv_channel_mix(p: Dict[str, torch.Tensor], x: torch.Tensor,
                     state=None, *, seq=None):
    """x ``[b, T, d]`` (one model) or ``[G, b, T, d]`` (leaves ``[G,
    ...]``); state: None or the last input ``[b, 1, d]`` (one model).
    Returns ``(out like x, x[..., -1:, :])``. ``seq``: as in
    ``rwkv_time_mix``."""
    p, x, last, one = _models(p, x, None if state is None
                              else {"last": state})
    G, b, t, d = x.shape
    if seq is not None:
        last = seq.prev_rows(x, 1, -2)
    xk = _token_shift(x, p["cmix_k"], last)
    xr = _token_shift(x, p["cmix_r"], last)
    k = torch.square(torch.relu(xk.reshape(G, b * t, d) @ p["ck"]))
    kv = k @ p["cv"]
    out = (torch.sigmoid((xr.reshape(G, b * t, d) @ p["cr"]).float()
                         ).to(x.dtype) * kv).reshape(G, b, t, d)
    new_last = x[..., -1:, :]
    if one:
        return out[0], new_last[0]
    return out, new_last

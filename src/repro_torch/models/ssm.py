"""Mamba-style selective SSM block (port of ``repro.models.ssm``), used by
the jamba hybrid.

The recurrence ``h_t = a_t * h_{t-1} + b_t`` (elementwise over ``[d_inner,
N]``) runs chunk by chunk, carrying the state: inside a chunk of ``chunk``
steps it is an inclusive doubling (Hillis-Steele) scan, ``log2(chunk)``
elementwise steps over ``[B, C, d_inner, N]`` fp32 applying the
reference's combine ``(a2 a1, a2 b1 + b2)``; the reference walks the same
chunks with ``lax.associative_scan``. So the ``[B, T, d_inner, N]`` decay
and input tensors exist one chunk at a time, and the output contraction
with ``C`` happens in the same chunk. A ragged last chunk is scanned at its
own length (the reference pads it with ``dt = 0``, which leaves the state
unchanged: the same result).

The reference has no Pallas kernel here (a ``jnp`` scan), so the port is
plain torch. ``selective_scan_steps`` is the plain step-by-step
recurrence, kept for the tests. Under autograd each chunk runs under
activation checkpointing, as the reference's ``jax.checkpoint(step)``: the
backward keeps only the chunk's inputs and carried state and recomputes
its ``log2(chunk)`` doubling steps, so they are never all saved at once.

Leaves as the reference's ``ssm_init``; ``dt_proj``, ``dt_bias``,
``a_log`` and ``d_skip`` are fp32 in any model. ``ssm_apply`` takes the
leaves of one model, or of ``G`` models with leading model axes ``[*L,
...]`` and activations ``[*L, b, T, d]`` (the round engine's clients):
each product is one batched matmul over the models, and the scan runs the
``G * b`` rows together.

Under a sequence split (``seq``, a ``sharding.pool.SequenceAxis``; the
sharded LM sweep's ``activation_spec=P(None, "model", None)``) ``x`` is
this rank's chunk of every sequence: the causal conv's left context is the
previous rank's last ``conv_width - 1`` input rows (``seq.prev_rows``),
and the scan's entering state is ``seq.carry_in`` of every earlier rank's
chunk-final state (one scan from zero) and its summed log decay ``A *
sum_t dt_t``; the chunk's outputs are a second scan from that state.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dtype_of, init_dense

# the leaves kept in fp32 whatever the model's dtype
FP32_LEAVES = ("dt_proj", "dt_bias", "a_log", "d_skip")


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    di = cfg.d_model * s.expand
    dtr = s.dt_rank or -(-cfg.d_model // 16)
    return di, s.state_dim, dtr, s.conv_width


def ssm_leaves(cfg: ModelConfig):
    """(name, shape) of one SSM block's leaves, in the reference's
    ``ssm_init`` order."""
    d = cfg.d_model
    di, n, dtr, cw = _dims(cfg)
    return [("in_proj", (d, 2 * di)), ("conv", (cw, di)),
            ("conv_bias", (di,)), ("x_proj", (di, dtr + 2 * n)),
            ("dt_proj", (dtr, di)), ("dt_bias", (di,)), ("a_log", (di, n)),
            ("d_skip", (di,)), ("out_proj", (di, d))]


def init_leaf(gen: torch.Generator, name: str, shape, dtype) -> torch.Tensor:
    """One ``ssm_leaves`` leaf by the reference's init law, drawn from
    ``gen``: dense N(0, 1/d_in) (``dt_proj`` in fp32), ``conv`` N(0,
    0.2^2), ``conv_bias`` zero, and in fp32 ``dt_bias = log(expm1(0.01))``,
    ``a_log = log(1..N)`` on every row, ``d_skip`` ones."""
    dev = gen.device
    if name == "conv":
        return (torch.randn(shape, generator=gen, device=dev) * 0.2).to(dtype)
    if name == "conv_bias":
        return torch.zeros(shape, dtype=dtype, device=dev)
    if name == "dt_bias":
        return torch.log(torch.expm1(torch.full(
            shape, 0.01, dtype=torch.float32, device=dev)))
    if name == "a_log":
        row = torch.log(torch.arange(1, shape[1] + 1, dtype=torch.float32,
                                     device=dev))
        return row.expand(shape).contiguous()
    if name == "d_skip":
        return torch.ones(shape, dtype=torch.float32, device=dev)
    return init_dense(gen, *shape,
                      torch.float32 if name in FP32_LEAVES else dtype)


def ssm_init(gen: torch.Generator, cfg: ModelConfig
             ) -> Dict[str, torch.Tensor]:
    """One SSM block's leaves (other numbers than the reference's
    ``jax.random``)."""
    dt = dtype_of(cfg)
    return {name: init_leaf(gen, name, shape, dt)
            for name, shape in ssm_leaves(cfg)}


def _doubling_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan along axis 1 under ``(a1, b1) . (a2, b2) = (a2 a1,
    a2 b1 + b2)``: ``log2(C)`` doubling steps, each combining every
    element with the one ``s`` steps back."""
    s = 1
    while s < a.shape[1]:
        b = torch.cat([b[:, :s], torch.addcmul(b[:, s:], a[:, s:],
                                               b[:, :-s])], 1)
        a = torch.cat([a[:, :s], a[:, s:] * a[:, :-s]], 1)
        s *= 2
    return a, b


def _scan_chunk(h, dt_c, b_c, c_c, x_c, a):
    """One chunk from the carried state ``h``: ``(y_c [B, C, di], h')``."""
    abar = torch.exp(dt_c[..., None] * a)
    bbar = dt_c[..., None] * b_c[:, :, None, :] * x_c[..., None]
    aa, bb = _doubling_scan(abar, bbar)
    h_all = aa * h[:, None] + bb
    return torch.einsum("bcdn,bcn->bcd", h_all, c_c), h_all[:, -1]


def selective_scan(xc, dt, b_in, c_in, a, h0, chunk: int = 128):
    """The reference's ``_fused_scan``: ``xc, dt [B, T, di]``, ``b_in, c_in
    [B, T, N]``, ``a [di, N]`` (or ``[B, 1, di, N]``, each row's own),
    ``h0 [B, di, N]``, all fp32 -> ``(y [B, T, di], h_T)``. Each chunk's
    ``abar = exp(dt a)`` and ``bbar = dt b x`` ``[B, C, di, N]`` are
    scanned, offset by the carried state, and contracted with ``c``; under
    autograd each chunk is checkpointed."""
    t = xc.shape[1]
    chunk = min(chunk, t)
    grad = torch.is_grad_enabled() and any(
        z.requires_grad for z in (xc, dt, b_in, c_in, a, h0))
    h, ys = h0, []
    for s in range(0, t, chunk):
        parts = [z[:, s:s + chunk] for z in (dt, b_in, c_in, xc)]
        if grad:
            y, h = checkpoint(_scan_chunk, h, *parts, a, use_reentrant=False)
        else:
            y, h = _scan_chunk(h, *parts, a)
        ys.append(y)
    return torch.cat(ys, 1), h


def selective_scan_steps(xc, dt, b_in, c_in, a, h0):
    """The plain recurrence one step at a time (for the tests): ``h_t =
    exp(dt_t a) h_{t-1} + dt_t b_t x_t``, ``y_t = h_t c_t``."""
    h, ys = h0, []
    for t in range(xc.shape[1]):
        h = (torch.exp(dt[:, t, :, None] * a) * h
             + dt[:, t, :, None] * b_in[:, t, None, :] * xc[:, t, :, None])
        ys.append((h * c_in[:, t, None, :]).sum(-1))
    return torch.stack(ys, 1), h


def ssm_apply(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
              state: Optional[Dict[str, torch.Tensor]] = None,
              chunk: int = 128, seq=None):
    """``x [*L, b, T, d]`` for leaves ``[*L, ...]`` (``L`` the leading model
    axes, none for one model); ``state``: None (prefill, training) or
    ``{"conv" [*L, b, cw - 1, di], "h" [*L, b, di, N] fp32}`` (the decode
    carry). Returns ``(out [*L, b, T, d] in x.dtype, new_state)``: the
    depthwise causal conv over the carried or zero-padded inputs, the
    selective scan from the carried or zero state, the skip and the
    ``silu(z)`` gate. ``seq``: a sequence axis whose rank holds this chunk
    (``state`` None, ``T >= cw - 1``; the module docstring)."""
    lead = p["in_proj"].shape[:-2]
    G = math.prod(lead)
    *_, b, t, d = x.shape
    di, n, dtr, cw = _dims(cfg)
    q = {k: v.reshape((G,) + v.shape[len(lead):]) for k, v in p.items()}

    def mm(z, w):                   # [G, b, T, k] @ [G, k, j] per model
        return (z.reshape(G, b * z.shape[2], -1) @ w).reshape(
            G, b, z.shape[2], -1)

    def per_model(v):               # [G, k] -> [G, 1, 1, k]
        return v[:, None, None]

    xs, z = mm(x.reshape(G, b, t, d), q["in_proj"]).split(di, -1)
    if seq is not None:
        if t < cw - 1:
            raise ValueError(f"a sequence chunk of {t} tokens is shorter "
                             f"than the causal conv's {cw - 1} steps of "
                             f"left context: split the sequence over fewer "
                             f"ranks")
        conv_in = torch.cat([seq.prev_rows(xs, cw - 1, 2), xs], 2)
    elif state is None:
        # cw - 1 zero steps before the first, as a cat (DTensor refuses the
        # pad's constant_pad_nd on some releases)
        conv_in = torch.cat([torch.zeros_like(xs[:, :, :1])] * (cw - 1)
                            + [xs], 2)
    else:
        conv_in = torch.cat([state["conv"].reshape(G, b, cw - 1, di), xs], 2)
    w = q["conv"].float()
    xc = per_model(q["conv_bias"].float()) + sum(
        conv_in[:, :, i:i + t].float() * per_model(w[:, i]) for i in range(cw))
    xc = F.silu(xc).to(x.dtype)
    dt_in, b_in, c_in = mm(xc, q["x_proj"]).split([dtr, n, n], -1)
    dt = F.softplus(mm(dt_in.float(), q["dt_proj"])
                    + per_model(q["dt_bias"]))
    a = -torch.exp(q["a_log"])                                # [G, di, N]
    a = a[0] if G == 1 else a[:, None].expand(G, b, di, n).reshape(
        G * b, 1, di, n)
    h0 = state["h"].reshape(G * b, di, n) if state is not None else \
        torch.zeros(G * b, di, n, dtype=torch.float32, device=x.device)
    xf = xc.float()

    def rows(v):                    # [G, b, T, k] -> [G * b, T, k]
        return v.reshape(G * b, t, v.shape[-1])

    scan_in = (rows(xf), rows(dt), rows(b_in.float()), rows(c_in.float()),
               a)
    if seq is not None:
        _, h_local = selective_scan(*scan_in, h0, chunk)
        # the chunk's decay exp(a * sum_t dt_t), per (row, di, N)
        log_a = (a if a.dim() == 2 else a[:, 0]) * rows(dt).sum(1)[..., None]
        h0 = seq.carry_in(h_local, log_a)
    y, h_t = selective_scan(*scan_in, h0, chunk)
    y = (y.reshape(G, b, t, di) + per_model(q["d_skip"]) * xf) \
        * F.silu(z.float())
    out = mm(y.to(x.dtype), q["out_proj"])
    return out.reshape(x.shape), {
        "conv": conv_in[:, :, t:].reshape(lead + (b, cw - 1, di)),
        "h": h_t.reshape(lead + (b, di, n))}


def ssm_init_state(cfg: ModelConfig, batch: int, device=None
                   ) -> Dict[str, torch.Tensor]:
    """The zero decode carry: ``conv [batch, cw - 1, di]`` in the model's
    dtype, ``h [batch, di, N]`` fp32."""
    di, n, _, cw = _dims(cfg)
    return {"conv": torch.zeros(batch, cw - 1, di, dtype=dtype_of(cfg),
                                device=device),
            "h": torch.zeros(batch, di, n, dtype=torch.float32,
                             device=device)}

"""Plain PyTorch versions of the port's kernels (port of ``repro.kernels.ref``).

They define what the kernels compute: the Triton kernel in
``repro_torch.kernels.masked_agg``, the CUDA flash attention in
``repro_torch.kernels.flash_attention`` and the CUDA WKV6 chunk kernel in
``repro_torch.kernels.rwkv6_chunk``. The CPU tests hold them against the
JAX package, and ``chip_smoke.py`` holds the kernels against them on the
card.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

# Branch opcodes of the fused aggregation (match repro.kernels.masked_agg).
OP_MEAN = 0      # fedpbc / fedavg: guarded active-client mean
OP_ALL = 1       # fedavg_all: all-client delta mean
OP_KNOWN_P = 2   # fedavg_known_p: 1/(m * p_i) delta weighting


def masked_agg_ref(x: torch.Tensor, mask: torch.Tensor,
                   prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """FedPBC server aggregation (Alg. 1 line 11): mean over active clients.

    x: [m, n] stacked client parameters; mask: [m] bool/0-1.
    out: [n] fp32 = sum_i mask_i x_i / max(1, sum mask). With ``prev`` ([n])
    an empty active set returns ``prev`` instead of the zero vector.
    """
    mk = mask.float()
    n_active = mk.sum()
    out = (x.float() * mk[:, None]).sum(0) / n_active.clamp_min(1.0)
    if prev is None:
        return out
    return torch.where(n_active > 0, out, prev.float())


def fused_masked_agg_ref(x: torch.Tensor, mask: torch.Tensor,
                         op: Union[int, torch.Tensor], prev: torch.Tensor,
                         p: torch.Tensor) -> torch.Tensor:
    """The fused family aggregation, every branch computed and one selected
    per trajectory by ``op``; fp32 arithmetic, the reference's weight
    expressions (``mask / m``, ``mask / max(p, 1e-3) / m``).

    Single trajectory: x [m, n], mask [m], op scalar, prev [n], p [m];
    batched: a leading [B] axis on every argument. Returns fp32 [n] / [B, n].
    """
    if x.dim() == 2:
        op = torch.as_tensor(op, device=x.device).reshape(1)
        return fused_masked_agg_ref(x[None], mask[None], op, prev[None],
                                    p[None])[0]
    m = x.shape[1]
    xf = x.float()
    mk = mask.float()
    prev = prev.float()
    n_active = mk.sum(1, keepdim=True)                       # [B, 1]
    mean_agg = (xf * mk[..., None]).sum(1) / n_active.clamp_min(1.0)
    mean_out = torch.where(n_active > 0, mean_agg, prev)
    delta = xf - prev[:, None]
    all_out = prev + (delta * (mk / m)[..., None]).sum(1)
    w_kp = mk / p.float().clamp_min(1e-3) / m
    kp_out = prev + (delta * w_kp[..., None]).sum(1)
    op = torch.as_tensor(op, device=x.device).reshape(-1, 1)
    return torch.where(op == OP_MEAN, mean_out,
                       torch.where(op == OP_ALL, all_out, kp_out))


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        logit_softcap: float = 0.0) -> torch.Tensor:
    """Naive softmax attention over ``[..., T, D]`` (same head count; any
    leading axes, ``[B, H]`` in the reference): fp32 scores ``(q k^T)
    D^-1/2``, optional ``cap tanh(s / cap)``, the causal and window masks
    by ``where(allow, s, -1e30)``, a full softmax, the output cast to
    ``q.dtype``. Differentiable: its autograd is the backward kernel's
    yardstick."""
    t, d = q.shape[-2:]
    s = (q.float() @ k.float().transpose(-1, -2)) * (d ** -0.5)
    if logit_softcap:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    qp = torch.arange(t, device=q.device)
    allow = torch.ones((t, t), dtype=torch.bool, device=q.device)
    if causal:
        allow &= qp[:, None] >= qp[None, :]
    if window:
        allow &= qp[:, None] - qp[None, :] < window
    s = torch.where(allow, s, -1e30)
    p = torch.softmax(s, dim=-1)
    return (p @ v.float()).to(q.dtype)


def rwkv6_chunk_ref(r, k, v, w, u, s0):
    """RWKV6 recurrence, step by step (the semantic ground truth).

    r, k, v, w: ``[B, H, T, D]``; u: ``[H, D]``; s0: ``[B, H, D, D]``
    (``S[k_dim, v_dim]``). Returns ``(o [B, H, T, D], s_T)``, fp32:
      o_t = r_t @ S_{t-1} + (r_t . (u * k_t)) v_t
      S_t = diag(w_t) S_{t-1} + k_t^T v_t
    """
    s = s0.float()
    u = u.float()
    outs = []
    for t in range(r.shape[2]):
        rt, kt, vt, wt = (x[:, :, t].float() for x in (r, k, v, w))
        o = torch.einsum("bhk,bhkv->bhv", rt, s)
        outs.append(o + (rt * u * kt).sum(-1, keepdim=True) * vt)
        s = wt[..., None] * s + kt[..., None] * vt[..., None, :]
    return torch.stack(outs, 2), s


def rwkv6_chunk_plain(r, k, v, w, u, s0, *, chunk: int = 64):
    """The chunked WKV6 recurrence that the CUDA kernel computes, in torch
    ops: the same inputs and outputs as :func:`rwkv6_chunk_ref`, any
    ``T >= 1`` (the last chunk may be short; nothing is padded).

    Per chunk, with ``q_inc = cumsum(log w)`` and ``q_exc`` its exclusive
    prefix (both <= 0), every exponent is <= 0, so nothing overflows at
    strong decay (the reference's ``k * exp(-q_inc)`` factorization does):
      inter-chunk  o_t += (r_t * exp(q_exc_t)) @ S
      intra-chunk  o_t += sum_{s<t} [sum_d r_t k_s exp(q_exc_t - q_inc_s)] v_s
      bonus        o_t += (r_t . (u * k_t)) v_t
      state        S <- diag(exp(q_inc_last)) S
                        + (k * exp(q_inc_last - q_inc))^T v
    The chunks run in a Python loop, so one chunk's ``[B, H, C, C, D]``
    pairwise decays are the largest temporaries.
    """
    s = s0.float()
    u = u.float()[None, :, None, :]                     # [1, H, 1, D]
    outs = []
    for t0 in range(0, r.shape[2], chunk):
        rb, kb, vb, wb = (x[:, :, t0:t0 + chunk].float() for x in (r, k, v, w))
        n = rb.shape[2]
        q_inc = torch.cumsum(torch.log(wb.clamp_min(1e-12)), 2)
        q_exc = torch.nn.functional.pad(q_inc[:, :, :-1], (0, 0, 1, 0))
        o = (rb * torch.exp(q_exc)) @ s
        below = torch.ones(n, n, dtype=torch.bool, device=rb.device).tril(-1)
        expo = q_exc[:, :, :, None, :] - q_inc[:, :, None, :, :]  # [.., t, s, D]
        decay = torch.exp(torch.where(below[:, :, None], expo, -torch.inf))
        scores = (rb[:, :, :, None, :] * kb[:, :, None, :, :] * decay).sum(-1)
        o = o + scores @ vb + (rb * u * kb).sum(-1, keepdim=True) * vb
        outs.append(o)
        total = q_inc[:, :, -1:, :]                       # [B, H, 1, D]
        s = (torch.exp(total).transpose(-1, -2) * s
             + (kb * torch.exp(total - q_inc)).transpose(-1, -2) @ vb)
    return torch.cat(outs, 2), s

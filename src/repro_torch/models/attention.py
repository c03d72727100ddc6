"""Chunked (online-softmax) attention (port of ``repro.models.attention``).

``attention`` is the model stack's entry: it routes through
``repro_torch.kernels.dispatch.attention``, which launches the CUDA flash
kernel for CUDA tensors at the kernel's shapes. ``attention_ref`` is the
plain version: it walks the keys in chunks carrying the running (max,
denominator, accumulator), so no ``[Tq, Tk]`` score tensor of the whole
sequence is built in one piece; autograd keeps each chunk's scores for the
backward (the reference recomputes them under ``jax.checkpoint``).

Masks: causal full, sliding-window (swa) and block-local (chunked); logit
softcap; GQA by repeating KV heads. ``decode_attention`` and
``cross_attention`` wait for the serve path and the model zoo (ROADMAP
Queue 1 items 7-8).
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """``[B, S, KV, D] -> [B, S, KV * n_rep, D]``, each KV head repeated
    for ``n_rep`` consecutive query heads."""
    if n_rep == 1:
        return k
    b, s, kvh, d = k.shape
    return k[:, :, :, None, :].expand(b, s, kvh, n_rep, d).reshape(
        b, s, kvh * n_rep, d)


def _mask_chunk(q_pos, k_pos, kind, window):
    """[Tq, Tk] boolean allow-mask for query positions vs key positions."""
    causal = q_pos[:, None] >= k_pos[None, :]
    if kind == "full":
        return causal
    if kind == "swa":
        return causal & (q_pos[:, None] - k_pos[None, :] < window)
    if kind == "chunked":
        return causal & (q_pos[:, None] // window
                         == k_pos[None, :] // window)
    raise ValueError(kind)


def attention(q, k, v, *, kind="full", window=4096, logit_softcap=0.0,
              chunk=1024, q_offset=0, backend=None):
    """Causal multi-head attention, dispatched.

    q: [B, Tq, H, D];  k, v: [B, Tk, KV, D];  returns [B, Tq, H, D].
    ``q_offset``: absolute position of q[0] (Tk = q_offset + Tq for
    training). CUDA tensors at the kernel's shapes take the flash kernel;
    everything else is :func:`attention_ref`, and so is every shape when
    ``backend="torch"`` (see ``repro_torch.kernels.dispatch.attention``).
    """
    from repro_torch.kernels.dispatch import attention as dispatch_attention

    return dispatch_attention(q, k, v, kind=kind, window=window,
                              logit_softcap=logit_softcap, chunk=chunk,
                              q_offset=q_offset, backend=backend)


def attention_ref(q, k, v, *, kind="full", window=4096, logit_softcap=0.0,
                  chunk=1024, q_offset=0):
    """The plain chunked online-softmax version, the reference's
    ``attention_ref`` step for step (``q`` scaled in its own dtype, then
    fp32 scores, ``where(allow, s, -1e30)``, the output cast to
    ``q.dtype``)."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    n_rep = h // k.shape[2]
    k = repeat_kv(k, n_rep)
    v = repeat_kv(v, n_rep)
    qf = (q * d ** -0.5).float().transpose(1, 2)           # [B, H, Tq, D]
    dev = q.device
    q_pos = q_offset + torch.arange(tq, device=dev)
    chunk = min(chunk, tk)
    m = torch.full((b, h, tq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, tq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h, tq, d), dtype=torch.float32, device=dev)
    for start in range(0, tk, chunk):
        stop = min(start + chunk, tk)
        kb = k[:, start:stop].float().transpose(1, 2)        # [B, H, C, D]
        vb = v[:, start:stop].float().transpose(1, 2)
        k_pos = torch.arange(start, stop, device=dev)
        s = qf @ kb.transpose(-1, -2)
        if logit_softcap:
            s = logit_softcap * torch.tanh(s / logit_softcap)
        allow = _mask_chunk(q_pos, k_pos, kind, window)
        s = torch.where(allow, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + p @ vb
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)

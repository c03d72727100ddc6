"""Chunked (online-softmax) attention (port of ``repro.models.attention``).

``attention`` is the model stack's entry: it routes through
``repro_torch.kernels.dispatch.attention``, which launches the CUDA flash
kernel for CUDA tensors at the kernel's shapes. ``attention_ref`` is the
plain version: it walks the keys in chunks carrying the running (max,
denominator, accumulator), so no ``[Tq, Tk]`` score tensor of the whole
sequence is built in one piece; autograd keeps each chunk's scores for the
backward (the reference recomputes them under ``jax.checkpoint``).

Masks: causal full, sliding-window (swa) and block-local (chunked); logit
softcap; GQA by repeating KV heads. ``decode_attention`` is one query token
against a KV cache, and ``cross_attention`` non-causal attention against
fixed memory (image tokens, encoder frames): both plain torch, as in the
reference, which has no kernel there.
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


def cross_attention(q, k, v, *, q_chunk=512):
    """Non-causal attention against fixed memory: ``q [B, Tq, H, D]``,
    ``k, v [B, Tk, KV, D]`` -> ``[B, Tq, H, D]`` in ``q.dtype``. GQA by
    repeating KV heads; fp32 scores (``q`` cast to fp32, then scaled by
    ``D ** -0.5``) and a full softmax over the memory, one chunk of
    ``q_chunk`` queries at a time, so the scores stay ``[B, H, q_chunk,
    Tk]`` (a ragged last chunk at its own length; the reference pads it and
    slices the pad off, the same rows)."""
    d = q.shape[-1]
    n_rep = q.shape[2] // k.shape[2]
    kf = repeat_kv(k, n_rep).float().permute(0, 2, 3, 1)    # [B, H, D, Tk]
    vf = repeat_kv(v, n_rep).float().transpose(1, 2)        # [B, H, Tk, D]
    outs = []
    for start in range(0, q.shape[1], q_chunk):
        qc = (q[:, start:start + q_chunk].float() * d ** -0.5).transpose(1, 2)
        p = torch.softmax(qc @ kf, -1)
        outs.append((p @ vf).transpose(1, 2).to(q.dtype))
    return torch.cat(outs, 1)


def decode_attention(q, k_cache, v_cache, cache_len, *, kind="full",
                     window=4096, logit_softcap=0.0, chunk=8192):
    """Single-token decode: ``q [B, 1, H, D]``, cache ``[B, S, KV, D]``.

    As in the reference: the new token's k/v are already in the cache and
    ``cache_len`` (an int or a 0-d tensor) counts them, so the query sits at
    position ``cache_len - 1``. Windowed kinds attend only the trailing
    ``min(window, S)`` cache positions; the softmax runs online over cache
    chunks in fp32, ``q`` scaled by ``D ** -0.5`` in its own dtype first,
    the softcap before the valid mask (a ``where`` to ``NEG_INF``).
    Returns ``[B, 1, H, D]`` in ``q.dtype``.
    """
    b, _, h, d = q.shape
    s_max = k_cache.shape[1]
    dev = q.device
    cache_len = torch.as_tensor(cache_len, device=dev)
    if kind in ("swa", "chunked"):
        w = min(window, s_max)
        start = (cache_len - w).clamp(0, s_max - w)
        pos = start + torch.arange(w, device=dev)
        k_cache = k_cache.index_select(1, pos)
        v_cache = v_cache.index_select(1, pos)
        if kind == "chunked":
            valid = (pos < cache_len) & (
                pos // window == (cache_len - 1).clamp_min(0) // window)
        else:
            valid = (pos < cache_len) & (cache_len - 1 - pos < window)
    else:
        pos = torch.arange(s_max, device=dev)
        valid = pos < cache_len

    n_rep = h // k_cache.shape[2]
    kf = repeat_kv(k_cache, n_rep)
    vf = repeat_kv(v_cache, n_rep)
    tk = kf.shape[1]
    chunk = min(chunk, tk)
    qf = (q[:, 0] * d ** -0.5).float().unsqueeze(-2)       # [B, H, 1, D]
    m = torch.full((b, h), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h, d), dtype=torch.float32, device=dev)
    for start in range(0, tk, chunk):
        stop = min(start + chunk, tk)
        kb = kf[:, start:stop].float().transpose(1, 2)        # [B, H, C, D]
        vb = vf[:, start:stop].float().transpose(1, 2)
        s = (qf @ kb.transpose(-1, -2)).squeeze(-2)           # [B, H, C]
        if logit_softcap:
            s = logit_softcap * torch.tanh(s / logit_softcap)
        s = torch.where(valid[start:stop], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + (p.unsqueeze(-2) @ vb).squeeze(-2)
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out[:, None].to(q.dtype)

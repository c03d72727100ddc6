"""Model assembly (port of ``repro.models.model``): the dense and RWKV6
families.

Design, as in the reference:
- the layer stack is organised in *periods*, the smallest repeating pattern
  of layer kinds (plain dense and RWKV: 1; local/global alternation: 2), and
  each period position's parameters are stacked on a leading
  ``[n_periods]`` axis (the reference's ``blocks`` tuple);
- ``forward``: train/prefill over the full sequence; ``loss_fn``: chunked
  cross-entropy; ``decode_step``: one token against the cache (serve path,
  RWKV6 only so far: the dense family's needs ``decode_attention``).

What differs: the parameters are the named views of one flat buffer
(``param_layout``; ``repro_torch.core.params``) with any leading model
axes ``L`` — the round engine passes every client model at once,
``[B, m, n]``, and tokens ``[*L, b, T]``. Each product is then one batched
matmul over all ``prod(L)`` models (the reference does these products
outside any Pallas kernel), the embedding gather and the tied head are per
model, and attention folds models, batch and heads into the flash kernel's
batch axis: one launch per layer. The reference's scan over periods is a
Python loop.

The RWKV6 family (``family="ssm"``) runs one model, no leading axes: its
leaves are the reference's ``blocks[i]["tmix"]`` dict (the channel mix's
leaves inside it, as there) plus ``ln1``/``ln2``, and its fp32 leaves
(``decay_base``, ``bonus_u``, ``ln_x``) keep fp32 in a bf16 model, so it
is held leaf by leaf (``init_leaves``; ``ParamLayout.fp32``), not in one
buffer; each layer's WKV6 recurrence is one launch of the CUDA kernel
(``models/rwkv.py``). Its training is not ported (ROADMAP Queue 1 item 10:
it needs a WKV6 backward). Other families raise ``NotImplementedError``
(ROADMAP Queue 1 item 7: the model zoo).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.params import ParamLayout
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models.attention import attention
from repro_torch.models.layers import (
    apply_rope,
    dtype_of,
    init_dense,
    mlp_apply,
    rms_norm,
    rope_angles,
    softcap,
)

Params = Dict[str, torch.Tensor]


# the families ported so far: dense transformers and RWKV6 ("ssm")
FAMILIES = ("dense", "ssm")


def _ported(cfg: ModelConfig):
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP Queue 1 item "
            f"7: the model zoo); the port runs {FAMILIES}")


def _trainable(cfg: ModelConfig):
    _ported(cfg)
    if cfg.family != "dense":
        raise NotImplementedError(
            f"training the {cfg.family!r} family is not ported yet (ROADMAP "
            "Queue 1 item 10: RWKV6 training needs a hand-written WKV6 "
            "backward); its forward and decode_step are")


def period_length(cfg: ModelConfig) -> int:
    _ported(cfg)
    p = 2 if cfg.attention.pattern == "local_global" else 1
    assert cfg.num_layers % p == 0, (cfg.name, cfg.num_layers, p)
    return p


def attn_kind(cfg: ModelConfig, layer_idx: int) -> str:
    pat = cfg.attention.pattern
    if pat == "local_global":
        return "swa" if layer_idx % 2 == 0 else "full"
    return pat


def _layer_leaves(cfg: ModelConfig):
    """(name, shape) of one layer's parameters, the reference's nesting
    joined with dots."""
    d, hd, a = cfg.d_model, cfg.head_dim, cfg.attention
    if cfg.layer_kind(0) == "rwkv":
        return ([("ln1", (d,))]
                + [(f"tmix.{n}", s) for n, s in rwkv_mod.rwkv_leaves(cfg)]
                + [("ln2", (d,))])
    out = [("ln1", (d,)),
           ("attn.wq", (d, a.num_heads * hd)),
           ("attn.wk", (d, a.num_kv_heads * hd)),
           ("attn.wv", (d, a.num_kv_heads * hd)),
           ("attn.wo", (a.num_heads * hd, d)),
           ("ln2", (d,)),
           ("ffn.up", (d, cfg.d_ff)),
           ("ffn.down", (cfg.d_ff, d))]
    if cfg.gated_mlp:
        out.append(("ffn.gate", (d, cfg.d_ff)))
    return out


def param_layout(cfg: ModelConfig) -> ParamLayout:
    """The model's leaves: ``embed``, ``blocks.{i}.<layer leaf>`` stacked
    ``[n_periods, ...]`` for each period position ``i``, ``final_norm``,
    and ``lm_head`` unless the embedding is tied; RWKV6's fp32 leaves are
    the layout's ``fp32``."""
    P = period_length(cfg)
    n_periods = cfg.num_layers // P
    leaves = [("embed", (cfg.vocab_size, cfg.d_model))]
    for i in range(P):
        leaves += [(f"blocks.{i}.{name}", (n_periods,) + shape)
                   for name, shape in _layer_leaves(cfg)]
    leaves.append(("final_norm", (cfg.d_model,)))
    if not cfg.tie_embeddings:
        leaves.append(("lm_head", (cfg.d_model, cfg.vocab_size)))
    fp32 = frozenset(name for name, _ in leaves
                     if name.rsplit(".", 1)[-1] in rwkv_mod.FP32_LEAVES
                     and ".tmix." in name)
    return ParamLayout(tuple(leaves), fp32)


def init_leaves(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """One model's named leaves on the generator's device, each in its
    dtype (``cfg.dtype``; fp32 for the layout's ``fp32`` leaves): the
    reference's init laws (embedding N(0, 0.02^2), dense N(0, 1/d_in),
    norms zero, RWKV's as ``models.rwkv.init_leaf``), drawn from ``gen``
    (other numbers than ``jax.random``'s)."""
    dt = dtype_of(cfg)
    dev = gen.device
    out = {}
    for name, shape in param_layout(cfg).leaves:
        if name == "embed":
            leaf = (torch.randn(shape, generator=gen, device=dev)
                    * 0.02).to(dt)
        elif name.endswith(("ln1", "ln2", "final_norm")):
            leaf = torch.zeros(shape, dtype=dt, device=dev)
        elif name == "lm_head":
            leaf = init_dense(gen, *shape, dt)
        elif ".tmix." in name:                  # [n_periods, ...]
            leaf = torch.stack([
                rwkv_mod.init_leaf(gen, name.rsplit(".", 1)[-1], shape[1:],
                                   dt) for _ in range(shape[0])])
        else:                                   # [n_periods, d_in, d_out]
            leaf = torch.stack([init_dense(gen, *shape[1:], dt)
                                for _ in range(shape[0])])
        out[name] = leaf
    return out


def init_params(gen: torch.Generator, cfg: ModelConfig) -> torch.Tensor:
    """One model's flat params ``[n]`` in ``cfg.dtype`` on the generator's
    device (``init_leaves`` in layout order), for the round engine; raises
    for a layout with fp32 leaves in a narrower model (RWKV6 in bf16)."""
    return param_layout(cfg).flatten(init_leaves(gen, cfg), device=gen.device,
                                     dtype=dtype_of(cfg))


# ---------------------------------------------------------------------------
# Forward (train / prefill)
# ---------------------------------------------------------------------------


def _self_attn_block(p: Params, x, cfg: ModelConfig, kind: str, b: int,
                     positions, backend=None):
    """``x [G, b*T, d]`` (G models); ``p`` leaves ``[G, ...]``."""
    a = cfg.attention
    hd = cfg.head_dim
    G, N, _ = x.shape
    t = N // b
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    q = (h @ p["attn.wq"]).reshape(G * b, t, a.num_heads, hd)
    k = (h @ p["attn.wk"]).reshape(G * b, t, a.num_kv_heads, hd)
    v = (h @ p["attn.wv"]).reshape(G * b, t, a.num_kv_heads, hd)
    cos, sin = rope_angles(positions, hd, a.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    o = attention(q, k, v, kind=kind, window=a.window,
                  logit_softcap=a.logit_softcap, backend=backend)
    return x + o.reshape(G, N, -1) @ p["attn.wo"]


def _ffn_block(p: Params, x, cfg: ModelConfig):
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    ffn = {"up": p["ffn.up"], "down": p["ffn.down"]}
    if cfg.gated_mlp:
        ffn["gate"] = p["ffn.gate"]
    return x + mlp_apply(ffn, h, cfg.gated_mlp)


def _models(params: Params, tokens: torch.Tensor) -> Tuple[Params, int]:
    """Fold the leading model axes ``L`` of every leaf into one axis G."""
    lead = tokens.shape[:-2]
    G = math.prod(lead)
    emb = params["embed"]
    if emb.shape[:-2] != lead:
        raise ValueError(f"params lead {tuple(emb.shape[:-2])} vs tokens "
                         f"lead {tuple(lead)}")
    n = len(lead)
    return {k: v.reshape((G,) + v.shape[n:]) for k, v in params.items()}, G


def _rwkv_layer(params: Params, cfg: ModelConfig, i: int, layer: int):
    """Period position ``i``, period ``layer``: ``(ln1, ln2, tmix)``, the
    time- and channel-mix leaves by their reference names."""
    pre = f"blocks.{i}."
    tmix = {name: params[pre + "tmix." + name][layer]
            for name, _ in rwkv_mod.rwkv_leaves(cfg)}
    return params[pre + "ln1"][layer], params[pre + "ln2"][layer], tmix


def _rwkv_hidden(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                 backend=None) -> torch.Tensor:
    """The RWKV6 stack over ``tokens [b, T]`` (one model) -> the final
    normed hidden states ``[b, T, d]``; one WKV6 launch per layer."""
    if tokens.dim() != 2:
        raise ValueError(f"the rwkv family runs one model: tokens [b, T], "
                         f"got {tuple(tokens.shape)}")
    x = params["embed"][tokens.long()].to(dtype_of(cfg))
    P = period_length(cfg)
    for layer in range(cfg.num_layers // P):
        for i in range(P):
            ln1, ln2, tmix = _rwkv_layer(params, cfg, i, layer)
            h, _ = rwkv_mod.rwkv_time_mix(
                tmix, rms_norm(x, ln1, cfg.norm_eps), cfg, backend=backend)
            x = x + h
            h, _ = rwkv_mod.rwkv_channel_mix(tmix,
                                             rms_norm(x, ln2, cfg.norm_eps))
            x = x + h
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def hidden_forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                   *, backend=None) -> torch.Tensor:
    """``params`` leaves ``[*L, ...]``, ``tokens [*L, b, T]`` -> the final
    normed hidden states ``[*L, b, T, d]`` (the LM head not applied; the
    rwkv family takes no ``L``). ``backend``: ``None`` (the kernels for
    CUDA tensors) or ``"torch"`` (the plain versions on any device), see
    ``repro_torch.kernels.dispatch``."""
    if cfg.family == "ssm":
        return _rwkv_hidden(params, cfg, tokens, backend)
    P = period_length(cfg)
    n_periods = cfg.num_layers // P
    p, G = _models(params, tokens)
    b, t = tokens.shape[-2:]
    tok = tokens.reshape(G, b * t).long()
    rows = torch.arange(G, device=tok.device)[:, None]
    x = p["embed"][rows, tok].to(dtype_of(cfg))          # [G, b*T, d]
    positions = torch.arange(t, device=tok.device)
    for layer in range(n_periods):
        for i in range(P):
            lp = {name: p[f"blocks.{i}.{name}"][:, layer]
                  for name, _ in _layer_leaves(cfg)}
            x = _self_attn_block(lp, x, cfg, attn_kind(cfg, i), b, positions,
                                 backend)
            x = _ffn_block(lp, x, cfg)
    x = rms_norm(x, p["final_norm"], cfg.norm_eps)
    return x.reshape(tokens.shape + (cfg.d_model,))


def _head(params: Params, cfg: ModelConfig) -> torch.Tensor:
    """``[*L, d, V]``: the tied embedding's transpose, or ``lm_head``."""
    if "lm_head" in params:
        return params["lm_head"]
    return params["embed"].transpose(-1, -2)


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            backend=None):
    """tokens ``[*L, b, T]`` -> ``(logits [*L, b, T, V] fp32, aux [*L])``
    (aux, the MoE balance loss, is zero for the dense and rwkv families;
    the train/prefill entry)."""
    hidden = hidden_forward(params, cfg, tokens, backend=backend)
    lead = tokens.shape[:-2]
    G = math.prod(lead)
    h = hidden.reshape(G, -1, cfg.d_model)
    logits = h @ _head(params, cfg).reshape(G, cfg.d_model, -1)
    logits = softcap(logits.float(), cfg.final_softcap)
    aux = torch.zeros(lead, dtype=torch.float32, device=tokens.device)
    return logits.reshape(tokens.shape + (-1,)), aux


def _chunk_ce(h, y, head, cap: float):
    """Summed cross-entropy of one token chunk per model: ``h [G, N, d]``,
    ``y [G, N]``, ``head [G, d, V]`` -> ``[G]``."""
    logits = softcap((h @ head).float(), cap)
    lse = torch.logsumexp(logits, -1)
    gold = logits.gather(-1, y.unsqueeze(-1)).squeeze(-1)
    return (lse - gold).sum(-1)


def loss_fn(params: Params, cfg: ModelConfig, batch, *,
            ce_chunk: int = 512, backend=None) -> torch.Tensor:
    """``batch``: ``{"tokens", "labels"}``, each ``[*L, b, T]`` -> the
    per-model mean next-token cross-entropy ``[*L]``.

    The cross-entropy runs over token chunks of ``ce_chunk`` under
    activation checkpointing (the reference's ``jax.checkpoint``), so only
    one ``[G, b, ce_chunk, V]`` chunk of logits is live at a time. When
    ``ce_chunk`` does not divide ``T`` the whole sequence is one chunk, as
    in the reference's padded branch.
    """
    _trainable(cfg)
    tokens, labels = batch["tokens"], batch["labels"]
    hidden = hidden_forward(params, cfg, tokens, backend=backend)
    lead = tokens.shape[:-2]
    G = math.prod(lead)
    b, t = tokens.shape[-2:]
    d = cfg.d_model
    head = _head(params, cfg).reshape(G, d, -1)
    hidden = hidden.reshape(G, b, t, d)
    labels = labels.reshape(G, b, t).long()
    ce_chunk = min(ce_chunk, t)
    if t % ce_chunk:
        ce = _chunk_ce(hidden.reshape(G, b * t, d), labels.reshape(G, -1),
                       head, cfg.final_softcap) / (b * t)
        return ce.reshape(lead)
    tot = torch.zeros(G, dtype=torch.float32, device=tokens.device)
    for s in range(0, t, ce_chunk):
        h = hidden[:, :, s:s + ce_chunk].reshape(G, -1, d)
        y = labels[:, :, s:s + ce_chunk].reshape(G, -1)
        tot = tot + checkpoint(_chunk_ce, h, y, head, cfg.final_softcap,
                               use_reentrant=False)
    return (tot / (b * t)).reshape(lead)


def make_loss(cfg: ModelConfig, backend=None):
    """The round engine's loss: ``(flat [*L, n], batch) -> [*L]``;
    ``backend="torch"`` runs the plain attention on the card."""
    _trainable(cfg)
    layout = param_layout(cfg)

    def loss(flat: torch.Tensor, batch) -> torch.Tensor:
        return loss_fn(layout.unflatten(flat), cfg, batch,
                       backend=backend)

    return loss


# ---------------------------------------------------------------------------
# Decode (serve path)
# ---------------------------------------------------------------------------


def _decodable(cfg: ModelConfig):
    _ported(cfg)
    if cfg.family != "ssm":
        raise NotImplementedError(
            f"decoding the {cfg.family!r} family is not ported yet (ROADMAP "
            "Queue 1 item 11: its KV cache needs decode_attention); the rwkv "
            "family decodes")


def make_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> Tuple[Dict[str, torch.Tensor], ...]:
    """Cache matching the period structure (leading axis ``n_periods``):
    per period position, RWKV6's ``s [n_periods, batch, H, D, D]`` fp32
    state and the token-shift carries ``last`` / ``clast [n_periods, batch,
    1, d]`` in ``cfg.dtype``, zero. ``max_len`` is the reference's
    (a KV cache's length); the RWKV state does not grow."""
    _decodable(cfg)
    P = period_length(cfg)
    n_periods = cfg.num_layers // P
    hd = cfg.rwkv.head_dim
    nh = cfg.d_model // hd
    dt = dtype_of(cfg)

    def carry():
        return torch.zeros(n_periods, batch, 1, cfg.d_model, dtype=dt,
                           device=device)

    return tuple({"s": torch.zeros(n_periods, batch, nh, hd, hd,
                                   dtype=torch.float32, device=device),
                  "last": carry(), "clast": carry()} for _ in range(P))


def decode_step(params: Params, cfg: ModelConfig, token: torch.Tensor,
                cache, pos, *, backend=None):
    """``token [B, 1]`` int; ``cache`` from ``make_cache``; ``pos`` the
    tokens already in the cache (the RWKV state carries it; kept for the
    reference's signature). Returns ``(logits [B, 1, V] fp32, new_cache)``;
    the cache given is not changed. One WKV6 launch per layer at T = 1."""
    _decodable(cfg)
    x = params["embed"][token.long()].to(dtype_of(cfg))
    P = period_length(cfg)
    new = [{"s": [], "last": [], "clast": []} for _ in range(P)]
    for layer in range(cfg.num_layers // P):
        for i in range(P):
            ln1, ln2, tmix = _rwkv_layer(params, cfg, i, layer)
            c = cache[i]
            o, st = rwkv_mod.rwkv_time_mix(
                tmix, rms_norm(x, ln1, cfg.norm_eps), cfg,
                state={"s": c["s"][layer], "last": c["last"][layer]},
                backend=backend)
            x = x + o
            o, clast = rwkv_mod.rwkv_channel_mix(
                tmix, rms_norm(x, ln2, cfg.norm_eps), state=c["clast"][layer])
            x = x + o
            new[i]["s"].append(st["s"])
            new[i]["last"].append(st["last"])
            new[i]["clast"].append(clast)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = softcap((x @ _head(params, cfg)).float(), cfg.final_softcap)
    return logits, tuple({k: torch.stack(v) for k, v in c.items()}
                         for c in new)

"""Model assembly (port of ``repro.models.model``): every family of the
model zoo.

Design, as in the reference:
- the layer stack is organised in *periods*, the smallest repeating pattern
  of layer kinds (plain dense and RWKV: 1; local/global alternation: 2;
  jamba: 8; the vlm: ``cross_attn_every``), and each period position's parameters are stacked on a leading
  ``[n_periods]`` axis (the reference's ``blocks`` tuple);
- ``forward``: train/prefill over the full sequence; ``loss_fn``: chunked
  cross-entropy; ``decode_step``: one token against the cache (serve path:
  the KV cache, ring buffers for windowed layers, through the plain
  ``decode_attention``; the Mamba carry; RWKV6's state).

What differs: the parameters are the named views of one flat buffer
(``param_layout``; ``repro_torch.core.params``) with any leading model
axes ``L`` — the round engine passes every client model at once,
``[B, m, n]``, and tokens ``[*L, b, T]``. Each product is then one batched
matmul over all ``prod(L)`` models (the reference does these products
outside any Pallas kernel), the embedding gather and the tied head are per
model, and attention folds models, batch and heads into the flash kernel's
batch axis: one launch per layer. The reference's scan over periods is a
Python loop.

The RWKV6 family (``family="ssm"``) trains and serves like the dense stack:
its leaves are the reference's ``blocks[i]["tmix"]`` dict (the channel
mix's leaves inside it, as there) plus ``ln1``/``ln2``, stacked with any
leading model axes; its fp32 leaves (``decay_base``, ``bonus_u``,
``ln_x``) keep fp32 in a bf16 model, which makes two parameter groups as
below. Each layer's WKV6 recurrence is one call of the CUDA kernels for all
G models, folded into the head axis (``models/rwkv.py``); under autograd
the chunked forward and the hand-written backward. ``decode_step`` and
``make_cache`` stay one model.

The MoE family (``family="moe"``; mixtral, llama4-maverick) is the dense
stack with ``moe.*`` leaves in place of ``ffn.*`` on the layers of
``cfg._is_moe_layer`` (``models/moe.py``: plain torch, as the reference
has no kernel there); ``loss_fn`` adds ``0.01 * aux``, the balance loss,
as the reference's does.

Sequence parallelism (the sharded sweep's ``run_sharded_2d(...,
activation_spec=P(None, "model", None))``): under a sequence axis
(``sharding.specs.sequence_axis``, a ``sharding.pool.SequenceAxis``) the
forward takes one rank's chunk of every sequence, at its absolute
positions; each attention block all-gathers K and V up to the chunk's end
and attends at the chunk's offset (the flash kernels' causal-offset
route); RWKV6's token shifts and WKV6 state and the Mamba block's conv
context and scan state are carried in from the earlier ranks
(``models/rwkv.py``, ``models/ssm.py``); an MoE layer routes each row as
one group across the ranks (``models/moe.py``); norms, products, the MLP
and the loss stay local. The vlm and audio families raise under an axis
(``_sequence_split_ok``): the LM sweep gives their cross layers no
memory.

Fp32 leaves in a bf16 model (the MoE router, the Mamba ``dt_proj``,
``dt_bias``, ``a_log``, ``d_skip``, the cross gate, RWKV6's) make two parameter
groups (``init_params``, ``ParamLayout.pack``): the round engine holds
such a model as ``Groups`` of a bf16 and an fp32 buffer, and ``make_loss``
takes them; serving holds it leaf by leaf (``init_leaves``).

The hybrid (jamba), vlm (llama-3.2-vision) and audio (seamless-m4t)
families train and serve with leading model axes like the dense stack:
the Mamba block, the cross block and the audio encoder run ``G`` models
at once, the encoder's and the cross block's attention folding them into
the batch (one flash launch per encoder layer). ``memory`` carries the
models' axes too, ``[*L, b, M, d]``. Their period (``period_length``)
holds layers of three kinds: ``attn``; ``ssm``, a Mamba block (``ssm.*``
leaves, ``models/ssm.py``, plain torch as in the reference) in place of
the self-attention; ``cross``, the self-attention followed by a gated
cross-attention block (``lnc``, ``cross.*``, the 0-d fp32 ``cross_gate``)
against ``memory``: image tokens through ``image_proj`` (vlm) or audio
frames through the encoder (``encoder.*`` stacked ``[encoder_layers,
...]``, ``enc_norm``, ``audio_proj``; its self-attention is causal, as
the reference's). As in ``jnp``, a product of memory-derived activations
with the model's weights runs in the promoted dtype (``_mm``): with the
reference launcher's fp32 memory the vlm projections and the whole audio
encoder run in fp32 (its attention through the fp32 flash kernel), and the
cross-attention's output is cast back to the model's dtype.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.params import ParamLayout
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import (attention, cross_attention,
                                          decode_attention)
from repro_torch.models.layers import (
    apply_rope,
    dtype_of,
    init_dense,
    mlp_apply,
    rms_norm,
    rope_angles,
    softcap,
)
from repro_torch.sharding.specs import maybe_constrain, sequence_axis

Params = Dict[str, torch.Tensor]


FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


def _known(cfg: ModelConfig):
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}; the port runs "
                         f"{FAMILIES}")


def period_length(cfg: ModelConfig) -> int:
    """The smallest repeating pattern of layer kinds: for the hybrid the
    lcm of ``attn_every`` and ``moe_every``; for the vlm
    ``cross_attn_every``; 2 for local/global alternation; times the MoE
    interleave (the lcm with ``moe_every``) outside the hybrid."""
    _known(cfg)
    p = 1
    if cfg.family == "hybrid":
        p = math.lcm(max(cfg.attn_every, 1),
                     max(cfg.moe_every, 1) if cfg.moe else 1)
    elif cfg.family == "vlm" and cfg.cross_attn_every:
        p = cfg.cross_attn_every
    elif cfg.attention.pattern == "local_global":
        p = 2
    if cfg.moe and cfg.family != "hybrid":
        p = math.lcm(p, max(cfg.moe_every, 1))
    assert cfg.num_layers % p == 0, (cfg.name, cfg.num_layers, p)
    return p


def attn_kind(cfg: ModelConfig, layer_idx: int) -> str:
    pat = cfg.attention.pattern
    if pat == "local_global":
        return "swa" if layer_idx % 2 == 0 else "full"
    return pat


def _attn_leaves(cfg: ModelConfig, pre: str):
    d, hd, a = cfg.d_model, cfg.head_dim, cfg.attention
    return [(f"{pre}.wq", (d, a.num_heads * hd)),
            (f"{pre}.wk", (d, a.num_kv_heads * hd)),
            (f"{pre}.wv", (d, a.num_kv_heads * hd)),
            (f"{pre}.wo", (a.num_heads * hd, d))]


def _mlp_leaves(cfg: ModelConfig, pre: str):
    d = cfg.d_model
    out = [(f"{pre}.up", (d, cfg.d_ff)), (f"{pre}.down", (cfg.d_ff, d))]
    if cfg.gated_mlp:
        out.append((f"{pre}.gate", (d, cfg.d_ff)))
    return out


def _layer_leaves(cfg: ModelConfig, i: int = 0):
    """(name, shape) of the parameters of the layer at period position
    ``i``, the reference's nesting joined with dots: ``ssm.*`` in place of
    ``attn.*`` on an SSM layer, the cross block's ``lnc``, ``cross.*`` and
    0-d ``cross_gate`` after the self-attention on a cross layer, and
    ``moe.*`` in place of ``ffn.*`` on an MoE layer."""
    d = cfg.d_model
    kind = cfg.layer_kind(i)
    if kind == "rwkv":
        return ([("ln1", (d,))]
                + [(f"tmix.{n}", s) for n, s in rwkv_mod.rwkv_leaves(cfg)]
                + [("ln2", (d,))])
    out = [("ln1", (d,))]
    if kind == "ssm":
        out += [(f"ssm.{n}", s) for n, s in ssm_mod.ssm_leaves(cfg)]
    else:
        out += _attn_leaves(cfg, "attn")
    if kind == "cross":
        out += ([("lnc", (d,))] + _attn_leaves(cfg, "cross")
                + [("cross_gate", ())])
    out.append(("ln2", (d,)))
    if cfg._is_moe_layer(i):
        return out + [(f"moe.{n}", s) for n, s in moe_mod.moe_leaves(cfg)]
    return out + _mlp_leaves(cfg, "ffn")


def _fp32_leaf(name: str) -> bool:
    """A leaf kept in fp32 in any model: RWKV6's, the MoE router, the
    SSM's and the cross gate."""
    short = name.rsplit(".", 1)[-1]
    return ((".tmix." in name and short in rwkv_mod.FP32_LEAVES)
            or (".moe." in name and short in moe_mod.FP32_LEAVES)
            or (".ssm." in name and short in ssm_mod.FP32_LEAVES)
            or short == "cross_gate")


def param_layout(cfg: ModelConfig) -> ParamLayout:
    """The model's leaves: ``embed``, ``blocks.{i}.<layer leaf>`` stacked
    ``[n_periods, ...]`` for each period position ``i``, ``final_norm``,
    ``lm_head`` unless the embedding is tied, then the vlm's
    ``image_proj`` or the audio encoder's ``encoder.*`` (stacked
    ``[encoder_layers, ...]``), ``enc_norm`` and ``audio_proj``; the fp32
    leaves (``_fp32_leaf``) are the layout's ``fp32``."""
    P = period_length(cfg)
    n_periods = cfg.num_layers // P
    d = cfg.d_model
    leaves = [("embed", (cfg.vocab_size, d))]
    for i in range(P):
        leaves += [(f"blocks.{i}.{name}", (n_periods,) + shape)
                   for name, shape in _layer_leaves(cfg, i)]
    leaves.append(("final_norm", (d,)))
    if not cfg.tie_embeddings:
        leaves.append(("lm_head", (d, cfg.vocab_size)))
    if cfg.family == "vlm":
        leaves.append(("image_proj", (d, d)))
    if cfg.family == "audio":
        enc = ([("ln1", (d,))] + _attn_leaves(cfg, "attn") + [("ln2", (d,))]
               + _mlp_leaves(cfg, "ffn"))
        leaves += [(f"encoder.{name}", (cfg.encoder_layers,) + shape)
                   for name, shape in enc]
        leaves += [("enc_norm", (d,)), ("audio_proj", (d, d))]
    fp32 = frozenset(name for name, _ in leaves if _fp32_leaf(name))
    return ParamLayout(tuple(leaves), fp32)


def init_leaves(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """One model's named leaves on the generator's device, each in its
    dtype (``cfg.dtype``; fp32 for the layout's ``fp32`` leaves): the
    reference's init laws (embedding N(0, 0.02^2), dense N(0, 1/d_in),
    norms zero, the cross gate 2.0 for audio and 0.0 for the vlm, RWKV's,
    MoE's and the SSM's as their modules' ``init_leaf``), drawn from
    ``gen`` (other numbers than ``jax.random``'s)."""
    dt = dtype_of(cfg)
    dev = gen.device
    stacked = {".tmix.": rwkv_mod, ".moe.": moe_mod, ".ssm.": ssm_mod}
    out = {}
    for name, shape in param_layout(cfg).leaves:
        short = name.rsplit(".", 1)[-1]
        mod = next((m for k, m in stacked.items() if k in name), None)
        if name == "embed":
            leaf = (torch.randn(shape, generator=gen, device=dev)
                    * 0.02).to(dt)
        elif short in ("ln1", "ln2", "lnc", "final_norm", "enc_norm"):
            leaf = torch.zeros(shape, dtype=dt, device=dev)
        elif short == "cross_gate":
            leaf = torch.full(shape, 2.0 if cfg.family == "audio" else 0.0,
                              dtype=torch.float32, device=dev)
        elif name in ("lm_head", "image_proj", "audio_proj"):
            leaf = init_dense(gen, *shape, dt)
        elif mod is not None:                   # [n_periods, ...]
            leaf = torch.stack([mod.init_leaf(gen, short, shape[1:], dt)
                                for _ in range(shape[0])])
        else:                                   # [layers, d_in, d_out]
            leaf = torch.stack([init_dense(gen, *shape[1:], dt)
                                for _ in range(shape[0])])
        out[name] = leaf
    return out


def init_params(gen: torch.Generator, cfg: ModelConfig):
    """One model's flat params ``[n]`` in ``cfg.dtype`` on the generator's
    device (``init_leaves`` in layout order), for the round engine; for a
    layout with fp32 leaves in a narrower model, the ``Groups`` of its
    ``cfg.dtype`` and fp32 buffers (``ParamLayout.pack``)."""
    return param_layout(cfg).pack(init_leaves(gen, cfg), device=gen.device,
                                  dtype=dtype_of(cfg))


# ---------------------------------------------------------------------------
# Forward (train / prefill)
# ---------------------------------------------------------------------------


def _rows(x: torch.Tensor) -> torch.Tensor:
    """``x [G, b, T, d]`` (or ``[G, N, d]``) as ``[G, b * T, d]``, the
    rows of every product."""
    return x.reshape(x.shape[0], math.prod(x.shape[1:-1]), x.shape[-1])


def _self_attn_block(p: Params, x, cfg: ModelConfig, kind: str, b: int,
                     positions, backend=None, seq=None):
    """``x [G, b, T, d]`` or ``[G, b*T, d]`` (G models); ``p`` leaves
    ``[G, ...]``. The norm runs on ``x`` as it is, the products on its
    rows, and the result keeps ``x``'s shape. ``seq``: a sequence axis
    (``pool.SequenceAxis``) whose rank holds this chunk of each sequence:
    K and V are all-gathered after rope up to the chunk's end, and the
    chunk's queries attend them at their absolute offset (the flash
    kernels' causal-offset route)."""
    a = cfg.attention
    hd = cfg.head_dim
    h = _rows(rms_norm(x, p["ln1"], cfg.norm_eps))
    G, N, _ = h.shape
    t = N // b
    q = (h @ p["attn.wq"]).reshape(G * b, t, a.num_heads, hd)
    k = (h @ p["attn.wk"]).reshape(G * b, t, a.num_kv_heads, hd)
    v = (h @ p["attn.wv"]).reshape(G * b, t, a.num_kv_heads, hd)
    cos, sin = rope_angles(positions, hd, a.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    q_offset = 0
    if seq is not None:
        k, v = seq.gather_prefix(k), seq.gather_prefix(v)
        q_offset = seq.offset(t)
    o = attention(q, k, v, kind=kind, window=a.window,
                  logit_softcap=a.logit_softcap, q_offset=q_offset,
                  backend=backend)
    return x + (o.reshape(G, N, -1) @ p["attn.wo"]).reshape(x.shape)


def _ffn_block(p: Params, x, cfg: ModelConfig, rows: Optional[int] = None,
               seq=None):
    """``x + ffn(norm(x))`` and the MoE balance loss: ``x [G, rows, T,
    d]`` (or ``[G, rows * T, d]``) with leaves ``[G, ...]`` (the forward;
    aux ``[G]``), or ``rows`` None: ``x [b, T, d]`` with one model's leaves
    (decode; aux 0-d). An MoE layer dispatches each of its ``rows`` batch
    rows as one group, under a sequence axis ``seq`` the whole row across
    the ranks (``moe.moe_apply_models``)."""
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    if rows:
        h = _rows(h)
    if "moe.router" not in p:
        ffn = {"up": p["ffn.up"], "down": p["ffn.down"]}
        if cfg.gated_mlp:
            ffn["gate"] = p["ffn.gate"]
        aux = torch.zeros(x.shape[:1] if rows else (), dtype=torch.float32,
                          device=x.device)
        return x + mlp_apply(ffn, h, cfg.gated_mlp).reshape(x.shape), aux
    names = [n for n, _ in moe_mod.moe_leaves(cfg)]
    if rows is None:
        out, aux = moe_mod.moe_apply({n: p[f"moe.{n}"] for n in names}, h,
                                     cfg)
        return x + out, aux
    G, N, d = h.shape
    out, aux = moe_mod.moe_apply_models(
        [{n: p[f"moe.{n}"][g] for n in names} for g in range(G)],
        h.reshape(G, rows, N // rows, d), cfg, seq)
    return x + out.reshape(x.shape), aux


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


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted dtype, as ``jnp`` promotes ``fp32 @
    bf16`` to fp32 (torch raises on mixed dtypes)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def _fold(p: Params, names, lead_of: str) -> Tuple[Params, int]:
    """The leaves ``names`` of ``p`` with their leading model axes (those
    of ``p[lead_of]`` beyond its own two) folded into one axis G."""
    n = p[lead_of].dim() - 2
    G = math.prod(p[lead_of].shape[:n])
    return {k: p[k].reshape((G,) + p[k].shape[n:]) for k in names}, G


def _ssm_block(p: Params, x, cfg: ModelConfig, state=None, seq=None):
    """``x + mamba(norm(x))`` for ``x [*L, b, T, d]`` and layer leaves
    ``[*L, ...]`` (one model: no ``L``); returns ``(x, new_state)``.
    ``seq``: a sequence axis whose rank holds this chunk
    (``ssm.ssm_apply``)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    ssm = {n: p[f"ssm.{n}"] for n, _ in ssm_mod.ssm_leaves(cfg)}
    o, st = ssm_mod.ssm_apply(ssm, h, cfg, state=state, seq=seq)
    return x + o, st


def _cross_block(p: Params, x, cfg: ModelConfig, memory):
    """The gated cross-attention block of G models (leaves ``[*L, ...]``;
    one model: no ``L``): ``x`` (``[*L, b, T, d]``, or one model's ``[b,
    T, d]``) against ``memory [*L, b, M, d]`` (projected or encoded), the
    models folded into the batch of one ``cross_attention``; ``k`` and
    ``v`` in the promoted dtype, the output cast back to ``x.dtype``."""
    a = cfg.attention
    hd = cfg.head_dim
    names = ("lnc", "cross.wq", "cross.wk", "cross.wv", "cross.wo",
             "cross_gate")
    q_, G = _fold(p, names, "cross.wq")
    b, m, d = memory.shape[-3:]
    xg = _rows(x.reshape((G,) + x.shape[-3:]))
    t = xg.shape[1] // b
    h = rms_norm(xg, q_["lnc"], cfg.norm_eps)
    q = (h @ q_["cross.wq"]).reshape(G * b, t, a.num_heads, hd)
    mem = memory.reshape(G, b * m, d)
    k = _mm(mem, q_["cross.wk"]).reshape(G * b, m, a.num_kv_heads, hd)
    v = _mm(mem, q_["cross.wv"]).reshape(G * b, m, a.num_kv_heads, hd)
    o = cross_attention(q, k, v)
    gate = torch.tanh(q_["cross_gate"]).to(x.dtype).reshape(G, 1, 1)
    return (xg + gate * (o.reshape(G, b * t, -1) @ q_["cross.wo"])
            ).reshape(x.shape)


def _encode_audio(params: Params, cfg: ModelConfig, frames, backend=None):
    """The audio encoder of G models (leaves ``[*L, ...]``) over ``frames
    [*L, b, F, d]``: ``audio_proj``, then ``encoder_layers`` of causal
    self-attention and MLP, then ``enc_norm``, each layer's weights
    promoted to the frames' dtype (fp32 frames: the whole encoder in fp32,
    its attention through the fp32 flash kernel, one launch a layer for
    all G models)."""
    names = ["audio_proj", "enc_norm"] + [k for k in params
                                          if k.startswith("encoder.")]
    p, G = _fold(params, names, "audio_proj")
    b, f, d = frames.shape[-3:]
    x = _mm(frames.reshape(G, b * f, d), p["audio_proj"])
    positions = torch.arange(f, device=x.device)
    for layer in range(cfg.encoder_layers):
        lp = {k[len("encoder."):]: p[k][:, layer].to(
            torch.promote_types(p[k].dtype, x.dtype))
            for k in names[2:]}
        x = _self_attn_block(lp, x, cfg, "full", b, positions, backend)
        ffn = {n[len("ffn."):]: v for n, v in lp.items()
               if n.startswith("ffn.")}
        x = x + mlp_apply(ffn, rms_norm(x, lp["ln2"], cfg.norm_eps),
                          cfg.gated_mlp)
    return rms_norm(x, p["enc_norm"], cfg.norm_eps).reshape(frames.shape[:-3]
                                                            + (b, f, d))


def _memory(params: Params, cfg: ModelConfig, memory, backend=None):
    """The memory the cross layers attend, ``[*L, b, M, d]`` for G models
    (leaves ``[*L, ...]``; one model: ``[b, M, d]``): the vlm's image
    tokens through ``image_proj``, the audio frames through the encoder;
    None for the other families."""
    if cfg.family not in ("vlm", "audio"):
        return None
    if memory is None:
        raise ValueError(f"the {cfg.family} family attends memory: pass "
                         f"memory [b, M, d_model]")
    if cfg.family == "audio":
        return _encode_audio(params, cfg, memory, backend)
    p, G = _fold(params, ["image_proj"], "image_proj")
    b, m, d = memory.shape[-3:]
    return _mm(memory.reshape(G, b * m, d), p["image_proj"]).reshape(
        memory.shape)


def _rwkv_layer(params: Params, cfg: ModelConfig, i: int, layer: int):
    """Period position ``i``, period ``layer``: ``(ln1, ln2, tmix)``, the
    time- and channel-mix leaves by their reference names."""
    pre = f"blocks.{i}."
    tmix = {name: params[pre + "tmix." + name][layer]
            for name, _ in rwkv_mod.rwkv_leaves(cfg)}
    return params[pre + "ln1"][layer], params[pre + "ln2"][layer], tmix


def _rwkv_hidden(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                 backend=None, seq=None) -> torch.Tensor:
    """The RWKV6 stack of G models (leaves ``[*L, ...]``, ``G = prod(L)``)
    over ``tokens [*L, b, T]`` -> the final normed hidden states ``[*L, b,
    T, d]``: each product one batched matmul over the models, one WKV6
    call per layer with the models folded into its head axis (two under a
    sequence axis ``seq``: the chunk's state from zero, then its outputs
    from the state carried in; ``models/rwkv.py``)."""
    p, G = _models(params, tokens)
    b, t = tokens.shape[-2:]
    tok = tokens.reshape(G, b, t).long()
    rows = torch.arange(G, device=tok.device)[:, None, None]
    x = p["embed"][rows, tok].to(dtype_of(cfg))           # [G, b, T, d]
    P = period_length(cfg)
    names = ["ln1", "ln2"] + [f"tmix.{name}"
                              for name, _ in rwkv_mod.rwkv_leaves(cfg)]
    # each stacked leaf split into its layers once: one gradient assembly
    # a leaf, where indexing it layer by layer would give every layer a
    # full-size zero gradient of the stack
    layers = [{name: p[f"blocks.{i}.{name}"].unbind(1) for name in names}
              for i in range(P)]
    for layer in range(cfg.num_layers // P):
        x = maybe_constrain(x)
        for i in range(P):
            lp = {name: v[layer] for name, v in layers[i].items()}
            tmix = {name[len("tmix."):]: v for name, v in lp.items()
                    if name.startswith("tmix.")}
            h, _ = rwkv_mod.rwkv_time_mix(
                tmix, rms_norm(x, lp["ln1"], cfg.norm_eps), cfg,
                backend=backend, seq=seq)
            x = x + h
            h, _ = rwkv_mod.rwkv_channel_mix(
                tmix, rms_norm(x, lp["ln2"], cfg.norm_eps), seq=seq)
            x = x + h
        x = maybe_constrain(x)
    x = rms_norm(x, p["final_norm"], cfg.norm_eps)
    return x.reshape(tokens.shape + (cfg.d_model,))


def _sequence_split_ok(cfg: ModelConfig) -> None:
    """Raise unless ``cfg`` is a family whose forward splits its sequences
    over a sequence axis: every family but the vlm and audio ones."""
    if cfg.family in ("vlm", "audio"):
        raise ValueError(
            f"sequence-parallel activations (run_sharded_2d's "
            f"activation_spec) do not cover the {cfg.family} family "
            f"({cfg.name}): its cross layers attend a memory that the LM "
            f"sweep does not give, in this package or in the reference "
            f"(whose LM task calls the forward without memory_shape)")


def hidden_forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                   *, memory=None, backend=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``params`` leaves ``[*L, ...]``, ``tokens [*L, b, T]`` -> ``(the
    final normed hidden states [*L, b, T, d], aux [*L])``, the LM head not
    applied; aux is the MoE balance loss summed over layers, zero without
    MoE layers.
    ``memory``: ``[*L, b, M, d]`` image tokens (vlm) or audio frames
    (audio). ``backend``: ``None`` (the kernels for CUDA tensors) or
    ``"torch"`` (the plain versions on any device), see
    ``repro_torch.kernels.dispatch``.

    Under a sequence axis (``specs.sequence_axis``; the sharded sweep's
    ``pool.SequenceAxis``) ``tokens`` is this rank's chunk of each
    sequence: its positions start at the chunk's offset, each attention
    block all-gathers K and V (``_self_attn_block``), RWKV6's token shifts
    and WKV6 state, the Mamba conv's context and scan state come from the
    earlier ranks, and each MoE layer routes the whole row across the
    ranks; the rest is local. The vlm and audio families raise
    (``_sequence_split_ok``)."""
    seq = sequence_axis()
    if seq is not None:
        _sequence_split_ok(cfg)
    if cfg.family == "ssm":
        return (_rwkv_hidden(params, cfg, tokens, backend, seq),
                torch.zeros(tokens.shape[:-2], dtype=torch.float32,
                            device=tokens.device))
    if memory is not None and memory.shape[:-2] != tokens.shape[:-1]:
        raise ValueError(f"memory {tuple(memory.shape)} vs tokens "
                         f"{tuple(tokens.shape)}: memory is [*L, b, M, d]")
    P = period_length(cfg)
    n_periods = cfg.num_layers // P
    memory = _memory(params, cfg, memory, backend)
    p, G = _models(params, tokens)
    b, t = tokens.shape[-2:]
    tok = tokens.reshape(G, b, t).long()
    rows = torch.arange(G, device=tok.device)[:, None, None]
    x = p["embed"][rows, tok].to(dtype_of(cfg))          # [G, b, T, d]
    positions = torch.arange(t, device=tok.device)
    if seq is not None:
        positions = positions + seq.offset(t)
    aux = torch.zeros(G, dtype=torch.float32, device=tok.device)
    for layer in range(n_periods):
        # the residual [G, b, T, d] keeps b and T apart, so that a mesh's
        # sequence-parallel spec can place each (maybe_constrain)
        x = maybe_constrain(x)
        for i in range(P):
            lp = {name: p[f"blocks.{i}.{name}"][:, layer]
                  for name, _ in _layer_leaves(cfg, i)}
            kind = cfg.layer_kind(i)
            if kind == "ssm":
                x = _ssm_block(lp, x, cfg, seq=seq)[0]
            else:
                x = _self_attn_block(lp, x, cfg, attn_kind(cfg, i), b,
                                     positions, backend, seq)
            if kind == "cross":
                x = _cross_block(lp, x, cfg, memory)
            x, a = _ffn_block(lp, x, cfg, b, seq)
            aux = aux + a
        x = maybe_constrain(x)
    x = rms_norm(x, p["final_norm"], cfg.norm_eps)
    lead = tokens.shape[:-2]
    return x.reshape(tokens.shape + (cfg.d_model,)), aux.reshape(lead)


def _head(params: Params, cfg: ModelConfig) -> torch.Tensor:
    """``[*L, d, V]``: the tied embedding's transpose, or ``lm_head``."""
    if "lm_head" in params:
        return params["lm_head"]
    return params["embed"].transpose(-1, -2)


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            memory=None, backend=None):
    """tokens ``[*L, b, T]`` -> ``(logits [*L, b, T, V] fp32, aux [*L])``
    (aux, the MoE balance loss summed over layers, is zero without MoE
    layers; ``memory`` as in ``hidden_forward``; the train/prefill
    entry)."""
    hidden, aux = hidden_forward(params, cfg, tokens, memory=memory,
                                 backend=backend)
    G = math.prod(tokens.shape[:-2])
    h = hidden.reshape(G, -1, cfg.d_model)
    logits = h @ _head(params, cfg).reshape(G, cfg.d_model, -1)
    logits = softcap(logits.float(), cfg.final_softcap)
    return logits.reshape(tokens.shape + (-1,)), aux


def _chunk_ce(h, y, head, cap: float):
    """Summed cross-entropy of one token chunk per model: ``h [G, N, d]``,
    ``y [G, N]``, ``head [G, d, V]`` -> ``[G]``."""
    logits = softcap((h @ head).float(), cap)
    lse = torch.logsumexp(logits, -1, keepdim=True)
    # [G, N, 1] until the difference: on a mesh the gather of vocab-sharded
    # logits is a masked partial, which DTensor reduces at its own shape
    gold = logits.gather(-1, y.unsqueeze(-1))
    return (lse - gold).sum((-2, -1))


def loss_fn(params: Params, cfg: ModelConfig, batch, *,
            ce_chunk: int = 512, backend=None) -> torch.Tensor:
    """``batch``: ``{"tokens", "labels"}``, each ``[*L, b, T]``, and for the
    vlm and audio families ``"memory" [*L, b, M, d]`` -> the per-model
    mean next-token cross-entropy ``[*L]``, plus ``0.01 * aux`` (the MoE
    balance loss) for a model with MoE layers, as the reference adds it
    (without them aux is zero and nothing is added).

    The cross-entropy runs over token chunks of ``ce_chunk`` under
    activation checkpointing (the reference's ``jax.checkpoint``), so only
    one ``[G, b, ce_chunk, V]`` chunk of logits is live at a time. When
    ``ce_chunk`` does not divide ``T`` the whole sequence is one chunk, as
    in the reference's padded branch.
    """
    _known(cfg)
    tokens, labels = batch["tokens"], batch["labels"]
    hidden, aux = hidden_forward(params, cfg, tokens,
                                 memory=batch.get("memory"), backend=backend)
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
    else:
        tot = torch.zeros(G, dtype=torch.float32, device=tokens.device)
        for s in range(0, t, ce_chunk):
            h = hidden[:, :, s:s + ce_chunk].reshape(G, -1, d)
            y = labels[:, :, s:s + ce_chunk].reshape(G, -1)
            tot = tot + checkpoint(_chunk_ce, h, y, head, cfg.final_softcap,
                                   use_reentrant=False)
        ce = tot / (b * t)
    if cfg.moe:
        ce = ce + 0.01 * aux.reshape(G)
    return ce.reshape(lead)


def make_loss(cfg: ModelConfig, backend=None):
    """The round engine's loss: ``(flat [*L, n] or its Groups, batch) ->
    [*L]``; ``backend="torch"`` runs the plain attention and WKV6 on the
    card."""
    _known(cfg)
    layout = param_layout(cfg)

    def loss(flat: torch.Tensor, batch) -> torch.Tensor:
        return loss_fn(layout.unflatten(flat), cfg, batch,
                       backend=backend)

    return loss


# ---------------------------------------------------------------------------
# Decode (serve path)
# ---------------------------------------------------------------------------


def make_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> Tuple[Dict[str, torch.Tensor], ...]:
    """Cache matching the period structure (leading axis ``n_periods``),
    zero, per period position: the dense family's ``k`` / ``v
    [n_periods, batch, eff, KV, hd]`` in ``cfg.dtype``, ``eff = max_len``
    or, for swa and chunked layers, the ring buffer's ``min(max_len,
    window)``, also for the self-attention of a cross layer; an SSM
    layer's ``conv [n_periods, batch, cw - 1, di]`` in ``cfg.dtype`` and
    ``h [n_periods, batch, di, N]`` fp32; RWKV6's ``s [n_periods, batch, H,
    D, D]`` fp32 state and the token-shift carries ``last`` / ``clast
    [n_periods, batch, 1, d]`` in ``cfg.dtype`` (the SSM and RWKV states do
    not grow with ``max_len``)."""
    P = period_length(cfg)
    n_periods = cfg.num_layers // P
    dt = dtype_of(cfg)
    if cfg.family == "ssm":
        hd = cfg.rwkv.head_dim
        nh = cfg.d_model // hd

        def carry():
            return torch.zeros(n_periods, batch, 1, cfg.d_model, dtype=dt,
                               device=device)

        return tuple({"s": torch.zeros(n_periods, batch, nh, hd, hd,
                                       dtype=torch.float32, device=device),
                      "last": carry(), "clast": carry()} for _ in range(P))
    a = cfg.attention

    def kv(i):
        eff = max_len
        if attn_kind(cfg, i) in ("swa", "chunked"):
            eff = min(max_len, a.window)
        return torch.zeros(n_periods, batch, eff, a.num_kv_heads,
                           cfg.head_dim, dtype=dt, device=device)

    def layer(i):
        if cfg.layer_kind(i) == "ssm":
            st = ssm_mod.ssm_init_state(cfg, batch, device)
            return {k: v.expand((n_periods,) + v.shape).contiguous()
                    for k, v in st.items()}
        return {"k": kv(i), "v": kv(i)}

    return tuple(layer(i) for i in range(P))


def _decode_attn_layer(p: Params, x, cfg: ModelConfig, kind: str, k_cache,
                       v_cache, pos):
    """One token's self-attention against one layer's cache ``[b, S, KV,
    hd]`` (``pos`` a 0-d int64 tensor, the tokens already in it) -> ``(x,
    k_cache', v_cache')``, the caches given unchanged. Windowed layers
    write slot ``pos % S`` of their ring and attend it rolled into
    chronological order; full layers write ``min(pos, S - 1)``."""
    a = cfg.attention
    hd = cfg.head_dim
    b = x.shape[0]
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    q = (h @ p["attn.wq"]).reshape(b, 1, a.num_heads, hd)
    k = (h @ p["attn.wk"]).reshape(b, 1, a.num_kv_heads, hd)
    v = (h @ p["attn.wv"]).reshape(b, 1, a.num_kv_heads, hd)
    cos, sin = rope_angles(pos[None], hd, a.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    s_max = k_cache.shape[1]
    windowed = kind in ("swa", "chunked")
    slot = pos % s_max if windowed else pos.clamp_max(s_max - 1)
    ck = k_cache.index_copy(1, slot[None], k)
    cv = v_cache.index_copy(1, slot[None], v)
    if windowed:
        # the ring, oldest first: once full, the oldest entry is at slot+1;
        # chunked attends only the current block's (pos % window) + 1
        eff_len = (pos + 1).clamp_max(s_max)
        shift = torch.where(pos + 1 >= s_max, -(slot + 1),
                            torch.zeros_like(slot))
        keep = (pos % a.window) + 1 if kind == "chunked" else eff_len
        keep = torch.minimum(keep, eff_len)
        # torch.roll by (shift - drop): element i comes from i - that
        order = (torch.arange(s_max, device=pos.device)
                 - (shift - (eff_len - keep))) % s_max
        o = decode_attention(q, ck.index_select(1, order),
                             cv.index_select(1, order), keep, kind="full",
                             logit_softcap=a.logit_softcap)
    else:
        o = decode_attention(q, ck, cv, pos + 1, kind=kind, window=a.window,
                             logit_softcap=a.logit_softcap)
    return x + o.reshape(b, 1, -1) @ p["attn.wo"], ck, cv


def _decode_layers(params: Params, cfg: ModelConfig, x, cache, pos,
                   memory):
    """One token through every layer but RWKV6's: an attention layer's KV
    cache, an SSM layer's carry, a cross layer's KV cache and then its
    cross block against ``memory``. Returns ``(x, per-layer cache parts)``."""
    pos = torch.as_tensor(pos, dtype=torch.long, device=x.device)
    P = period_length(cfg)
    new = [{k: [] for k in c} for c in cache]
    for layer in range(cfg.num_layers // P):
        for i in range(P):
            lp = {name: params[f"blocks.{i}.{name}"][layer]
                  for name, _ in _layer_leaves(cfg, i)}
            c = {k: v[layer] for k, v in cache[i].items()}
            kind = cfg.layer_kind(i)
            if kind == "ssm":
                x, c = _ssm_block(lp, x, cfg, state=c)
            else:
                x, ck, cv = _decode_attn_layer(lp, x, cfg, attn_kind(cfg, i),
                                               c["k"], c["v"], pos)
                c = {"k": ck, "v": cv}
            if kind == "cross":
                x = _cross_block(lp, x, cfg, memory)
            x, _ = _ffn_block(lp, x, cfg)
            for k, v in c.items():
                new[i][k].append(v)
    return x, new


def decode_step(params: Params, cfg: ModelConfig, token: torch.Tensor,
                cache, pos, *, memory=None, backend=None):
    """``token [B, 1]`` int; ``cache`` from ``make_cache``; ``pos`` (an int
    or a 0-d tensor) the tokens already in the cache (the RWKV and SSM
    states carry it); ``memory [B, M, d]`` for the vlm and audio families.
    Returns ``(logits [B, 1, V] fp32, new_cache)``; the cache given is not
    changed. Attention layers run the plain ``decode_attention`` (no kernel
    launch, as the reference calls none there; an MoE layer routes each
    row's one token, so at capacity 1 an expert is never over-full), SSM
    layers the Mamba step at T = 1 and cross layers the plain
    ``cross_attention``; as in the reference the memory is projected
    (vlm) or encoded (audio: one flash launch per encoder layer) again at
    every step; RWKV6 one WKV6 launch per layer at T = 1 (``backend`` as
    in ``forward``)."""
    _known(cfg)
    x = params["embed"][token.long()].to(dtype_of(cfg))
    if cfg.family != "ssm":
        memory = _memory(params, cfg, memory, backend)
        x, new = _decode_layers(params, cfg, x, cache, pos, memory)
        return _decode_logits(params, cfg, x), _stacked(new)
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
    return _decode_logits(params, cfg, x), _stacked(new)


def _decode_logits(params: Params, cfg: ModelConfig, x) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return softcap((x @ _head(params, cfg)).float(), cfg.final_softcap)


def _stacked(new):
    """Per-layer cache parts -> the cache, each leaf ``[n_periods, ...]``."""
    return tuple({k: torch.stack(v) for k, v in c.items()} for c in new)

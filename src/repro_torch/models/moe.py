"""Mixture-of-Experts FFN with top-k routing (port of ``repro.models.moe``).

Two dispatch strategies (``MoEConfig.dispatch``), as in the reference:

- ``einsum`` — GShard/Switch-style one-hot capacity dispatch: the
  dispatch and combine tensors ``[B, T, E, C]`` and their products run in
  fp32, the experts in the model dtype;
- ``scatter`` — tokens are routed into the ``[B, E, C, d]`` buffers with
  one scatter-add and combined with one gather.

Both are dropless up to the capacity factor; overflow tokens fall back to
the residual stream (their gate set to 0). Each batch row is its own
dispatch group with its own capacity (the reference's ``vmap`` over rows),
computed here batched over ``B``: a token's slot in its expert's buffer is
the running count of that expert's picks in token-major, then
choice-major order within the row.

The reference has no Pallas kernel here: routing and the expert products
are ``jnp`` einsums, so in the port they are plain torch (the expert
products batched matmuls over the experts).

Under a sequence split (``seq``, a ``sharding.pool.SequenceAxis``; the
sharded LM sweep's ``activation_spec=P(None, "model", None)``) a rank holds
one chunk of every row, and the row stays one dispatch group over all its
``T`` tokens: the capacity comes from the whole ``T``, each (token,
choice)'s slot is offset by the earlier ranks' counts of its expert in the
row (an exclusive prefix of the all-gathered ``[ranks, G, b, E]`` counts,
without a gradient), and the balance loss's means run over the whole row
(``seq.all_sum`` of the probability sums; the counts summed from the same
gather). ``moe_apply_models`` makes one exchange of each kind for all its
models.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dtype_of, init_dense, mlp_apply

# the leaves an MoE layer keeps in fp32 in a narrower model
FP32_LEAVES = ("router",)


def moe_leaves(cfg: ModelConfig):
    """(name, shape) of one MoE layer's parameters: ``router [d, E]``,
    ``up``/``gate [E, d, f]`` (``gate`` only for a gated MLP), ``down
    [E, f, d]``."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    out = [("router", (d, e)), ("up", (e, d, f)), ("down", (e, f, d))]
    if cfg.gated_mlp:
        out.append(("gate", (e, d, f)))
    return out


def init_leaf(gen: torch.Generator, name: str, shape, dtype) -> torch.Tensor:
    """One MoE leaf by the reference's laws (router N(0, 1/d) in fp32;
    experts N(0, 1/d_in) in ``dtype``), drawn one expert at a time into a
    preallocated tensor, so a full-width layer never holds an fp32 copy of
    all its experts."""
    if name == "router":
        return init_dense(gen, *shape, torch.float32)
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    for e in range(shape[0]):
        out[e] = init_dense(gen, *shape[1:], dtype)
    return out


def moe_init(gen: torch.Generator, cfg: ModelConfig
             ) -> Dict[str, torch.Tensor]:
    """One MoE layer's leaves (``moe_leaves``) in ``cfg.dtype``, the
    router in fp32 (other numbers than the reference's ``jax.random``)."""
    dt = dtype_of(cfg)
    return {name: init_leaf(gen, name, shape, dt)
            for name, shape in moe_leaves(cfg)}


def _router(p, x: torch.Tensor, cfg: ModelConfig):
    """``x [B, T, d]`` -> top-k expert ids and renormalised gates ``[B, T,
    k]``, and the balance loss's inputs: the router's probabilities ``[B,
    T, E]`` and each row's count of picks by expert ``[B, E]`` (fp32)."""
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    logits = x.float() @ p["router"]
    probs = torch.softmax(logits, -1)
    gates, idx = torch.topk(probs, k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    counts = torch.zeros(x.shape[0], e, dtype=torch.float32,
                         device=x.device)
    counts.scatter_add_(1, idx.reshape(x.shape[0], -1),
                        torch.ones_like(idx, dtype=torch.float32).reshape(
                            x.shape[0], -1))
    return idx, gates, (probs, counts)


def _balance(me: torch.Tensor, counts: torch.Tensor, t: int,
             cfg: ModelConfig) -> torch.Tensor:
    """Each row's Switch load-balance loss ``E * sum_e f_e P_e`` ``[..., B]``
    from the mean probabilities ``me`` and the pick counts ``[..., B, E]``
    of rows of ``t`` tokens."""
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    return e * (me * (counts / (t * k))).sum(-1)


def _capacity(cfg: ModelConfig, t: int) -> int:
    m = cfg.moe
    return max(1, int(m.capacity_factor * m.top_k * t / m.num_experts))


def _expert_ffn(p, xe: torch.Tensor, gated: bool) -> torch.Tensor:
    """``xe [B, E, C, d]`` -> ``[B, E, C, d]`` through each expert's
    (gated) MLP: one batched matmul over the experts per weight."""
    b, e, c, d = xe.shape
    h = xe.transpose(0, 1).reshape(e, b * c, d)
    ffn = {"up": p["up"], "down": p["down"]}
    if gated:
        ffn["gate"] = p["gate"]
    return mlp_apply(ffn, h, gated).reshape(e, b, c, d).transpose(0, 1)


def slots(idx: torch.Tensor, cfg: ModelConfig, t: int, before=None):
    """Each (token, choice)'s slot in its expert's buffer and whether it
    fits under the capacity of a row of ``t`` tokens: ``idx [B, T, k]`` ->
    ``(pos [B, T, k] float, keep [B, T, k] bool, onehot [B, T, k, E])``.
    The slot is the row's running count of that expert's picks,
    token-major then choice-major (a cumsum over ``[T * k, E]``), after
    ``before [B, E]``, the picks of the row's earlier tokens held elsewhere
    (a sequence split's earlier ranks; None: none)."""
    b, _, k = idx.shape
    e = cfg.moe.num_experts
    onehot = F.one_hot(idx, e).float()                        # [B, T, k, E]
    pos = torch.cumsum(onehot.reshape(b, -1, e), 1)
    if before is not None:
        pos = pos + before[:, None]
    pos = ((pos.reshape(onehot.shape) - 1.0) * onehot).sum(-1)  # [B, T, k]
    return pos, pos < _capacity(cfg, t), onehot


def _dispatch(p, x: torch.Tensor, cfg: ModelConfig, idx, gates, pos, keep,
              onehot, cap: int) -> torch.Tensor:
    """``x [B, T, d]`` through the experts its routing picked (slots
    ``pos`` under capacity ``cap``; overflow gates zero) -> ``[B, T, d]``
    in x.dtype."""
    b, t, d = x.shape
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    gates = gates * keep
    if cfg.moe.dispatch == "einsum":
        poh = F.one_hot(pos.long().clamp_max(cap - 1), cap).float() \
            * keep[..., None]                                 # [B, T, k, C]
        disp = torch.einsum("btke,btkc->btec", onehot, poh)
        comb = torch.einsum("btke,btkc->btec", onehot * gates[..., None],
                            poh)
        xe = torch.einsum("btec,btd->becd", disp, x.float()).to(x.dtype)
        ye = _expert_ffn(p, xe, cfg.gated_mlp)
        out = torch.einsum("btec,becd->btd", comb, ye.float())
    elif cfg.moe.dispatch == "scatter":
        flat = idx * cap + pos.long()                         # [B, T, k]
        flat = flat.reshape(b, t * k)
        safe = torch.where(keep.reshape(b, -1), flat, e * cap)  # overflow row
        xk = x.float().repeat_interleave(k, dim=1)            # [B, T*k, d]
        buf = torch.zeros(b, e * cap + 1, d, dtype=torch.float32,
                          device=x.device)
        buf.scatter_add_(1, safe[..., None].expand(-1, -1, d), xk)
        xe = buf[:, :e * cap].reshape(b, e, cap, d).to(x.dtype)
        ye = _expert_ffn(p, xe, cfg.gated_mlp).reshape(b, e * cap, d)
        yk = ye.gather(1, flat.clamp(0, e * cap - 1)[..., None].expand(
            -1, -1, d))
        yk = yk.float() * gates.reshape(b, -1, 1)
        out = yk.reshape(b, t, k, d).sum(2)
    else:
        raise ValueError(f"unknown MoE dispatch {cfg.moe.dispatch!r}")
    return out.to(x.dtype)


def moe_apply_models(ps, x: torch.Tensor, cfg: ModelConfig, seq=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``G`` models' MoE layers (``ps``: one leaf dict a model) on ``x [G,
    B, T, d]`` -> ``(out [G, B, T, d] in x.dtype, aux [G])``, each aux the
    batch mean of that model's rows' load-balance losses. ``seq``: a
    sequence axis whose rank holds this chunk of every row (the module
    docstring): one gather of the counts and one ``all_sum`` of the
    probability sums for all ``G`` models."""
    G, b, t, _ = x.shape
    routes = [_router(p, x[g], cfg) for g, p in enumerate(ps)]
    probs = [r[2][0] for r in routes]
    counts = torch.stack([r[2][1] for r in routes])            # [G, B, E]
    if seq is None:
        t_row, before = t, [None] * G
        me = torch.stack([p.mean(1) for p in probs])
    else:
        t_row = t * seq.size
        every = seq.gather_all(counts)                  # [ranks, G, B, E]
        before = every[:seq.index].sum(0)
        counts = every.sum(0)
        me = seq.all_sum(torch.stack([p.sum(1) for p in probs])) / t_row
    aux = _balance(me, counts, t_row, cfg).mean(-1)
    cap = _capacity(cfg, t_row)
    outs = []
    for g, (p, (idx, gates, _)) in enumerate(zip(ps, routes)):
        pos, keep, onehot = slots(idx, cfg, t_row, before[g])
        outs.append(_dispatch(p, x[g], cfg, idx, gates, pos, keep, onehot,
                              cap))
    return torch.stack(outs), aux


def moe_apply(p, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x [B, T, d]`` -> ``(out [B, T, d] in x.dtype, aux)``, aux the
    batch mean of the rows' load-balance losses (a 0-d fp32 tensor)."""
    out, aux = moe_apply_models([p], x[None], cfg)
    return out[0], aux[0]

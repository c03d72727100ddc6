"""Carry weights and state across from the JAX reference.

Inputs are numpy (the reference's arrays after ``np.asarray``), so this
module needs neither JAX nor the reference package:

- ``params_from_jax(np_tree, layout)``: a parameter tree (nested dicts and
  tuples, leaves with any leading axes ``L``) -> the port's flat ``[*L, n]``
  buffer in layout order (``ParamLayout.pack``: for a layout with fp32
  leaves in a narrower dtype, the ``Groups`` of the two buffers, the fp32
  leaves bit for bit); nesting becomes dotted leaf names, so the LM's
  ``blocks`` tuple (one layer dict per period position, each leaf stacked
  ``[n_periods, ...]``) lands on ``blocks.{i}.attn.wq`` and so on;
- ``lm_params_from_jax(np_params, cfg)``: the same for an LM at its
  ``ModelConfig`` (its layout and dtype; the tied embedding is the one
  ``embed`` leaf; a bf16 model with fp32 leaves gives two groups);
- ``lm_leaves_from_jax(np_params, cfg)``: an LM's params as named tensors,
  each in its dtype, for any ported family: the reference's RWKV6 tree
  (``blocks[i]["tmix"][...]``, with the channel mix's leaves inside
  ``tmix``) lands on ``blocks.{i}.tmix.wr`` and so on, and its fp32 leaves
  (``decay_base``, ``bonus_u``, ``ln_x``) stay fp32 in a bf16 model; an MoE
  layer's ``blocks[i]["moe"]`` lands on ``blocks.{i}.moe.router`` (fp32,
  bit for bit) and ``moe.up``/``gate``/``down`` (the model dtype); a Mamba
  layer's ``blocks[i]["ssm"]`` on ``blocks.{i}.ssm.in_proj`` and so on
  (``dt_proj``, ``dt_bias``, ``a_log``, ``d_skip`` fp32, bit for bit); a
  cross layer's ``lnc``, ``cross.*`` and the fp32 ``cross_gate``
  (``[n_periods]``); the vlm's ``image_proj``; the audio encoder's
  ``encoder.*`` (stacked ``[encoder_layers, ...]``), ``enc_norm`` and
  ``audio_proj``;
- ``fed_state_from_jax(np_state, layout, scheme)``: a reference ``FedState``
  (an object with its fields, numpy leaves, leading ``[B]`` axis on every
  leaf, e.g. from a vmapped init) -> the port's ``FedState``, so a test can
  re-sync the port to the reference every round.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.core.algorithms import AlgoState
from repro_torch.core.federated import FedState
from repro_torch.core.params import Groups, ParamLayout, gmap


def flatten_tree(tree, prefix: str = "") -> Dict[str, Any]:
    """Nested dicts / tuples / lists -> ``{dotted.name: leaf}``."""
    if isinstance(tree, Mapping):
        items = tree.items()
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for key, sub in items:
        out.update(flatten_tree(sub, f"{prefix}.{key}" if prefix
                                else str(key)))
    return out


def params_from_jax(np_tree, layout: ParamLayout, device=None,
                    dtype=torch.float32, cast=None):
    """A tree of ``[*L, *shape]`` leaves -> flat ``[*L, n]`` of ``dtype``,
    or the ``Groups`` of a grouped layout (``ParamLayout.pack``; ``cast``
    stores every group in that dtype)."""
    flat = flatten_tree(np_tree)
    first_name, first_shape = layout.leaves[0]
    lead = np.shape(flat[first_name])[:np.ndim(flat[first_name])
                                      - len(first_shape)]
    return layout.pack(flat, lead=tuple(lead), device=device, dtype=dtype,
                       cast=cast)


def lm_params_from_jax(np_params, cfg, device=None):
    """The reference LM's params (``repro.models.model.init_params``,
    numpy leaves) -> the port's flat buffer in ``cfg.dtype`` (two
    ``Groups`` for a bf16 model with fp32 leaves)."""
    from repro_torch.models.layers import dtype_of
    from repro_torch.models.model import param_layout

    return params_from_jax(np_params, param_layout(cfg), device,
                           dtype_of(cfg))


def lm_leaves_from_jax(np_params, cfg, device=None) -> Dict[str, torch.Tensor]:
    """The reference LM's params (numpy leaves) -> the port's named leaves
    (``repro_torch.models.model.Params``), ``cfg.dtype`` but for the
    layout's fp32 leaves, which are carried across bit for bit."""
    from repro_torch.models.layers import dtype_of
    from repro_torch.models.model import param_layout

    return param_layout(cfg).tensors(flatten_tree(np_params), device=device,
                                     dtype=dtype_of(cfg))


def _t(x, device, dtype=None):
    return torch.as_tensor(np.array(x), device=device, dtype=dtype)


def _link_state(link_state, scheme: str, device):
    """The reference's link state -> the port's: bernoulli ``()``; markov
    the ON mask; cyclic ``{"offset"}`` (the reference's extra ``key`` is
    its reset stream, which the port replaces with the engine draw — for a
    reset scheme mid-cycle the caller sets the current cycle's offsets)."""
    if scheme == "bernoulli":
        return ()
    if scheme == "markov":
        return _t(link_state, device, torch.bool)
    if scheme == "cyclic":
        return {"offset": _t(link_state["offset"], device, torch.float32)}
    raise ValueError(scheme)


def fed_state_from_jax(np_state, layout: ParamLayout, scheme: str,
                       device=None, dtype=torch.float32) -> FedState:
    """A reference ``FedState`` with a leading ``[B]`` axis on every leaf ->
    the port's (server, clients, optimizer state incl. the per-client step,
    algorithm state, link state, round — an int, or a ``[B]`` tensor where
    the trajectories stand at different rounds — ``last_active``); the
    parameter buffers in ``dtype`` (the model's). The reference's ``key``
    has no counterpart: the port's randomness is drawn outside."""
    server = params_from_jax(np_state.server, layout, device, dtype)
    clients = params_from_jax(np_state.clients, layout, device, dtype)
    opt = {"step": _t(np_state.opt_state["step"], device, torch.int32)}
    for k, v in np_state.opt_state.items():
        if k != "step":
            opt[k] = params_from_jax(v, layout, device, dtype,
                                     cast=torch.float32)
    a = np_state.algo_state
    B, m = np_state.last_active.shape

    def tree(field, rows, cast):
        leaves = getattr(a, field)
        lead = np.shape(flatten_tree(leaves)[layout.leaves[0][0]])[1]
        if lead == 0:
            empty = [torch.zeros((B, 0, n), dtype=cast or dt, device=device)
                     for n, dt in zip(layout.sizes(dtype),
                                      (dtype, torch.float32))]
            return Groups(empty) if len(empty) > 1 else empty[0]
        return gmap(lambda x: x.reshape(B, rows, -1), params_from_jax(
            leaves, layout, device, dtype, cast=cast))

    algo = AlgoState(
        gap=_t(a.gap, device, torch.float32),
        sum_gaps=_t(a.sum_gaps, device, torch.float32),
        n_gaps=_t(a.n_gaps, device, torch.float32),
        lam=_t(a.lam, device, torch.float32),
        mem=tree("mem", m, None),
        mom=tree("mom", 1, torch.float32))
    rounds = np.asarray(np_state.round).reshape(-1)
    # one round for the batch: an int; trajectories at different rounds
    # (a mixed batch of the adaptive search): a [B] tensor
    rnd = int(rounds[0]) if np.unique(rounds).size == 1 else torch.as_tensor(
        rounds, dtype=torch.long, device=device)
    return FedState(
        server=server, clients=clients, opt_state=opt, algo_state=algo,
        link_state=_link_state(np_state.link_state, scheme, device),
        round=rnd,
        last_active=_t(np_state.last_active, device, torch.int32))

"""Carry weights and state across from the JAX reference.

Inputs are numpy (the reference's arrays after ``np.asarray``), so this
module needs neither JAX nor the reference package:

- ``params_from_jax(np_tree, layout)``: a parameter dict (leaves with any
  leading axes ``L``) -> the port's flat ``[*L, n]`` buffer in layout order;
- ``fed_state_from_jax(np_state, layout, scheme)``: a reference ``FedState``
  (an object with its fields, numpy leaves, leading ``[B]`` axis on every
  leaf, e.g. from a vmapped init) -> the port's ``FedState``, so a test can
  re-sync the port to the reference every round.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.core.algorithms import AlgoState
from repro_torch.core.federated import FedState
from repro_torch.core.params import ParamLayout


def params_from_jax(np_tree: Mapping[str, Any], layout: ParamLayout,
                    device=None) -> torch.Tensor:
    """``{name: [*L, *shape]}`` -> flat fp32 ``[*L, n]``."""
    first_name, first_shape = layout.leaves[0]
    lead = np.shape(np_tree[first_name])[:np.ndim(np_tree[first_name])
                                         - len(first_shape)]
    return layout.flatten(np_tree, lead=tuple(lead), device=device)


def _t(x, device, dtype=None):
    return torch.as_tensor(np.asarray(x), device=device, dtype=dtype)


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
                       device=None) -> FedState:
    """A reference ``FedState`` with a leading ``[B]`` axis on every leaf ->
    the port's (server, clients, optimizer state incl. the per-client step,
    algorithm state, link state, round, ``last_active``). The reference's
    ``key`` has no counterpart: the port's randomness is drawn outside."""
    server = params_from_jax(np_state.server, layout, device)
    clients = params_from_jax(np_state.clients, layout, device)
    opt = {"step": _t(np_state.opt_state["step"], device, torch.int32)}
    for k, v in np_state.opt_state.items():
        if k != "step":
            opt[k] = params_from_jax(v, layout, device)
    a = np_state.algo_state
    B, m = clients.shape[:2]

    def tree(field, rows):
        leaves = getattr(a, field)
        lead = np.shape(leaves[layout.leaves[0][0]])[1]
        if lead == 0:
            return torch.zeros((B, 0, layout.size), device=device)
        return params_from_jax(leaves, layout, device).reshape(B, rows, -1)

    algo = AlgoState(
        gap=_t(a.gap, device, torch.float32),
        sum_gaps=_t(a.sum_gaps, device, torch.float32),
        n_gaps=_t(a.n_gaps, device, torch.float32),
        lam=_t(a.lam, device, torch.float32),
        mem=tree("mem", m),
        mom=tree("mom", 1))
    rounds = np.unique(np.asarray(np_state.round))
    if rounds.size != 1:
        raise ValueError(f"trajectories are at different rounds: {rounds}")
    return FedState(
        server=server, clients=clients, opt_state=opt, algo_state=algo,
        link_state=_link_state(np_state.link_state, scheme, device),
        round=int(rounds[0]),
        last_active=_t(np_state.last_active, device, torch.int32))

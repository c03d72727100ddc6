"""Federated aggregation algorithms over the flat client buffer (port of
``repro.core.algorithms``).

Shapes: ``server [B, n]``, client models ``[B, m, n]``, ``active [B, m]``
bool, ``p_t [B, m]`` — a leading trajectory axis ``B`` everywhere, the
reference's ``vmap`` written out. Every rule is one entry of a per-family
table inside an :class:`AlgorithmSpec`, selected by ``algo_id``: a Python
int (direct dispatch) or a ``[B]`` int tensor, in which case each branch
present in the family is computed and ``torch.where`` picks per trajectory.

FedPBC (the paper, Alg. 1): clients start from their *own* model (implicit
gossiping); the server averages the active clients' models and broadcasts
the average back **only to the active clients** — the postponed broadcast.
Baselines: FedAvg, FedAvg-all, FedAU, MIFA, FedAvg-known-p, F3AST (§7.2),
and the FedPBC-M extension.

All per-algorithm state lives in ONE superset container, :class:`AlgoState`;
fields a family never uses are zero-sized (``[B, 0, ...]``).

A model held in two parameter groups (``repro_torch.core.params.Groups``:
a bf16 model's bf16 and fp32 buffers) has ``server``, ``clients``,
``x_star`` and the state's ``mem`` / ``mom`` as ``Groups``. Every rule
then runs once per group (``client_start``, ``aggregate``), the
reference's ``jax.tree.map`` over its mixed-dtype pytree: the rules are
elementwise in the parameters, and their per-client fields (FedAU's gaps,
F3AST's ``lam``) come from the masks alone, the same in every group. The
fused aggregation is then one launch per group per round.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, FrozenSet, Tuple, Union

import torch

from repro_torch.configs import FederationConfig
from repro_torch.core.params import Groups, gmap, lead_view

AlgoId = Union[int, torch.Tensor]


def masked_mean(xs: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Mean over the client axis restricted to active clients:
    ``[B, m, n] -> [B, n]``; 0 when no client is active (callers guard)."""
    denom = active.sum(-1).float().clamp_min(1.0)
    denom = denom.reshape(denom.shape + (1,) * (xs.dim() - 2))
    return (xs * lead_view(active, xs).to(xs.dtype)).sum(1) / \
        denom.to(xs.dtype)


def weighted_sum(xs: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return (xs * lead_view(w, xs).to(xs.dtype)).sum(1)


def bcast_where(active: torch.Tensor, new: torch.Tensor,
                old: torch.Tensor) -> torch.Tensor:
    """Per-client select: active clients receive ``new [B, n]``, others keep
    ``old [B, m, n]``."""
    return torch.where(lead_view(active, old), new.unsqueeze(1), old)


def _tile(server: torch.Tensor, m: int) -> torch.Tensor:
    """``[B, n] -> [B, m, n]`` broadcast view (read-only: consumers build new
    tensors from it, nothing writes it in place)."""
    return server.unsqueeze(1).expand((-1, m) + tuple(server.shape[1:]))


def _any(active: torch.Tensor, server: torch.Tensor) -> torch.Tensor:
    """Whether any client is active, ``[B]`` against ``server [B, n]``."""
    return lead_view(active.any(-1), server)


def _delta(x_star, server):
    return x_star.float() - server.unsqueeze(1).float()


@dataclass
class AlgoState:
    """Superset per-algorithm state, every field with a leading ``[B]``.
    Fields a family does not need are zero-sized on the client axis."""

    gap: torch.Tensor        # [B, m] rounds since last active (FedAU)
    sum_gaps: torch.Tensor   # [B, m] accumulated gaps (FedAU)
    n_gaps: torch.Tensor     # [B, m] gap counts (FedAU)
    lam: torch.Tensor        # [B, m] availability EMA (F3AST)
    mem: torch.Tensor        # [B, m, n] last updates (MIFA)
    mom: torch.Tensor        # [B, 1, n] server momentum (FedPBC-M)

    def group(self, g: int) -> "AlgoState":
        """The state of parameter group ``g`` (``mem`` and ``mom`` of a
        grouped model are ``Groups``)."""
        return dataclasses.replace(self, mem=self.mem[g], mom=self.mom[g])


_FIELDS = ("gap", "sum_gaps", "n_gaps", "lam", "mem", "mom")


def _merge_groups(states, kind=Groups) -> AlgoState:
    """Per-group states -> one: the mask-derived fields of the first (every
    group computes the same), ``mem`` and ``mom`` grouped as ``kind``
    (``Groups`` or ``Leaves``)."""
    return dataclasses.replace(states[0],
                               mem=kind(a.mem for a in states),
                               mom=kind(a.mom for a in states))


# ---------------------------------------------------------------------------
# Branch table: one aggregate function per rule over the unified state.
# (algo, server, clients, x_star, active, p_t, t) -> (algo, server, clients)
# ---------------------------------------------------------------------------


def _agg_fedpbc(algo, server, clients, x_star, active, p_t, t):
    """FedPBC (Alg. 1): masked mean over active clients; postponed broadcast."""
    any_active = _any(active, server)
    new_server = torch.where(any_active, masked_mean(x_star, active), server)
    # postponed broadcast: only active clients receive the new global model
    return algo, new_server, bcast_where(active, new_server, x_star)


def _agg_fedavg(algo, server, clients, x_star, active, p_t, t):
    """Vanilla FedAvg: average active clients; broadcast to everyone."""
    any_active = _any(active, server)
    new_server = torch.where(any_active, masked_mean(x_star, active), server)
    return algo, new_server, _tile(new_server, active.shape[-1])


def _agg_fedavg_all(algo, server, clients, x_star, active, p_t, t):
    """FedAvg-all: average over ALL m clients; inactive contribute zero."""
    m = active.shape[-1]
    w = active.float() / m
    new_server = server + weighted_sum(_delta(x_star, server), w).to(server.dtype)
    return algo, new_server, _tile(new_server, m)


def _agg_fedavg_known_p(algo, server, clients, x_star, active, p_t, t):
    """FedAvg with known p_i^t: active updates importance-weighted by 1/p_i^t."""
    m = active.shape[-1]
    w = active.float() / p_t.clamp_min(1e-3) / m
    new_server = server + weighted_sum(_delta(x_star, server), w).to(server.dtype)
    return algo, new_server, _tile(new_server, m)


def _make_agg_fedau(K: int):
    """FedAU (Wang & Ji 2023): online participation estimate via mean
    inter-participation gap, capped at K."""

    def branch(algo, server, clients, x_star, active, p_t, t):
        m = active.shape[-1]
        gap = torch.clamp_max(algo.gap + 1.0, float(K))
        sum_gaps = algo.sum_gaps + torch.where(active, gap, 0.0)
        n_gaps = algo.n_gaps + active.float()
        mean_gap = torch.where(n_gaps > 0,
                               sum_gaps / n_gaps.clamp_min(1.0), 1.0)
        w = active.float() * mean_gap / m   # mean gap ~= 1/p_i
        new_server = server + weighted_sum(_delta(x_star, server),
                                           w).to(server.dtype)
        new_algo = dataclasses.replace(
            algo, gap=torch.where(active, 0.0, gap), sum_gaps=sum_gaps,
            n_gaps=n_gaps)
        return new_algo, new_server, _tile(new_server, m)

    return branch


def _agg_mifa(algo, server, clients, x_star, active, p_t, t):
    """MIFA (Gu et al. 2021): memory of every client's last update."""
    m = active.shape[-1]
    mem = torch.where(lead_view(active, x_star),
                      _delta(x_star, server).to(algo.mem.dtype), algo.mem)
    new_server = server + mem.mean(1).to(server.dtype)
    return dataclasses.replace(algo, mem=mem), new_server, _tile(new_server, m)


def _make_agg_f3ast(beta: float, cap: int):
    """F3AST (Ribero et al. 2022): keep at most ``cap`` active clients with
    the SMALLEST availability EMA lambda_i."""

    def branch(algo, server, clients, x_star, active, p_t, t):
        lam = (1.0 - beta) * algo.lam + beta * active.float()
        # rank active clients by lambda ascending (stable, as jnp.argsort)
        score = torch.where(active, lam, float("inf"))
        order = torch.argsort(score, dim=-1, stable=True)
        rank = torch.argsort(order, dim=-1, stable=True)
        selected = active & (rank < cap)
        any_sel = _any(selected, server)
        new_server = torch.where(any_sel, masked_mean(x_star, selected),
                                 server)
        m = active.shape[-1]
        return dataclasses.replace(algo, lam=lam), new_server, \
            _tile(new_server, m)

    return branch


def _make_agg_fedpbc_m(beta: float):
    """FedPBC-M (beyond-paper): FedPBC + server momentum on the aggregated
    direction; the postponed broadcast is unchanged."""

    def branch(algo, server, clients, x_star, active, p_t, t):
        any_active = _any(active, server)
        agg = masked_mean(x_star, active)
        step = torch.where(any_active, agg.float() - server.float(), 0.0)
        mom = beta * algo.mom[:, 0] + step
        new_server = (server.float() + mom).to(server.dtype)
        new_clients = bcast_where(active, new_server, x_star)
        return dataclasses.replace(algo, mom=mom.unsqueeze(1)), new_server, \
            new_clients

    return branch


@dataclass(frozen=True)
class _AlgoDef:
    """Registry row: the AlgoState fields a rule materializes, where its
    clients start from, whether it consumes p_i^t, and its branch factory."""

    needs: FrozenSet[str]
    from_clients: bool
    needs_p: bool
    make_branch: Callable[["AlgorithmSpec"], Callable]


_DEFS: Dict[str, _AlgoDef] = {
    "fedpbc": _AlgoDef(frozenset(), True, False, lambda spec: _agg_fedpbc),
    "fedpbc_m": _AlgoDef(frozenset({"mom"}), True, False,
                         lambda spec: _make_agg_fedpbc_m(spec.fedpbc_m_beta)),
    "fedavg": _AlgoDef(frozenset(), False, False, lambda spec: _agg_fedavg),
    "fedavg_all": _AlgoDef(frozenset(), False, False,
                           lambda spec: _agg_fedavg_all),
    "fedau": _AlgoDef(frozenset({"gap", "sum_gaps", "n_gaps"}), False, False,
                      lambda spec: _make_agg_fedau(spec.fedau_K)),
    "mifa": _AlgoDef(frozenset({"mem"}), False, False, lambda spec: _agg_mifa),
    "fedavg_known_p": _AlgoDef(frozenset(), False, True,
                               lambda spec: _agg_fedavg_known_p),
    "f3ast": _AlgoDef(frozenset({"lam"}), False, False,
                      lambda spec: _make_agg_f3ast(spec.f3ast_beta,
                                                   spec.f3ast_cap)),
}


def state_signature(name: str) -> FrozenSet[str]:
    """The AlgoState fields ``name`` materializes — its batching class."""
    if name not in _DEFS:
        raise ValueError(
            f"unknown algorithm {name!r}; available: {sorted(_DEFS)}")
    return _DEFS[name].needs


def algo_family(name: str) -> Tuple[str, ...]:
    """Every registered algorithm with ``name``'s state signature, in
    registry order; ``algo_id`` values index this tuple."""
    sig = state_signature(name)
    return tuple(n for n in _DEFS if _DEFS[n].needs == sig)


def _is_static(algo_id) -> bool:
    return not isinstance(algo_id, torch.Tensor)


def _pick(sel: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-trajectory select between two ``[B, ...]`` tensors."""
    return torch.where(sel.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)


@dataclass(frozen=True)
class Algorithm:
    """A spec bound to one ``algo_id`` — the single-algorithm interface."""

    name: str
    init: Callable
    client_start: Callable
    aggregate: Callable
    needs_p: bool = False


@dataclass(frozen=True)
class AlgorithmSpec:
    """A family of aggregation rules as data: member ``names`` (indexed by
    ``algo_id``) plus their static knobs."""

    names: Tuple[str, ...]
    fedau_K: int = 50
    f3ast_beta: float = 0.01
    f3ast_cap: int = 10
    fedpbc_m_beta: float = 0.8

    def __post_init__(self):
        if not self.names:
            raise ValueError("AlgorithmSpec.names must be non-empty")
        unknown = [n for n in self.names if n not in _DEFS]
        if unknown:
            raise ValueError(
                f"AlgorithmSpec.names contains unknown algorithms {unknown}; "
                f"available: {sorted(_DEFS)}")
        if len(set(self.names)) != len(self.names):
            raise ValueError(
                f"AlgorithmSpec.names contains duplicates: {self.names}")

    @property
    def needs(self) -> FrozenSet[str]:
        out: FrozenSet[str] = frozenset()
        for n in self.names:
            out = out | _DEFS[n].needs
        return out

    @property
    def needs_p(self) -> bool:
        return any(_DEFS[n].needs_p for n in self.names)

    def id_of(self, name: str) -> int:
        if name not in self.names:
            raise ValueError(f"{name!r} is not in this spec's family "
                             f"{self.names}")
        return self.names.index(name)

    def init(self, server, m: int) -> AlgoState:
        """The family's unified state for ``server [B, n]`` (or a leaf
        ``[B, *shape]``): needed fields at full size, the rest zero-sized
        (``mem`` / ``mom`` grouped as a grouped ``server``)."""
        if isinstance(server, Groups):
            return _merge_groups([self.init(x, m) for x in server],
                                 type(server))
        u = self.needs
        B, n = server.shape[0], tuple(server.shape[1:])
        dev = server.device

        def vec(field, fill=0.0):
            return torch.full((B, m if field in u else 0), fill,
                              dtype=torch.float32, device=dev)

        return AlgoState(
            gap=vec("gap"), sum_gaps=vec("sum_gaps"), n_gaps=vec("n_gaps"),
            lam=vec("lam", 0.5),
            mem=torch.zeros((B, m if "mem" in u else 0) + n,
                            dtype=server.dtype, device=dev),
            mom=torch.zeros((B, 1 if "mom" in u else 0) + n,
                            dtype=torch.float32, device=dev))

    def client_start(self, algo_id: AlgoId, algo_state, server, clients):
        if isinstance(server, Groups):
            return gmap(lambda x, c: self.client_start(
                algo_id, algo_state, x, c), server, clients)
        m = clients.shape[1]
        if _is_static(algo_id) or len(self.names) == 1:
            idx = int(algo_id) if _is_static(algo_id) else 0
            return clients if _DEFS[self.names[idx]].from_clients \
                else _tile(server, m)
        from_clients = torch.tensor(
            [_DEFS[n].from_clients for n in self.names],
            device=algo_id.device)[algo_id]
        return _pick(from_clients, clients, _tile(server, m))

    @property
    def fusable(self) -> bool:
        """Whether every member's aggregation folds into the fused kernel's
        branch select (``repro_torch.kernels.dispatch.FUSED_OPS``)."""
        from repro_torch.kernels.dispatch import FUSED_OPS
        return all(n in FUSED_OPS for n in self.names)

    def fused_op(self, algo_id: AlgoId) -> tuple:
        """``(op, is_pbc)``: the member's aggregation opcode and whether it is
        the postponed-broadcast member. Python scalars for a static
        ``algo_id``, ``[B]`` tensors (int32, bool) otherwise."""
        from repro_torch.kernels.dispatch import FUSED_OPS

        if _is_static(algo_id):
            name = self.names[int(algo_id)]
            return FUSED_OPS[name], name == "fedpbc"
        dev = algo_id.device
        op = torch.tensor([FUSED_OPS[n] for n in self.names],
                          dtype=torch.int32, device=dev)[algo_id]
        is_pbc = torch.tensor([n == "fedpbc" for n in self.names],
                              device=dev)[algo_id]
        return op.contiguous(), is_pbc

    def aggregate_cohort(self, algo_id: AlgoId, algo_state, server, x_star,
                         cohort, c_active, c_p, t) -> tuple:
        """Sparse cohort aggregation of a stateful rule: its per-client rows
        are gathered and written back at ``cohort [B, C]`` only
        (``repro_torch.scale.sparse_state``), so the round touches O(C)
        state. Stateful families are singletons, so dispatch is static.
        Returns ``(algo_state', server')``."""
        from repro_torch.scale.sparse_state import cohort_branch

        if not (_is_static(algo_id) or len(self.names) == 1):
            raise ValueError(
                "cohort aggregation needs a static algo_id (stateful "
                f"families are singletons; got a per-trajectory id over "
                f"{self.names})")
        idx = int(algo_id) if _is_static(algo_id) else 0
        branch = cohort_branch(self.names[idx], self)
        return branch(algo_state, server, x_star, cohort, c_active, c_p, t)

    def aggregate(self, algo_id: AlgoId, algo_state, server, clients, x_star,
                  active, p_t, t, use_kernel: bool = False,
                  fused=None) -> tuple:
        if isinstance(server, Groups):
            outs = [self.aggregate(algo_id, algo_state.group(g), server[g],
                                   clients[g], x_star[g], active, p_t, t,
                                   use_kernel, fused)
                    for g in range(len(server))]
            kind = type(server)
            return (_merge_groups([o[0] for o in outs], kind),
                    kind(o[1] for o in outs), kind(o[2] for o in outs))
        if use_kernel and self.fusable:
            return self._aggregate_fused(algo_id, algo_state, server,
                                         x_star, active, p_t, fused)
        branches = [_DEFS[n].make_branch(self) for n in self.names]
        if _is_static(algo_id) or len(self.names) == 1:
            idx = int(algo_id) if _is_static(algo_id) else 0
            return branches[idx](algo_state, server, clients, x_star, active,
                                 p_t, t)
        # traced-style select: every member's branch, picked per trajectory
        outs = [br(algo_state, server, clients, x_star, active, p_t, t)
                for br in branches]
        algo, new_server, new_clients = outs[0]
        for i, (a, s, c) in enumerate(outs[1:], start=1):
            sel = algo_id == i
            algo = AlgoState(**{f: _pick(sel, getattr(a, f), getattr(algo, f))
                                for f in _FIELDS})
            new_server = _pick(sel, s, new_server)
            new_clients = _pick(sel, c, new_clients)
        return algo, new_server, new_clients

    def _aggregate_fused(self, algo_id, algo_state, server, x_star, active,
                         p_t, fused=None) -> tuple:
        """The fused-kernel aggregate: ONE launch over the whole ``[B, m, n]``
        buffer computes every trajectory's new server params with its
        member's weighting selected inside the kernel, then one select
        updates the clients (postponed broadcast for fedpbc, instant for the
        FedAvg variants). The family's ``algo_state`` is empty and passes
        through untouched."""
        from repro_torch.kernels.dispatch import fused_agg

        op, is_pbc = fused if fused is not None else self.fused_op(algo_id)
        B = server.shape[0]
        if _is_static(algo_id):
            bcast = active if is_pbc else torch.ones_like(active)
            op = torch.full((B,), op, dtype=torch.int32, device=server.device)
        else:
            bcast = active | ~is_pbc.unsqueeze(-1)
        new_server = fused_agg(x_star.contiguous(), active.contiguous(), op,
                               server.float().contiguous(),
                               p_t.float().contiguous()).to(server.dtype)
        return algo_state, new_server, bcast_where(bcast, new_server, x_star)

    def bind(self, algo_id: AlgoId = 0, use_kernel: bool = False) -> Algorithm:
        """Fix the dispatch index and expose the single-algorithm interface.
        A ``[B]`` tensor ``algo_id`` has its fused opcodes looked up once
        here rather than every round."""
        if _is_static(algo_id):
            name = self.names[int(algo_id)]
            needs_p = _DEFS[name].needs_p
            fused = None
        else:
            name = "+".join(self.names)
            needs_p = self.needs_p
            fused = self.fused_op(algo_id) if (use_kernel and self.fusable) \
                else None
        return Algorithm(
            name=name,
            init=self.init,
            client_start=lambda a, s, c: self.client_start(algo_id, a, s, c),
            aggregate=lambda a, s, c, xs, act, p, t: self.aggregate(
                algo_id, a, s, c, xs, act, p, t, use_kernel=use_kernel,
                fused=fused),
            needs_p=needs_p)


def as_algorithm(algorithm: Union[Algorithm, AlgorithmSpec], algo_id=0,
                 use_kernel: bool = False) -> Algorithm:
    """Specs are bound at ``algo_id``; algorithms pass through."""
    if isinstance(algorithm, AlgorithmSpec):
        return algorithm.bind(algo_id, use_kernel=use_kernel)
    return algorithm


# ---------------------------------------------------------------------------
# Single-algorithm factories
# ---------------------------------------------------------------------------


def fedpbc() -> Algorithm:
    return AlgorithmSpec(("fedpbc",)).bind(0)


def fedavg() -> Algorithm:
    return AlgorithmSpec(("fedavg",)).bind(0)


def fedavg_all() -> Algorithm:
    return AlgorithmSpec(("fedavg_all",)).bind(0)


def fedavg_known_p() -> Algorithm:
    return AlgorithmSpec(("fedavg_known_p",)).bind(0)


def fedau(K: int = 50) -> Algorithm:
    return AlgorithmSpec(("fedau",), fedau_K=K).bind(0)


def mifa() -> Algorithm:
    return AlgorithmSpec(("mifa",)).bind(0)


def f3ast(beta: float = 0.01, cap: int = 10) -> Algorithm:
    return AlgorithmSpec(("f3ast",), f3ast_beta=beta, f3ast_cap=cap).bind(0)


def fedpbc_m(beta: float = 0.8) -> Algorithm:
    return AlgorithmSpec(("fedpbc_m",), fedpbc_m_beta=beta).bind(0)


ALGORITHMS = {
    "fedpbc": fedpbc,
    "fedpbc_m": fedpbc_m,
    "fedavg": fedavg,
    "fedavg_all": fedavg_all,
    "fedau": fedau,
    "mifa": mifa,
    "fedavg_known_p": fedavg_known_p,
    "f3ast": f3ast,
}


def make_algorithm_spec(names: Tuple[str, ...],
                        cfg: FederationConfig = None) -> AlgorithmSpec:
    """Spec table for a family, with static knobs drawn from ``cfg``."""
    kw = {} if cfg is None else dict(
        fedau_K=cfg.fedau_K, f3ast_beta=cfg.f3ast_beta, f3ast_cap=cfg.f3ast_cap)
    return AlgorithmSpec(tuple(names), **kw)


def make_algorithm(cfg: FederationConfig) -> Algorithm:
    return make_algorithm_spec((cfg.algorithm,), cfg).bind(0)

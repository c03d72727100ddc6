"""Federated round engine (port of ``repro.core.federated``).

A round (Alg. 1 of the paper):

    1. sample the link process -> active mask A^t;
    2. every client runs ``s`` local optimizer steps from its start params —
       all ``B * m`` client models at once, as one batch;
    3. the aggregation rule updates server + client params (postponed
       broadcast for FedPBC, instant for FedAvg-style baselines).

Every tensor carries a leading trajectory axis ``B`` (one trajectory is
``B = 1``): ``server [B, n]``, ``clients [B, m, n]`` — each trajectory's
client models as ONE flat buffer in the model's dtype (fp32 for the MLP,
bf16 for the full-width LM), so the server update is one kernel launch per
round.

Drawing is separate from computing. The round's randomness — the link
uniforms ``u [B, m]`` and the data draw ``pick`` (index draw
``[B, m, s, b]`` of the classification sources, token draw
``[B, m, s, b, T]`` of the LM source) — is a
``RoundDraws`` made by one drawer (``GeneratorDraws``, from explicit
``torch.Generator`` streams); ``round_fn(state, batches, u)`` and the
step built by ``make_round_step`` compute the round given those draws, so a
test can hand both packages the same numbers. The reference's ``lax.scan``
over rounds is a Python loop here (``run_rounds_loop``).

The model is the caller's: ``loss_fn(params [B, m, n], batch) -> [B, m]``
per-client mean losses over a batch pytree with leading ``[B, m, ...]`` axes.
A model with fp32 leaves in a narrower dtype is held in two parameter
groups (``repro_torch.core.params.Groups``): ``server``, ``clients``, the
optimizer's moments and ``x_star`` are then ``Groups`` of ``[B, n_g]`` /
``[B, m, n_g]`` buffers, ``loss_fn`` takes the groups, and each step's
gradient is one buffer per group. The scale engines take one group only.

Cross-device scale (``repro_torch.scale``; ``make_round_fn(strategy=...,
cohort_size=...)``): a buffered round folds arrivals into a
``BufferState`` and commits when the buffer fills or a deadline passes; a
cohort round trains only a drawn ``[B, C]`` cohort of stateless clients
(the draw's ``cohort``, from the ``"cohort"`` stream), so no ``[B, m, n]``
client tensor exists.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import torch

from repro_torch.configs import FederationConfig
from repro_torch.core.algorithms import (
    AlgoState,
    AlgorithmSpec,
    _tile,
    as_algorithm,
    bcast_where,
)
from repro_torch.core.connectivity import LinkProcess
from repro_torch.core.params import Groups, first, gmap
from repro_torch.device import resolve_device, set_fp32_matmul_precision
from repro_torch.scale.buffer import (
    BufferState,
    buffered_aggregate,
    init_buffer_state,
    knobs_of,
)
from repro_torch.scale.participation import cohort_arrivals, sample_cohort


@dataclass
class FedState:
    server: torch.Tensor          # [B, n]
    # [B, m, n]; stateless cohort clients hold none: [B, 0, n]
    clients: torch.Tensor
    # per client: step [B, m], moments; stateless cohort clients: {}
    opt_state: Dict[str, torch.Tensor]
    algo_state: AlgoState
    link_state: Any
    # rounds run so far: an int shared by every trajectory, or a [B] int64
    # tensor for a batch whose trajectories stand at different rounds (the
    # adaptive search packs level-0 candidates beside level-k survivors)
    round: Union[int, torch.Tensor]
    # staleness bookkeeping (Prop. 2): last round each uplink was active
    last_active: torch.Tensor     # [B, m] int32
    # buffered semi-async aggregation (repro_torch.scale.buffer): a
    # BufferState in the buffered and cohort modes, None for the sync engine
    buffer: Optional[BufferState] = None


@dataclass
class RoundDraws:
    """One round's randomness: the link uniforms, the data index draw and,
    in cohort mode, the cohort (``pick`` then has ``C`` in place of ``m``)."""

    u: torch.Tensor                       # [B, m] float32 in [0, 1)
    pick: Optional[torch.Tensor] = None   # [B, m or C, *shape] int64
    cohort: Optional[torch.Tensor] = None  # [B, C] int64, unique per row


def round_column(t, like: torch.Tensor):
    """The round as an operand beside ``like [B, ...]``: an ``int`` as it
    is, a ``[B]`` round as a ``[B, 1]`` column of ``like``'s dtype (so
    ``torch.where(active, t, last_active)`` keeps ``last_active``'s int32
    and the int path stays the program it was)."""
    if isinstance(t, torch.Tensor):
        return t.reshape(-1, 1).to(like.dtype)
    return t


def clone_generator(g: torch.Generator) -> torch.Generator:
    """A generator on ``g``'s device at ``g``'s position."""
    out = torch.Generator(device=g.device)
    out.set_state(g.get_state())
    return out


class GeneratorDraws:
    """The engine's drawer: per-seed ``torch.Generator`` bundles
    (``{"params", "state", "ds", "data", "cohort"}``, see
    ``repro_torch.experiments.sweep.seed_generators``); trajectory ``b``
    uses bundle ``index[b]``, so trajectories of one seed see the same
    numbers, as they see the same keys in the reference.

    Streams: ``params`` gives the initial model, ``state`` the link process's
    initial draw and then every round's ``u``, ``ds`` the data source's
    init draw, ``data`` every round's ``pick``, ``cohort`` (with
    ``cohort_size=C`` only) every round's cohort. A round's draw is the
    next one on each stream, so each bundle's rounds are drawn in order
    (the reference folds the round into its data key). ``pick_spec`` is the
    source's ``(*per-client draw shape, high)``: each client (each cohort
    member in cohort mode) draws integers in ``[0, high)``.

    Resumable segments (``make_batched_run_rounds(carry_out=True)``): the
    drawer rides the carry. ``tags`` names each bundle's origin (the seed);
    a bundle also counts the draws it has made, so ``(tag, draws made)`` —
    the seed and the budget level — identifies its state, and ``take`` /
    ``select`` build a drawer for re-packed rows whose bundles are copies
    (``get_state``/``set_state``) of the ones those rows used, one per
    ``(tag, draws made)``. ``copy`` gives a drawer that can advance while
    this one stays where it is. The call's round ``t`` (an ``int`` or a
    ``[B]`` tensor) is not read here: a bundle's next draw is its round's.
    """

    def __init__(self, bundles: Sequence[Dict[str, torch.Generator]],
                 index: Optional[Sequence[int]] = None, *, num_clients: int,
                 pick_spec=None, cohort_size: Optional[int] = None,
                 tags: Optional[Sequence[Any]] = None,
                 made: Optional[Sequence[int]] = None):
        self.bundles = list(bundles)
        self.m = num_clients
        self.pick_spec = pick_spec
        self.cohort_size = cohort_size
        self.tags = list(tags) if tags is not None else [None] * len(
            self.bundles)
        self.made = list(made) if made is not None else [0] * len(
            self.bundles)
        self.rows = (list(range(len(self.bundles))) if index is None
                     else [int(i) for i in index])
        dev = self.bundles[0]["state"].device
        self.index = None if self.rows == list(
            range(len(self.bundles))) else torch.as_tensor(
                self.rows, dtype=torch.long, device=dev)

    def _stack(self, parts: List[torch.Tensor]) -> torch.Tensor:
        out = torch.stack(parts)
        return out if self.index is None else out[self.index]

    def _drew(self):
        """Count one draw (an init draw or a round) on every bundle."""
        self.made = [k + 1 for k in self.made]

    def params(self, init_params: Callable):
        """``[B, n]`` initial server params, ``init_params(generator)`` (a
        model's ``Groups``, each group stacked)."""
        self._drew()
        outs = [init_params(g["params"]) for g in self.bundles]
        if isinstance(outs[0], Groups):
            return Groups(self._stack(list(parts)) for parts in zip(*outs))
        return self._stack(outs)

    def link_init(self) -> torch.Tensor:
        self._drew()
        return self._stack([torch.rand(self.m, generator=g["state"],
                                       device=g["state"].device)
                            for g in self.bundles])

    def source_init(self, high: int) -> torch.Tensor:
        """``[B, m]`` per-client integers in ``[0, high)`` from the ``ds``
        stream (the LM source's vocabulary offsets)."""
        self._drew()
        return self._stack([torch.randint(0, high, (self.m,),
                                          generator=g["ds"],
                                          device=g["ds"].device)
                            for g in self.bundles])

    def __call__(self, t) -> RoundDraws:
        self._drew()
        u = self._stack([torch.rand(self.m, generator=g["state"],
                                    device=g["state"].device)
                         for g in self.bundles])
        cohort = None
        rows = self.m
        if self.cohort_size is not None:
            rows = self.cohort_size
            cohort = self._stack([sample_cohort(g["cohort"], self.m, rows)
                                  for g in self.bundles])
        pick = None
        if self.pick_spec is not None:
            *shape, high = self.pick_spec
            pick = self._stack([
                torch.randint(0, high, (rows, *shape),
                              generator=g["data"], device=g["data"].device)
                for g in self.bundles])
        return RoundDraws(u, pick, cohort)

    # -- checkpoints -----------------------------------------------------------

    def state(self) -> Dict[str, Any]:
        """What a checkpoint holds of this drawer: each bundle's generators
        (``repro_torch.checkpointing`` stores their ``get_state()``), tag
        and draws made."""
        return {"bundles": self.bundles, "tags": list(self.tags),
                "made": list(self.made)}

    def restored(self, state: Dict[str, Any]) -> "GeneratorDraws":
        """A drawer of this one's rows and round shape at ``state`` (as
        :meth:`state` gave it, its generators restored)."""
        return GeneratorDraws(state["bundles"], self.rows, num_clients=self.m,
                              pick_spec=self.pick_spec,
                              cohort_size=self.cohort_size,
                              tags=state["tags"], made=state["made"])

    # -- re-packing (the adaptive search) -----------------------------------

    def _key(self, i: int):
        tag = self.tags[i]
        return (tag, self.made[i]) if tag is not None else (
            "bundle", id(self.bundles[i]))

    @staticmethod
    def _compose(sources) -> "GeneratorDraws":
        """A drawer whose row ``b`` draws as bundle ``i`` of drawer ``d``
        did, ``sources[b] = (d, i)``; bundles copied, one per key."""
        first = sources[0][0]
        keys, bundles, tags, made, index = {}, [], [], [], []
        for d, i in sources:
            if (d.m, d.pick_spec, d.cohort_size) != (
                    first.m, first.pick_spec, first.cohort_size):
                raise ValueError("drawers of different round shapes")
            k = d._key(i)
            if k not in keys:
                keys[k] = len(bundles)
                bundles.append({name: clone_generator(g)
                                for name, g in d.bundles[i].items()})
                tags.append(d.tags[i])
                made.append(d.made[i])
            index.append(keys[k])
        return GeneratorDraws(bundles, index, num_clients=first.m,
                              pick_spec=first.pick_spec,
                              cohort_size=first.cohort_size, tags=tags,
                              made=made)

    def copy(self) -> "GeneratorDraws":
        return self._compose([(self, i) for i in self.rows])

    def take(self, rows: Sequence[int]) -> "GeneratorDraws":
        """The drawer of rows ``rows`` (repeats allowed)."""
        return self._compose([(self, self.rows[int(r)]) for r in rows])

    def select(self, mask: Sequence[bool],
               other: "GeneratorDraws") -> "GeneratorDraws":
        """Row ``b`` from this drawer where ``mask[b]``, else from
        ``other`` (same number of rows)."""
        return self._compose([(self, i) if keep else (other, j)
                              for keep, i, j in zip(mask, self.rows,
                                                    other.rows)])

    @staticmethod
    def concat(drawers: Sequence["GeneratorDraws"]) -> "GeneratorDraws":
        """The rows of every drawer, one after another."""
        return GeneratorDraws._compose([(d, i) for d in drawers
                                        for i in d.rows])


def init_fed_state(link_u: torch.Tensor, server_params: torch.Tensor,
                   fed_cfg: FederationConfig, algorithm, link: LinkProcess,
                   optimizer, *, stateless_clients: bool = False,
                   buffered: bool = False) -> FedState:
    """``server_params [B, n]``; ``link_u [B, m]`` the link process's initial
    draw (the reference's ``k_link`` split). Every client starts from the
    server model in its own copy of the buffer.

    ``stateless_clients``: cohort (cross-device) mode. No per-client model
    or optimizer state exists: ``clients`` is the empty ``[B, 0, n]`` and
    ``opt_state`` is ``{}``; every sampled client trains from the server
    model with a fresh optimizer, so a round's client memory is O(C).
    ``buffered``: carry a ``BufferState`` (``repro_torch.scale.buffer``)
    for the semi-async engine. ``server_params`` may be ``Groups`` (a
    model in two parameter groups); the scale engines refuse them."""
    algorithm = as_algorithm(algorithm)
    m = fed_cfg.num_clients
    if stateless_clients or buffered:
        one_group(server_params, "the cohort and buffered engines")
    B = first(server_params).shape[0]
    if stateless_clients:
        clients = server_params.new_empty((B, 0, server_params.shape[-1]))
        opt_state = {}
    else:
        clients = gmap(lambda x: x.unsqueeze(1).expand(
            (B, m) + tuple(x.shape[1:])).clone(), server_params)
        opt_state = optimizer.init(clients)
    return FedState(
        server=server_params,
        clients=clients,
        opt_state=opt_state,
        algo_state=algorithm.init(server_params, m),
        link_state=link.init(link_u),
        round=0,
        last_active=torch.full((B, m), -1, dtype=torch.int32,
                               device=first(server_params).device),
        buffer=init_buffer_state(server_params, m) if buffered else None,
    )


def one_group(params, what: str):
    """Raise for a model in two parameter groups where ``what`` takes one
    flat buffer."""
    if isinstance(params, Groups):
        raise NotImplementedError(
            f"{what} take a model in one parameter buffer; this one has "
            f"{len(params)} groups (fp32 leaves in a narrower model): the "
            "scale engines' buffer fold and sparse cohort state are not "
            "mapped over parameter groups yet")


def local_steps(loss_fn, optimizer, params, opt_state, batches, s: int,
                reduce_grads=None):
    """Run ``s`` local optimizer steps for every client model at once.

    ``params [B, m, n]`` (or its ``Groups``); ``batches`` leaves ``[B, m,
    s, ...]`` (one mini-batch per local step). Each client's gradient is
    the autograd gradient of the SUM of the per-client mean losses: clients
    share no parameters, so that sum's gradient row is each client's own
    gradient (one buffer per group). ``reduce_grads`` (a sequence axis's,
    or None) maps each step's gradient before the update. Returns
    ``(params', opt_state', mean_loss [B, m])``.
    """
    losses = []
    for k in range(s):
        batch = {key: v[:, :, k] for key, v in batches.items()}
        with torch.enable_grad():
            leaf = gmap(lambda x: x.detach().requires_grad_(True), params)
            per_client = loss_fn(leaf, batch)
            grad = torch.autograd.grad(per_client.sum(), leaf)
        grad = type(leaf)(grad) if isinstance(leaf, Groups) else grad[0]
        if reduce_grads is not None:
            grad = reduce_grads(grad)
        params, opt_state = optimizer.update(gmap(torch.Tensor.detach,
                                                  params), opt_state, grad)
        losses.append(per_client.detach())
    return params, opt_state, torch.stack(losses).mean(0)


def make_round_fn(loss_fn: Callable, optimizer, algorithm,
                  link: LinkProcess, fed_cfg: FederationConfig,
                  algo_id=0, use_kernel: bool = False,
                  strategy=None, cohort_size: Optional[int] = None,
                  gather_updates=None):
    """Build ``round_fn(state, batches, u) -> (state', metrics)``.

    ``algorithm``: an ``Algorithm``, or an ``AlgorithmSpec`` bound at
    ``algo_id`` (a Python int, or a ``[B]`` tensor selecting each
    trajectory's member). ``use_kernel`` routes a fusable family's server
    aggregation through the fused kernel (``repro_torch.kernels.dispatch``):
    one launch per round over the whole ``[B, m, n]`` buffer.

    ``strategy`` / ``cohort_size``: the cross-device scale engines
    (``_make_scale_round_fn``); both need an ``AlgorithmSpec`` and ignore
    ``use_kernel``, as the reference's do: their aggregation is the buffer
    fold or the sparse cohort branches, never the fused kernel.

    ``gather_updates``: the model axis of a sharded sweep
    (``repro_torch.sharding.pool.ModelAxis``), or None. The state then holds
    this rank's clients only (``take`` of the ``[B, m, ...]`` client buffers
    and optimizer leaves), the round trains those on their columns of the
    batches, and the hook (``(x_star, losses) -> (x_star, losses)``, the
    reference's) all-gathers their results into all m clients before any
    cross-client reduction. Every model rank then aggregates the full
    ``[B, m, n]`` identically and keeps the server, link and algorithm
    state whole; it keeps its own columns of the new clients.

    A ``SequenceAxis`` there (``splits_sequence``) splits each sequence
    instead (``_local_training``): the state holds all m clients on every
    model rank, no client is taken or gathered, and the all-reduces of the
    gradients and the losses leave every rank the same bits.
    """
    # full fp32 products on the card (no TF32), set explicitly
    set_fp32_matmul_precision()
    if strategy is not None or cohort_size is not None:
        return _make_scale_round_fn(loss_fn, optimizer, algorithm, link,
                                    fed_cfg, algo_id, strategy, cohort_size,
                                    gather_updates)
    algorithm = as_algorithm(algorithm, algo_id, use_kernel=use_kernel)
    s = fed_cfg.local_steps
    train = _local_training(loss_fn, optimizer, s, gather_updates)
    client_axis = _client_axis(gather_updates)

    def round_fn(state: FedState, batches, u: torch.Tensor) -> tuple:
        active, p_t, link_state = link.sample(state.link_state, state.round, u)
        starts = algorithm.client_start(state.algo_state, state.server,
                                        state.clients)
        x_star, opt_state, losses = train(starts, state.opt_state, batches)
        # no rule reads the previous clients here (they start the round)
        algo_state, server, clients = algorithm.aggregate(
            state.algo_state, state.server, state.clients, x_star, active,
            p_t, state.round)
        if client_axis is not None:
            clients = gmap(client_axis.take, clients)
        last_active = torch.where(
            active, round_column(state.round, state.last_active),
            state.last_active)
        new_state = FedState(
            server=server, clients=clients, opt_state=opt_state,
            algo_state=algo_state, link_state=link_state,
            round=state.round + 1, last_active=last_active)
        metrics = {
            "loss": losses.mean(-1),
            "num_active": active.sum(-1),
            "active": active,
            "staleness": (round_column(state.round, state.last_active)
                          - state.last_active).float(),
        }
        return new_state, metrics

    return round_fn


def _client_axis(gather_updates):
    """The round's model-axis hook where it splits the clients (a
    ``ModelAxis``); None without one or for a ``SequenceAxis``."""
    if getattr(gather_updates, "splits_sequence", False):
        return None
    return gather_updates


def _local_training(loss_fn, optimizer, s: int, gather_updates):
    """``train(starts, opt_state, batches) -> (x_star, opt_state', losses)``
    over every client, or, on a model axis, over this rank's clients
    (their columns of ``batches``; ``starts`` and ``opt_state`` are already
    theirs) with ``x_star`` and ``losses`` gathered back to all m. On a
    sequence axis every client trains on this rank's columns of every
    sequence (``take_seq`` of the batches' last axis) with the axis active
    in the forward; each step's gradient and the per-client losses are
    all-reduced over the axis, so every rank holds all m identical
    results."""
    if getattr(gather_updates, "splits_sequence", False):
        seq = gather_updates

        def train(starts, opt_state, batches):
            batches = {k: seq.take_seq(v) for k, v in batches.items()}
            with seq.active():
                x_star, opt_state, losses = local_steps(
                    loss_fn, optimizer, starts, opt_state, batches, s,
                    reduce_grads=seq.reduce_grads)
            return x_star, opt_state, seq.reduce_loss(losses)

        return train

    def train(starts, opt_state, batches):
        if gather_updates is not None:
            batches = {k: gather_updates.take(v) for k, v in batches.items()}
        x_star, opt_state, losses = local_steps(loss_fn, optimizer, starts,
                                                opt_state, batches, s)
        if gather_updates is not None:
            x_star, losses = gather_updates((x_star, losses))
        return x_star, opt_state, losses

    return train


def _make_scale_round_fn(loss_fn, optimizer, algorithm, link, fed_cfg,
                         algo_id, strategy, cohort_size, gather_updates=None):
    """The cross-device scale round engines (``repro_torch.scale``).

    Dense buffered (``cohort_size is None``): the synchronous round's data
    and mask protocol, ``round_fn(state, batches, u)``, with the server
    aggregation routed through the buffered fold. In the degenerate
    commit-every-round configuration it computes the synchronous branches
    term for term (the bit-for-bit pin in ``tests/test_torch_scale.py``).

    Cohort (``cohort_size=C``): ``round_fn(state, ds_state, draws, source)
    -> (state, ds_state, metrics)`` (it carries ``needs_source``). Clients
    are stateless: the draw's ``[B, C]`` cohort trains from the server
    model with a fresh optimizer on its own batches only
    (``source.sample_cohort``), and the aggregation is the buffer engine
    (fusable family) or the sparse gather/scatter branches (stateful
    rules). No ``[B, m, n]`` client tensor exists in the round; the link
    process still advances over the full ``[B, m]`` population.
    """
    if not isinstance(algorithm, AlgorithmSpec):
        raise ValueError(
            "the buffered/cohort round engine needs an AlgorithmSpec (got "
            f"{type(algorithm).__name__}; bind algo_id via the algo_id "
            "argument instead)")
    spec = algorithm
    m = fed_cfg.num_clients
    buffered = spec.fusable   # stateful rules take the sparse cohort path
    if strategy is not None and not buffered:
        raise ValueError(
            f"buffered strategies cover the empty-state family only; "
            f"{spec.names} keeps per-client state (use the synchronous or "
            "cohort path)")
    knobs = knobs_of(strategy)
    if buffered:
        op, is_pbc = spec.fused_op(algo_id)
    bound = as_algorithm(spec, algo_id)
    train = _local_training(loss_fn, optimizer, fed_cfg.local_steps,
                            gather_updates)
    client_axis = _client_axis(gather_updates)

    def commit_clients(commit, in_buffer, server, x_star):
        """Postponed broadcast at commit time: fedpbc's new global model
        reaches exactly the buffered contributors; other members broadcast
        to every client. Between commits nobody moves."""
        if isinstance(is_pbc, bool):
            bcast = in_buffer if is_pbc else torch.ones_like(in_buffer)
        else:
            bcast = in_buffer | ~is_pbc.unsqueeze(-1)
        committed = bcast_where(bcast, server, x_star)
        return torch.where(commit.reshape(-1, 1, 1), committed, x_star)

    if cohort_size is None:
        def round_fn(state: FedState, batches, u: torch.Tensor) -> tuple:
            active, p_t, link_state = link.sample(state.link_state,
                                                  state.round, u)
            starts = bound.client_start(state.algo_state, state.server,
                                        state.clients)
            x_star, opt_state, losses = train(starts, state.opt_state,
                                              batches)
            in_buffer = state.buffer.in_buffer | active
            buf, server, commit, bmets = buffered_aggregate(
                state.buffer, state.server, x_star, active, p_t, knobs,
                op=op, m_total=m, in_buffer_new=in_buffer)
            clients = commit_clients(commit, in_buffer, server, x_star)
            if client_axis is not None:
                clients = client_axis.take(clients)
            last_active = torch.where(
                active, round_column(state.round, state.last_active),
                state.last_active)
            new_state = FedState(
                server=server, clients=clients, opt_state=opt_state,
                algo_state=state.algo_state, link_state=link_state,
                round=state.round + 1, last_active=last_active, buffer=buf)
            metrics = {
                "loss": losses.mean(-1),
                "num_active": active.sum(-1),
                "active": active,
                "staleness": (round_column(state.round, state.last_active)
                              - state.last_active).float(),
                **bmets,
            }
            return new_state, metrics

        return round_fn

    C = cohort_size

    def round_fn(state: FedState, ds_state, draws: RoundDraws,
                 source) -> tuple:
        # the link advances over the FULL population (Markov chains etc.
        # keep their dense-time semantics); the cohort sees its gather
        active_m, p_t_m, link_state = link.sample(state.link_state,
                                                  state.round, draws.u)
        cohort = draws.cohort
        if cohort is None or cohort.shape[-1] != C:
            raise ValueError(f"the cohort round needs a [B, {C}] cohort in "
                             f"its draws (GeneratorDraws(cohort_size={C}))")
        c_active, c_p = cohort_arrivals(cohort, active_m, p_t_m)
        batches, ds_state = source.sample_cohort(ds_state, state.round,
                                                 cohort, draws.pick)
        starts = _tile(state.server, C)
        if client_axis is not None:
            starts = client_axis.take(starts)
        x_star, _, losses = train(starts, optimizer.init(starts), batches)
        if buffered:
            prev = state.buffer.in_buffer
            in_buffer = prev.scatter(1, cohort, prev.gather(1, cohort)
                                     | c_active)
            buf, server, commit, bmets = buffered_aggregate(
                state.buffer, state.server, x_star, c_active, c_p, knobs,
                op=op, m_total=C, in_buffer_new=in_buffer)
            algo_state = state.algo_state
        else:
            algo_state, server = spec.aggregate_cohort(
                algo_id, state.algo_state, state.server, x_star, cohort,
                c_active, c_p, state.round)
            buf = state.buffer
            ones = torch.ones(c_active.shape[0], device=server.device)
            bmets = {"commit": ones,
                     "buffer_fill": c_active.sum(-1).float(),
                     "commit_staleness": torch.zeros_like(ones)}
        last_active = state.last_active.scatter(
            1, cohort, torch.where(
                c_active, round_column(state.round, state.last_active),
                state.last_active.gather(1, cohort)))
        new_state = FedState(
            server=server, clients=state.clients, opt_state={},
            algo_state=algo_state, link_state=link_state,
            round=state.round + 1, last_active=last_active, buffer=buf)
        metrics = {
            "loss": losses.mean(-1),
            "num_active": c_active.sum(-1),
            "active": c_active,
            "staleness": (round_column(state.round, state.last_active)
                          - state.last_active).float(),
            **bmets,
        }
        return new_state, ds_state, metrics

    round_fn.needs_source = True
    return round_fn


# Metrics stacked per round by run_rounds. "active" ([B, K, m] bool) is
# cheap but redundant with staleness for most consumers.
DEFAULT_METRIC_KEYS = ("loss", "num_active", "staleness")


def make_round_step(round_fn, source):
    """One (sample batch -> run round) step over a ``DataSource``:
    ``step(state, ds_state, draws: RoundDraws) -> (state, ds_state, metrics)``.
    A cohort round (``needs_source``) samples its own cohort's batches."""

    if getattr(round_fn, "needs_source", False):
        # the source's capability is checked here, when the step is built
        if source.sample_cohort is None:
            raise ValueError(
                f"cohort mode needs a DataSource with sample_cohort "
                f"(source {source.name!r} has none)")

        def step(state: FedState, ds_state, draws: RoundDraws):
            return round_fn(state, ds_state, draws, source)

        return step

    def step(state: FedState, ds_state, draws: RoundDraws):
        batches, ds_state = source.sample(ds_state, state.round, draws.pick)
        state, metrics = round_fn(state, batches, draws.u)
        return state, ds_state, metrics

    return step


def _empty_metrics(state: FedState, metric_keys) -> Dict[str, torch.Tensor]:
    B, m = state.last_active.shape
    dev = state.last_active.device
    shapes = {"loss": ((B, 0), torch.float32),
              "num_active": ((B, 0), torch.int64),
              "active": ((B, 0, m), torch.bool),
              "staleness": ((B, 0, m), torch.float32),
              "commit": ((B, 0), torch.float32),
              "buffer_fill": ((B, 0), torch.float32),
              "commit_staleness": ((B, 0), torch.float32)}
    return {k: torch.zeros(shapes[k][0], dtype=shapes[k][1], device=dev)
            for k in metric_keys}


def run_rounds_loop(state: FedState, ds_state, draw: Callable[[int], RoundDraws],
                    num_rounds: int, *, round_fn=None, source=None,
                    metric_keys=DEFAULT_METRIC_KEYS, step=None):
    """``num_rounds`` rounds, one Python iteration each; ``draw(round)``
    supplies each round's ``RoundDraws``. Returns ``(state', ds_state',
    metrics)`` with every metric stacked to ``[B, K, ...]``. Nothing here
    waits for the device."""
    if step is None:
        step = make_round_step(round_fn, source)
    collected: Dict[str, List[torch.Tensor]] = {k: [] for k in metric_keys}
    with torch.no_grad():
        for _ in range(num_rounds):
            state, ds_state, metrics = step(state, ds_state, draw(state.round))
            for k in metric_keys:
                collected[k].append(metrics[k])
    if num_rounds == 0:
        return state, ds_state, _empty_metrics(state, metric_keys)
    return state, ds_state, {k: torch.stack(v, 1) for k, v in collected.items()}


def make_run_rounds(loss_fn: Callable, optimizer, algorithm,
                    link: LinkProcess, fed_cfg: FederationConfig, source,
                    metric_keys=DEFAULT_METRIC_KEYS,
                    algo_id=0, use_kernel: bool = False,
                    strategy=None, cohort_size: Optional[int] = None,
                    device=None):
    """Build ``run_rounds(state, ds_state, draw, num_rounds) -> (state',
    ds_state', metrics)``, metrics ``[B, K, ...]``.

    ``device=None`` means the card (raises without CUDA); the state must lie
    on the resolved device. ``draw`` is a ``GeneratorDraws`` (or any
    ``round -> RoundDraws`` callable). ``strategy``/``cohort_size`` select
    the scale engines (``make_round_fn``); the state then comes from
    ``init_fed_state`` with the matching ``buffered``/``stateless_clients``
    and the draws carry the cohort.
    """
    dev = resolve_device(device)
    round_fn = make_round_fn(loss_fn, optimizer, algorithm, link, fed_cfg,
                             algo_id=algo_id, use_kernel=use_kernel,
                             strategy=strategy, cohort_size=cohort_size)
    step = make_round_step(round_fn, source)

    def run_rounds(state: FedState, ds_state, draw, num_rounds: int):
        on = first(state.server).device
        if on.type != dev.type:
            raise ValueError(f"state is on {on}, the runner on {dev}")
        return run_rounds_loop(state, ds_state, draw, num_rounds,
                               metric_keys=metric_keys, step=step)

    return run_rounds

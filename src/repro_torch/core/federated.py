"""Federated round engine (port of ``repro.core.federated``).

A round (Alg. 1 of the paper):

    1. sample the link process -> active mask A^t;
    2. every client runs ``s`` local optimizer steps from its start params —
       all ``B * m`` client models at once, as one batch;
    3. the aggregation rule updates server + client params (postponed
       broadcast for FedPBC, instant for FedAvg-style baselines).

Every tensor carries a leading trajectory axis ``B`` (one trajectory is
``B = 1``): ``server [B, n]``, ``clients [B, m, n]`` — each trajectory's
client models as ONE flat fp32 buffer, so the server update is one kernel
launch per round.

Drawing is separate from computing. The round's randomness — the link
uniforms ``u [B, m]`` and the data index draw ``pick [B, m, s, b]`` — is a
``RoundDraws`` made by one drawer (``GeneratorDraws``, from explicit
``torch.Generator`` streams); ``round_fn(state, batches, u)`` and the
step built by ``make_round_step`` compute the round given those draws, so a
test can hand both packages the same numbers. The reference's ``lax.scan``
over rounds is a Python loop here (``run_rounds_loop``).

The model is the caller's: ``loss_fn(params [B, m, n], batch) -> [B, m]``
per-client mean losses over a batch pytree with leading ``[B, m, ...]`` axes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.configs import FederationConfig
from repro_torch.core.algorithms import AlgoState, as_algorithm
from repro_torch.core.connectivity import LinkProcess
from repro_torch.device import resolve_device, set_fp32_matmul_precision


@dataclass
class FedState:
    server: torch.Tensor          # [B, n]
    clients: torch.Tensor         # [B, m, n]
    opt_state: Dict[str, torch.Tensor]   # per client: step [B, m], moments
    algo_state: AlgoState
    link_state: Any
    round: int                    # rounds run so far (same for every b)
    # staleness bookkeeping (Prop. 2): last round each uplink was active
    last_active: torch.Tensor     # [B, m] int32


@dataclass
class RoundDraws:
    """One round's randomness: the link uniforms and the data index draw."""

    u: torch.Tensor                       # [B, m] float32 in [0, 1)
    pick: Optional[torch.Tensor] = None   # [B, m, s, b] int64


class GeneratorDraws:
    """The engine's drawer: per-seed ``torch.Generator`` bundles
    (``{"params", "state", "ds", "data"}``, see
    ``repro_torch.experiments.sweep.seed_generators``); trajectory ``b``
    uses bundle ``index[b]``, so trajectories of one seed see the same
    numbers, as they see the same keys in the reference.

    Streams: ``params`` gives the initial model, ``state`` the link process's
    initial draw and then every round's ``u``, ``data`` every round's
    ``pick``. A round's draw is the next one on the stream, so rounds must be
    drawn in order (the reference folds the round into its data key).
    """

    def __init__(self, bundles: Sequence[Dict[str, torch.Generator]],
                 index: Optional[Sequence[int]] = None, *, num_clients: int,
                 pick_spec=None):
        self.bundles = list(bundles)
        self.m = num_clients
        self.pick_spec = pick_spec
        dev = self.bundles[0]["state"].device
        self.index = None if index is None or list(index) == list(
            range(len(self.bundles))) else torch.as_tensor(
                list(index), dtype=torch.long, device=dev)

    def _stack(self, parts: List[torch.Tensor]) -> torch.Tensor:
        out = torch.stack(parts)
        return out if self.index is None else out[self.index]

    def params(self, init_params: Callable) -> torch.Tensor:
        """``[B, n]`` initial server params, ``init_params(generator)``."""
        return self._stack([init_params(g["params"]) for g in self.bundles])

    def link_init(self) -> torch.Tensor:
        return self._stack([torch.rand(self.m, generator=g["state"],
                                       device=g["state"].device)
                            for g in self.bundles])

    def __call__(self, t: int) -> RoundDraws:
        u = self._stack([torch.rand(self.m, generator=g["state"],
                                    device=g["state"].device)
                         for g in self.bundles])
        pick = None
        if self.pick_spec is not None:
            s, b, per_client = self.pick_spec
            pick = self._stack([
                torch.randint(0, per_client, (self.m, s, b),
                              generator=g["data"], device=g["data"].device)
                for g in self.bundles])
        return RoundDraws(u, pick)


def init_fed_state(link_u: torch.Tensor, server_params: torch.Tensor,
                   fed_cfg: FederationConfig, algorithm, link: LinkProcess,
                   optimizer, *, stateless_clients: bool = False,
                   buffered: bool = False) -> FedState:
    """``server_params [B, n]``; ``link_u [B, m]`` the link process's initial
    draw (the reference's ``k_link`` split). Every client starts from the
    server model in its own copy of the buffer."""
    if stateless_clients or buffered:
        raise NotImplementedError(
            "cohort/buffered client state is not ported yet (ROADMAP "
            "Queue 1 item 3: cross-device scale)")
    algorithm = as_algorithm(algorithm)
    m = fed_cfg.num_clients
    B = server_params.shape[0]
    clients = server_params.unsqueeze(1).expand(B, m, -1).clone()
    return FedState(
        server=server_params,
        clients=clients,
        opt_state=optimizer.init(clients),
        algo_state=algorithm.init(server_params, m),
        link_state=link.init(link_u),
        round=0,
        last_active=torch.full((B, m), -1, dtype=torch.int32,
                               device=server_params.device),
    )


def local_steps(loss_fn, optimizer, params: torch.Tensor, opt_state,
                batches, s: int):
    """Run ``s`` local optimizer steps for every client model at once.

    ``params [B, m, n]``; ``batches`` leaves ``[B, m, s, ...]`` (one
    mini-batch per local step). Each client's gradient is the autograd
    gradient of the SUM of the per-client mean losses: clients share no
    parameters, so that sum's gradient row is each client's own gradient.
    Returns ``(params', opt_state', mean_loss [B, m])``.
    """
    losses = []
    for k in range(s):
        batch = {key: v[:, :, k] for key, v in batches.items()}
        with torch.enable_grad():
            leaf = params.detach().requires_grad_(True)
            per_client = loss_fn(leaf, batch)
            (grad,) = torch.autograd.grad(per_client.sum(), leaf)
        params, opt_state = optimizer.update(params.detach(), opt_state, grad)
        losses.append(per_client.detach())
    return params, opt_state, torch.stack(losses).mean(0)


def make_round_fn(loss_fn: Callable, optimizer, algorithm,
                  link: LinkProcess, fed_cfg: FederationConfig,
                  algo_id=0, use_kernel: bool = False,
                  strategy=None, cohort_size: Optional[int] = None):
    """Build ``round_fn(state, batches, u) -> (state', metrics)``.

    ``algorithm``: an ``Algorithm``, or an ``AlgorithmSpec`` bound at
    ``algo_id`` (a Python int, or a ``[B]`` tensor selecting each
    trajectory's member). ``use_kernel`` routes a fusable family's server
    aggregation through the fused kernel (``repro_torch.kernels.dispatch``):
    one launch per round over the whole ``[B, m, n]`` buffer.
    """
    if strategy is not None or cohort_size is not None:
        raise NotImplementedError(
            "buffered/cohort rounds are not ported yet (ROADMAP Queue 1 "
            "item 3: cross-device scale)")
    # full fp32 products on the card (no TF32), set explicitly
    set_fp32_matmul_precision()
    algorithm = as_algorithm(algorithm, algo_id, use_kernel=use_kernel)
    s = fed_cfg.local_steps

    def round_fn(state: FedState, batches, u: torch.Tensor) -> tuple:
        active, p_t, link_state = link.sample(state.link_state, state.round, u)
        starts = algorithm.client_start(state.algo_state, state.server,
                                        state.clients)
        x_star, opt_state, losses = local_steps(
            loss_fn, optimizer, starts, state.opt_state, batches, s)
        algo_state, server, clients = algorithm.aggregate(
            state.algo_state, state.server, state.clients, x_star, active,
            p_t, state.round)
        last_active = torch.where(active, state.round, state.last_active)
        new_state = FedState(
            server=server, clients=clients, opt_state=opt_state,
            algo_state=algo_state, link_state=link_state,
            round=state.round + 1, last_active=last_active)
        metrics = {
            "loss": losses.mean(-1),
            "num_active": active.sum(-1),
            "active": active,
            "staleness": (state.round - state.last_active).float(),
        }
        return new_state, metrics

    return round_fn


# Metrics stacked per round by run_rounds. "active" ([B, K, m] bool) is
# cheap but redundant with staleness for most consumers.
DEFAULT_METRIC_KEYS = ("loss", "num_active", "staleness")


def make_round_step(round_fn, source):
    """One (sample batch -> run round) step over a ``DataSource``:
    ``step(state, ds_state, draws: RoundDraws) -> (state, ds_state, metrics)``."""

    def step(state: FedState, ds_state, draws: RoundDraws):
        batches, ds_state = source.sample(ds_state, state.round, draws.pick)
        state, metrics = round_fn(state, batches, draws.u)
        return state, ds_state, metrics

    return step


def _empty_metrics(state: FedState, metric_keys) -> Dict[str, torch.Tensor]:
    B, m = state.last_active.shape
    dev = state.server.device
    shapes = {"loss": ((B, 0), torch.float32),
              "num_active": ((B, 0), torch.int64),
              "active": ((B, 0, m), torch.bool),
              "staleness": ((B, 0, m), torch.float32)}
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
    ``round -> RoundDraws`` callable).
    """
    dev = resolve_device(device)
    round_fn = make_round_fn(loss_fn, optimizer, algorithm, link, fed_cfg,
                             algo_id=algo_id, use_kernel=use_kernel,
                             strategy=strategy, cohort_size=cohort_size)
    step = make_round_step(round_fn, source)

    def run_rounds(state: FedState, ds_state, draw, num_rounds: int):
        if state.server.device.type != dev.type:
            raise ValueError(f"state is on {state.server.device}, the runner "
                             f"on {dev}")
        return run_rounds_loop(state, ds_state, draw, num_rounds,
                               metric_keys=metric_keys, step=step)

    return run_rounds

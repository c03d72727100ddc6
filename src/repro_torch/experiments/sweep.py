"""Batched experiment runner (trajectory axis) + the sweep CLI (port of
``repro.experiments.sweep``).

One (algorithm family, link scheme) grid cell is B = algos x points x seeds
trajectories. ``make_batched_run_rounds`` runs the whole pipeline

    init params -> init_fed_state -> K rounds -> periodic eval

over that one leading batch axis: every tensor carries ``[B]``, so a round
is one pass of batched kernels for all B trajectories (the reference's
``vmap``). What varies within a cell is data in a ``CellBatch``:

- ``gens``/``gen_index`` per-seed ``torch.Generator`` bundles (the
  reference's per-seed key bundles) and the trajectory -> bundle map;
- ``p_base``  per-trajectory Eq.-9 connection probabilities ``[B, m]``;
- ``hparams`` per-trajectory ``[B]`` tensors (``lr``, ``gamma``,
  ``period``) that the factories consume, and with a strategy axis the
  buffer knobs (``repro_torch.scale.STRATEGY_KNOB_FIELDS``);
- ``data``    per-trajectory ``ds_state`` (the partition ``idx [B, m, pc]``);
- ``shared``  the dataset, one copy for every trajectory;
- ``algo_id`` per-trajectory algorithm index ``[B]`` into an
  ``AlgorithmSpec`` family table (None: no algorithm axis).

CLI::

    python -m repro_torch.experiments.sweep --device cuda \\
        --algos fedpbc,fedavg --schemes bernoulli_tv --seeds 0,1,2 \\
        --rounds 100 --clients 100 --lrs 0.05,0.1 --out build/sweeps

    python -m repro_torch.experiments.sweep --device cpu --algos fedpbc \
        --schemes bernoulli_ti --seeds 0 --rounds 6 --eval-every 3 \
        --clients 10000 --cohort 256 --buffer-size 128 --deadline-rounds 3

    python -m repro_torch.experiments.sweep --device cpu \
        --algos fedpbc,fedavg,fedavg_all,fedavg_known_p --seeds 0 \
        --rounds 4 --eval-every 2 --clients 4 --local-steps 2 --task lm \
        --lm-d-model 32 --lm-layers 1 --lm-seq 16

(the second: cross-device scale, a sync and a buffered arm over a C = 256
cohort of m = 10,000 clients, as one batch; the third: the LM task, a
reduced smollm-class transformer as every client's model; ``python -m
repro_torch.experiments`` is the same CLI.)
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.configs import FederationConfig
from repro_torch.core.algorithms import AlgorithmSpec, as_algorithm
from repro_torch.core.federated import (
    DEFAULT_METRIC_KEYS,
    GeneratorDraws,
    clone_generator,
    init_fed_state,
    make_round_fn,
    make_round_step,
    run_rounds_loop,
)
from repro_torch.core.params import gmap
from repro_torch.device import resolve_device
from repro_torch.scale.buffer import STRATEGY_KNOB_FIELDS


def seed_generators(seed: int, device=None) -> Dict[str, torch.Generator]:
    """The per-seed generator bundle, seeded like the reference's key bundle
    (params=seed+1, state=seed+2, ds=seed+3, data=seed+4), plus the cohort
    stream (seed+5; the reference splits its cohort key off the state key).
    Same seed, same streams; the numbers differ from ``jax.random``'s."""
    dev = torch.device("cpu" if device is None else device)
    out = {}
    for i, name in enumerate(("params", "state", "ds", "data", "cohort"),
                             start=1):
        g = torch.Generator(device=dev)
        g.manual_seed(seed + i)
        out[name] = g
    return out


@dataclass
class CellBatch:
    """Everything one (algorithm-family, scheme) cell consumes; tensors carry
    a leading ``[B]`` (B = algos x points x seeds) except ``shared``."""

    gens: List[Dict[str, torch.Generator]]   # one bundle per seed
    gen_index: List[int]                      # [B] trajectory -> bundle
    p_base: torch.Tensor                      # [B, m]
    hparams: Dict[str, torch.Tensor]          # [B] each (lr, gamma, period)
    data: Any                                 # per-trajectory ds_state
    shared: Any                               # the dataset, unbatched
    algo_id: Optional[torch.Tensor] = None    # [B] int64, or None (no axis)
    # each bundle's seed (GeneratorDraws' tags: re-packed carries share a
    # bundle per (seed, draws made)); None: bundles are never shared
    gen_tags: Optional[List[Any]] = None

    @property
    def batch_size(self) -> int:
        return self.p_base.shape[0]


def make_batched_run_rounds(loss_fn: Callable, algorithm,
                            fed_cfg: FederationConfig, *,
                            optimizer_factory: Callable,
                            link_factory: Callable,
                            source_factory: Callable,
                            init_params: Callable,
                            num_rounds: int,
                            eval_every: int = 0,
                            eval_fn: Optional[Callable] = None,
                            metric_keys=DEFAULT_METRIC_KEYS,
                            use_kernel: bool = False,
                            cohort_size: Optional[int] = None,
                            buffered: bool = False,
                            shard_mesh=None,
                            carry_out: bool = False,
                            device=None):
    """Build the B-trajectory runner for one grid cell.

    Args mirror the reference: ``optimizer_factory(hparams)``,
    ``link_factory(p_base [B, m], hparams)``, ``source_factory(shared)``,
    ``init_params(generator) -> [n]``; ``eval_fn(server [B, n], shared) ->
    [B]`` runs every ``eval_every`` rounds under the contract "always at
    least one eval, the last at round K" (``eval_rounds``). ``use_kernel``
    routes a fusable family's server aggregation through the fused kernel:
    one launch per round for the whole batch. ``device=None`` is the card.

    ``cohort_size`` / ``buffered``: the cross-device scale engines (they need
    an ``AlgorithmSpec``). ``cohort_size=C`` runs stateless clients over a
    drawn ``[B, C]`` cohort; ``buffered`` runs the buffered fold with each
    trajectory's knobs read from the batch's hparam columns
    (``STRATEGY_KNOB_FIELDS``), so a (SYNC, buffered) grid is one batch
    through one round function. A fusable family carries a ``BufferState``
    in either mode; ``use_kernel`` launches nothing there, as in the
    reference.

    Returns ``run(batch, draws=None) -> (states, out)``: ``states`` the final
    ``FedState`` (leading ``[B]``), ``out["metrics"]`` each key ``[B, K,
    ...]``, ``out["evals"]`` ``[B, E]``. ``draws`` replaces the batch's
    ``GeneratorDraws`` (anything with its ``params``/``link_init``/call;
    ``step`` below also needs its ``copy``). ``run`` draws from copies of
    the batch's generators, so a batch gives the same run each time.

    ``run.init(batch, draws=None) -> carry`` and ``run.step(carry, batch)
    -> (carry, out)`` are its two halves, ``run(batch) == step(init(batch),
    batch)``: the carry is ``(FedState, ds_state, drawer)``, the drawer
    holding the position of every random stream, so segments chained with
    ``step`` equal one uninterrupted run bit for bit, with the same eval
    cadence. ``carry_out=True`` makes ``run`` itself return ``(carry,
    out)`` (the reference's resumable segment; the adaptive search's
    building block). ``step`` advances a copy of the carry's drawer and
    leaves the passed carry valid: the reference's donation of the carry
    buffers has no counterpart in eager PyTorch, whose round makes new
    tensors anyway. Re-pack carries with ``gather_carry`` and
    ``select_carry``; a carry's ``FedState.round`` may be a ``[B]`` tensor.

    ``shard_mesh``: a 2-D ``("batch", "model")`` mesh
    (``repro_torch.launch.mesh.make_2d_mesh``) making the runner the
    sharded path of ``repro_torch.experiments.shard.run_sharded_2d``. It
    then runs in the mesh's pool workers (``repro_torch.sharding.pool``),
    one per rank, each on its batch rows: a model rank holds ``m / model``
    clients of every trajectory (their parameters and optimizer leaves) and
    trains them on their columns of the round's batches, and the local
    updates are all-gathered over ``"model"`` before the aggregation
    (``make_round_fn(gather_updates=...)``), which every model rank
    computes on the full ``[B, m, n]`` with the server kept whole. The
    final state is gathered back to all m clients (not in ``carry_out``
    mode, whose carry keeps each rank's own, as the reference's does); the
    evals read the whole server. The reference slices the server per leaf
    over ``"model"`` (``spec_for_shape``); that changes memory, not
    results. A call of ``run_sharded_2d`` with ``activation_spec=P(None,
    "model", None)`` splits each sequence over ``"model"`` instead
    (``pool.SequenceAxis``): every model rank holds all m clients, trains
    them on its tokens of every sequence, and all-reduces the gradients
    and losses; nothing is taken or gathered. The same runner serves both
    placements.
    """
    scale_mode = buffered or cohort_size is not None
    if scale_mode and not isinstance(algorithm, AlgorithmSpec):
        raise ValueError(
            "cohort_size/buffered need an AlgorithmSpec runner (got "
            f"{type(algorithm).__name__})")
    # stateful rules take the sparse cohort path; only fusable families
    # carry a BufferState
    has_buffer = scale_mode and algorithm.fusable
    if shard_mesh is not None and not (
            {"batch", "model"} <= set(shard_mesh.axis_names)):
        raise ValueError(
            f'shard_mesh needs ("batch", "model") axes, got '
            f"{shard_mesh.axis_names}")
    dev = resolve_device(device)
    do_eval = eval_fn is not None and eval_every > 0
    # round spans between evals: the eval_rounds contract (>= 1 eval, the
    # last at num_rounds; num_rounds == 0 evals the initial model)
    spans = [num_rounds]
    if do_eval:
        at = eval_rounds(num_rounds, eval_every)
        spans = [b - a for a, b in zip([0] + at[:-1], at)]

    def parts(batch: CellBatch):
        if batch.p_base.device.type != dev.type:
            raise ValueError(f"batch is on {batch.p_base.device}, the runner "
                             f"on {dev}")
        algo_id = 0 if batch.algo_id is None else batch.algo_id
        algo = as_algorithm(algorithm, algo_id, use_kernel=use_kernel)
        optimizer = optimizer_factory(batch.hparams)
        link = link_factory(batch.p_base, batch.hparams)
        source = source_factory(batch.shared)
        return algo_id, algo, optimizer, link, source

    def init(batch: CellBatch, draws=None):
        """The batch's initial carry ``(FedState, ds_state, drawer)``."""
        _, algo, optimizer, link, source = parts(batch)
        if draws is None:
            draws = GeneratorDraws(
                [{k: clone_generator(g) for k, g in b.items()}
                 for b in batch.gens],
                batch.gen_index, num_clients=fed_cfg.num_clients,
                pick_spec=source.pick_spec, cohort_size=cohort_size,
                tags=batch.gen_tags)
        with torch.no_grad():
            server = draws.params(init_params)
            st = init_fed_state(draws.link_init(), server, fed_cfg, algo,
                                link, optimizer,
                                stateless_clients=cohort_size is not None,
                                buffered=has_buffer)
            ds = source.init(batch.data)
            axis = _model_axis(shard_mesh)
            if _splits_clients(axis):       # this rank's clients only
                st = _map_clients(lambda x: axis.take(x).clone(), st)
        return st, ds, draws

    def advance(carry, batch: CellBatch):
        """``num_rounds`` rounds from ``carry`` with the eval cadence:
        ``(carry', out)``; the carry's drawer advances."""
        st, ds, draws = carry
        algo_id, algo, optimizer, link, source = parts(batch)
        axis = _model_axis(shard_mesh)
        if scale_mode:
            # the scale engines dispatch the spec themselves (they need the
            # family table, not a bound Algorithm)
            strat = ({k: batch.hparams[k] for k in STRATEGY_KNOB_FIELDS}
                     if buffered else None)
            round_fn = make_round_fn(loss_fn, optimizer, algorithm, link,
                                     fed_cfg, algo_id=algo_id,
                                     strategy=strat, cohort_size=cohort_size,
                                     gather_updates=axis)
        else:
            round_fn = make_round_fn(loss_fn, optimizer, algo, link, fed_cfg,
                                     gather_updates=axis)
        with torch.no_grad():
            round_step = make_round_step(round_fn, source)
            pieces, evals = [], []
            for span in spans:
                st, ds, mets = run_rounds_loop(st, ds, draws, span,
                                               step=round_step,
                                               metric_keys=metric_keys)
                pieces.append(mets)
                if do_eval:
                    evals.append(eval_fn(st.server, batch.shared))
            if _splits_clients(axis) and not carry_out:
                # the final gather: every client back on every model rank
                # (the server and the eval inputs are whole throughout)
                st = _map_clients(
                    lambda x: axis.gather(x) if x.shape[1] else x, st)
        out = {"metrics": {k: torch.cat([m[k] for m in pieces], 1)
                           for k in metric_keys}}
        if do_eval:
            out["evals"] = torch.stack(evals, 1)
        return (st, ds, draws), out

    def step(carry, batch: CellBatch):
        """``advance`` from a copy of the carry's drawer: ``carry`` stays
        valid."""
        st, ds, draws = carry
        return advance((st, ds, draws.copy()), batch)

    def run(batch: CellBatch, draws=None):
        carry, out = advance(init(batch, draws), batch)
        return (carry if carry_out else carry[0]), out

    run.init = init
    run.step = step
    run.carry_out = carry_out
    run.shard_mesh = shard_mesh
    return run


def make_vmap_run_rounds(loss_fn: Callable, optimizer, algorithm,
                         fed_cfg: FederationConfig, source, *,
                         link_factory: Callable,
                         init_params: Callable,
                         num_rounds: int,
                         eval_every: int = 0,
                         eval_fn: Optional[Callable] = None,
                         metric_keys=DEFAULT_METRIC_KEYS,
                         use_kernel: bool = False,
                         device=None):
    """The seed-axis runner (the reference's ``make_vmap_run_rounds``): S
    seeds of one cell as one batch, with the optimizer and a
    constant-capturing ``DataSource`` fixed at build time. A thin wrapper
    over ``make_batched_run_rounds`` at a single point: no hparam columns,
    no per-trajectory data, no shared dataset; ``link_factory(p [S, m])``
    and ``eval_fn(server [S, n]) -> [S]`` take no hparams.

    Returns ``run(gens, p_base, draws=None) -> (states, out)``: ``gens``
    one ``seed_generators`` bundle per seed (the reference's
    ``stack_seed_keys`` bundle), ``p_base`` ``[S, m]``; ``draws`` as in
    ``make_batched_run_rounds``. ``run.init_batch`` and ``run.scan_batch``
    are the core's two halves (``init(batch)``, ``step(carry, batch)``),
    and ``run.batch(gens, p_base)`` the ``CellBatch`` they take."""
    dev = resolve_device(device)
    core = make_batched_run_rounds(
        loss_fn, algorithm, fed_cfg,
        optimizer_factory=lambda hp: optimizer,
        link_factory=lambda p, hp: link_factory(p),
        source_factory=lambda shared: source,
        init_params=init_params, num_rounds=num_rounds,
        eval_every=eval_every,
        eval_fn=(lambda server, shared: eval_fn(server))
        if eval_fn is not None else None,
        metric_keys=metric_keys, use_kernel=use_kernel, device=dev)

    def batch(gens, p_base) -> CellBatch:
        return CellBatch(gens=list(gens), gen_index=list(range(len(gens))),
                         p_base=torch.as_tensor(p_base, dtype=torch.float32,
                                                device=dev),
                         hparams={}, data=None, shared=None)

    def run(gens, p_base, draws=None):
        return core(batch(gens, p_base), draws=draws)

    run.batch = batch
    run.init_batch = core.init
    run.scan_batch = core.step
    return run


def _model_axis(shard_mesh):
    """The calling rank's model-axis hook of ``shard_mesh`` for the call in
    progress (``WorkerContext.axis``: its ``ModelAxis``, or its
    ``SequenceAxis`` when the call splits sequences; None without a mesh,
    or with a model axis of 1): a runner built for a mesh runs in that
    mesh's pool workers."""
    if shard_mesh is None:
        return None
    from repro_torch.sharding import pool

    try:
        ctx = pool.worker_context()
    except RuntimeError:
        raise RuntimeError(
            "a runner built with shard_mesh runs in the mesh's pool workers: "
            "call it through repro_torch.experiments.shard.run_sharded_2d"
        ) from None
    if ctx.mesh != shard_mesh:
        raise ValueError(f"runner built for {shard_mesh} called in a worker "
                         f"of {ctx.mesh}")
    return ctx.axis()


def _splits_clients(axis) -> bool:
    """Whether a model-axis hook holds only its rank's clients (a
    ``ModelAxis``; a ``SequenceAxis`` holds them all)."""
    return axis is not None and not getattr(axis, "splits_sequence", False)


def _map_clients(fn, st):
    """``fn`` over the state's per-client buffers: the clients (each
    parameter group) and every optimizer leaf."""
    return dataclasses.replace(
        st, clients=gmap(fn, st.clients),
        opt_state={k: gmap(fn, v) for k, v in st.opt_state.items()})


def map_carry(fn, *parts):
    """``fn`` over the leaves of carry parts of one structure (dicts,
    tuples, lists, dataclasses; ``None`` stays ``None``): the leaves are
    ``[B]``-leading tensors and the round, an ``int`` or a ``[B]`` tensor.
    The carry helpers below are this walk with a leaf each."""
    x = parts[0]
    if x is None:
        return None
    if isinstance(x, (torch.Tensor, int)):
        return fn(*parts)
    if isinstance(x, dict):
        return {k: map_carry(fn, *(p[k] for p in parts)) for k in x}
    if isinstance(x, (tuple, list)):
        return type(x)(map_carry(fn, *v) for v in zip(*parts))
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: map_carry(fn, *(getattr(p, f.name) for p in parts))
            for f in dataclasses.fields(x)})
    raise TypeError(f"cannot walk a carry part of type {type(x).__name__}")


def _round_rows(xs, sizes, dev) -> torch.Tensor:
    """Rounds of carries of ``sizes`` rows (ints or ``[B]`` tensors) as one
    ``[sum(sizes)]`` int64 tensor."""
    return torch.cat([torch.full((n,), v, dtype=torch.long, device=dev)
                      if isinstance(v, int) else v.to(dev, torch.long)
                      for v, n in zip(xs, sizes)])


def gather_carry(carry, rows: Sequence[int]):
    """The carry of rows ``rows`` (repeats allowed): every ``[B]`` leaf of
    the ``FedState`` and ``ds_state`` gathered, the drawer re-packed with
    copies of those rows' bundles (the reference's
    ``jax.tree.map(lambda x: x[rows], carry)``)."""
    st, ds, draws = carry
    idx = torch.as_tensor(list(rows), dtype=torch.long,
                          device=st.server.device)

    def take(x):
        return x if isinstance(x, int) else x[idx.to(x.device)]
    return map_carry(take, st), map_carry(take, ds), draws.take(rows)


def select_carry(mask: Sequence[bool], survivors, fresh):
    """Row ``b`` of ``survivors`` where ``mask[b]``, else of ``fresh`` (the
    reference's ``jnp.where`` pick for a batch mixing carried survivors and
    freshly initialised candidates). The rounds differ, so the result's
    ``FedState.round`` is a ``[B]`` tensor."""
    st_s, ds_s, dr_s = survivors
    st_f, ds_f, dr_f = fresh
    dev = st_s.server.device
    mask_t = torch.as_tensor(list(mask), dtype=torch.bool, device=dev)

    def pick(a, b):
        if isinstance(a, int) or isinstance(b, int):      # the round
            if isinstance(a, int) and isinstance(b, int) and a == b:
                return a
            n = len(mask_t)
            return torch.where(mask_t, _round_rows([a], [n], dev),
                               _round_rows([b], [n], dev))
        sel = mask_t.to(a.device).reshape((-1,) + (1,) * (a.dim() - 1))
        return torch.where(sel, a, b)
    return (map_carry(pick, st_s, st_f), map_carry(pick, ds_s, ds_f),
            dr_s.select(list(mask), dr_f))


def concat_carries(carries):
    """The rows of every carry, one after another (a wave's batches as one
    gather pool); an int round stays one where every carry has it."""
    if len(carries) == 1:
        return carries[0]
    sizes = [c[0].server.shape[0] for c in carries]
    dev = carries[0][0].server.device

    def cat(*xs):
        if all(isinstance(v, int) for v in xs) and len(set(xs)) == 1:
            return xs[0]
        if any(isinstance(v, int) for v in xs):           # the round
            return _round_rows(xs, sizes, dev)
        return torch.cat(xs)
    return (map_carry(cat, *(c[0] for c in carries)),
            map_carry(cat, *(c[1] for c in carries)),
            type(carries[0][2]).concat([c[2] for c in carries]))


def eval_rounds(num_rounds: int, eval_every: int):
    """Round indices (1-based) at which the runner's evals fire: at least
    one, the last at ``num_rounds`` (``num_rounds == 0`` evals the initial
    model once); ``eval_every <= 0`` means one eval at the final round."""
    if eval_every <= 0:
        return [num_rounds]
    n_chunks, rem = divmod(num_rounds, eval_every)
    out = [eval_every * (i + 1) for i in range(n_chunks)]
    if rem or not out:
        out.append(num_rounds)
    return out


def _float_list(text: str):
    return tuple(float(v) for v in text.split(",")) if text else ()


def main(argv=None) -> None:
    import argparse
    import time

    # lazy: grid imports this module
    from repro_torch.experiments.grid import ALGOS, SCHEMES, SweepSpec, run_sweep
    from repro_torch.experiments.results import ResultsStore
    from repro_torch.scale import SYNC, Strategy

    ap = argparse.ArgumentParser(
        description="Run a (algorithm x scheme x hyperparameter x seed) "
                    "sweep on the PyTorch port; every state-compatible "
                    "group of --algos, with every point of the "
                    "--lrs/--gammas/--alphas/--sigma0s/--deltas axes, runs "
                    "as one batch of trajectories per scheme. With --out "
                    "the rows are appended to a JSONL/npz results store.")
    ap.add_argument("--algos", default="fedpbc,fedavg",
                    help=f"comma list from {','.join(ALGOS)}")
    ap.add_argument("--schemes", default="bernoulli_ti",
                    help=f"comma list from {','.join(SCHEMES)}")
    ap.add_argument("--seeds", default="0,1,2", help="comma list of ints")
    ap.add_argument("--rounds", type=int, default=100)
    ap.add_argument("--eval-every", type=int, default=25)
    ap.add_argument("--clients", type=int, default=100)
    ap.add_argument("--local-steps", type=int, default=5)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--alpha", type=float, default=0.1)
    ap.add_argument("--gamma", type=float, default=0.5)
    ap.add_argument("--delta", type=float, default=0.02)
    ap.add_argument("--sigma0", type=float, default=10.0)
    ap.add_argument("--lrs", default="", help="comma list; hyperparameter "
                    "axis overriding --lr (one batch, no rebuild)")
    ap.add_argument("--gammas", default="", help="axis overriding --gamma")
    ap.add_argument("--alphas", default="", help="axis overriding --alpha")
    ap.add_argument("--sigma0s", default="", help="axis overriding --sigma0")
    ap.add_argument("--deltas", default="", help="axis overriding --delta")
    ap.add_argument("--task", default="classification",
                    choices=("classification", "lm"),
                    help="client workload: the paper's classification task "
                    "or the smollm-class reduced LM (next-token loss over "
                    "the styled byte-level corpus)")
    ap.add_argument("--lm-d-model", type=int, default=64,
                    help="LM task: reduced model width")
    ap.add_argument("--lm-layers", type=int, default=2,
                    help="LM task: reduced layer count")
    ap.add_argument("--lm-seq", type=int, default=32,
                    help="LM task: training sequence length")
    ap.add_argument("--cohort", type=int, default=None,
                    help="per-round cohort size C (cross-device scale mode: "
                    "stateless clients, O(C) round memory)")
    ap.add_argument("--buffer-size", type=int, default=0,
                    help="add a buffered semi-async strategy arm committing "
                    "when this many updates have arrived (0: sync only)")
    ap.add_argument("--deadline-rounds", type=int, default=4,
                    help="buffered arm: commit after this many rounds even "
                    "if the buffer has not filled")
    ap.add_argument("--staleness-discount", type=float, default=0.0,
                    help="buffered arm: per-round decay of the standing "
                    "buffer, in [0, 1)")
    ap.add_argument("--wait-for-full", action="store_true",
                    help="buffered arm: commit ONLY when the buffer fills "
                    "(ignore the deadline)")
    ap.add_argument("--buffered-only", action="store_true",
                    help="drop the sync arm when --buffer-size is set")
    ap.add_argument("--out", default=None,
                    help="results-store directory (JSONL + npz) to append "
                    "the rows to (default: print only)")
    ap.add_argument("--suite", default="cli", help="suite tag on the records")
    ap.add_argument("--use-kernel", action="store_true",
                    help="server update through the fused Triton kernel")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without it)")
    args = ap.parse_args(argv)

    strategies = (SYNC,)
    if args.buffer_size:
        arm = Strategy("buffered", wait_for_full=args.wait_for_full,
                       buffer_size=args.buffer_size,
                       deadline_rounds=args.deadline_rounds,
                       staleness_discount=args.staleness_discount)
        strategies = (arm,) if args.buffered_only else (SYNC, arm)
    spec = SweepSpec(
        algorithms=tuple(args.algos.split(",")),
        schemes=tuple(args.schemes.split(",")),
        seeds=tuple(int(s) for s in args.seeds.split(",")),
        rounds=args.rounds, eval_every=args.eval_every,
        num_clients=args.clients, local_steps=args.local_steps,
        lr=args.lr, alpha=args.alpha, gamma=args.gamma, delta=args.delta,
        sigma0=args.sigma0,
        lrs=_float_list(args.lrs), gammas=_float_list(args.gammas),
        alphas=_float_list(args.alphas), sigma0s=_float_list(args.sigma0s),
        deltas=_float_list(args.deltas),
        strategies=strategies, cohort_size=args.cohort,
        task=args.task, lm_d_model=args.lm_d_model,
        lm_layers=args.lm_layers, lm_seq=args.lm_seq,
        use_kernel=args.use_kernel or None)
    store = ResultsStore(args.out) if args.out else None
    print("sweep,scheme,algo,strategy,hparams,seeds,test_acc_mean,"
          "test_acc_ci95,train_acc_mean", flush=True)
    t0 = time.perf_counter()
    for cell in run_sweep(spec, store=store, suite=args.suite,
                          device=args.device):
        s = cell.summary()
        hp = ";".join(f"{k}={v:g}" for k, v in sorted(cell.hparams.items()))
        print(f"sweep,{cell.scheme},{cell.algo},{cell.strategy},{hp},"
              f"{len(cell.seeds)},"
              f"{s['test_acc']['mean']:.4f},{s['test_acc']['ci95']:.4f},"
              f"{s['train_acc']['mean']:.4f}", flush=True)
    print(f"# {time.perf_counter() - t0:.3f} s", flush=True)
    if store is not None:
        print(f"# results appended to {store.path}", flush=True)


if __name__ == "__main__":
    main()

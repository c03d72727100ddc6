"""Declarative sweep grids: ``SweepSpec`` -> batched device simulations
(port of ``repro.experiments.grid``).

A paper evaluation is a grid of ``(algorithm x unreliable-link scheme x
hyperparameter point x seed)`` cells. The executor walks the *algorithm
family x scheme* axes in Python and runs every other axis as one batch of
trajectories (``repro_torch.experiments.sweep.make_batched_run_rounds``):
state-compatible algorithms (``algo_family``: fedpbc / fedavg / fedavg_all /
fedavg_known_p) share one batch through a per-trajectory ``algo_id``, and
the ``lrs x gammas x alphas x sigma0s x deltas`` product is flattened with
the seeds (and the buffered ``strategies`` axis) into the same leading
axis. ``cohort_size`` runs the cross-device cohort engine
(``repro_torch.scale``). ``run_sweep(store=...)`` appends one row per
(cell, strategy, point) to a ``ResultsStore`` in the reference's layout.

Entry points run on the card (``device=None``) and raise without CUDA.
``mesh``/``devices`` split a cell's batch over several devices, one worker
process each (``repro_torch.experiments.shard``); by default
(``mesh="auto"``) whenever more than one card is visible.
"""
from __future__ import annotations

import dataclasses
import itertools
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import FederationConfig
from repro_torch.core.algorithms import (
    ALGORITHMS,
    algo_family,
    make_algorithm_spec,
)
from repro_torch.core.connectivity import build_base_probs, make_link_process
from repro_torch.device import resolve_device
from repro_torch.experiments.results import (
    ResultsStore,
    buffered_summary,
    summarize,
)
from repro_torch.experiments.shard import (
    AUTO,
    RunnerRecipe,
    commit,
    pad_batch,
    resolve_batch_mesh,
    run_committed,
)
from repro_torch.experiments.sweep import (
    CellBatch,
    eval_rounds,
    make_batched_run_rounds,
    seed_generators,
)
from repro_torch.experiments.tasks import (
    ClassificationTask,
    TracedClassificationTask,
    make_classification_task,
    make_traced_classification_task,
    make_traced_lm_task,
)
from repro_torch.kernels.dispatch import FUSED_OPS, resolve_use_kernel
from repro_torch.optim import paper_decay, sgd
from repro_torch.scale.buffer import (
    BUFFER_METRIC_KEYS,
    SYNC,
    Strategy,
    strategy_knob_columns,
)

# The paper's evaluation grid (§7.2): 7 algorithms x 6 link schemes.
ALGOS = ("fedpbc", "fedavg", "fedavg_all", "fedau", "f3ast",
         "fedavg_known_p", "mifa")

SCHEMES = {
    "bernoulli_ti": dict(scheme="bernoulli", time_varying=False),
    "bernoulli_tv": dict(scheme="bernoulli", time_varying=True),
    "markov_hom": dict(scheme="markov", time_varying=False),
    "markov_nonhom": dict(scheme="markov", time_varying=True),
    "cyclic": dict(scheme="cyclic", cyclic_reset=False),
    "cyclic_reset": dict(scheme="cyclic", cyclic_reset=True),
}

# The batched knobs, in flattening order: a hyperparameter point is one
# (lr, gamma, alpha, sigma0, delta) combination.
HPARAM_FIELDS = ("lr", "gamma", "alpha", "sigma0", "delta")


@dataclass(frozen=True)
class SweepSpec:
    """One declarative grid (the reference's fields). The scalar fields give
    the default hyperparameter point; the plural axes override them with a
    swept list whose product is flattened, with ``seeds`` and (within a
    family) ``algorithms``, into one batch axis.

    Validated at construction: empty or duplicated ``algorithms``/
    ``schemes``/``seeds``/``strategies``, unknown names, malformed strategy
    knobs and a ``cohort_size`` outside ``[1, num_clients]`` raise
    ``ValueError`` naming the field.
    """

    algorithms: Tuple[str, ...] = ("fedpbc", "fedavg")
    schemes: Tuple[str, ...] = ("bernoulli_ti",)
    seeds: Tuple[int, ...] = (0,)
    rounds: int = 100
    eval_every: int = 25            # <= 0: single eval at the final round
    # federation protocol
    num_clients: int = 100
    local_steps: int = 5
    batch_size: int = 32
    lr: float = 0.1                 # paper_decay base LR
    # Eq.-9 / heterogeneity knobs
    alpha: float = 0.1
    sigma0: float = 10.0
    delta: float = 0.02
    gamma: float = 0.5
    # hyperparameter axes (empty tuple -> the scalar field above)
    lrs: Tuple[float, ...] = ()
    gammas: Tuple[float, ...] = ()
    alphas: Tuple[float, ...] = ()
    sigma0s: Tuple[float, ...] = ()
    deltas: Tuple[float, ...] = ()
    # shared-dataset / model knobs
    data_seed: int = 0
    dim: int = 32
    classes: int = 10
    hidden: int = 64
    n_per_class: int = 600
    n_train: int = 5000
    per_client: int = 64
    # server-aggregation path: True routes fusable families through the
    # fused kernel (one launch per round), False keeps the branch path,
    # None defers to the REPRO_USE_KERNEL env default
    use_kernel: Optional[bool] = None
    # cross-device scale axes (repro_torch.scale): buffered strategies
    # (SYNC alone is the synchronous engine) and the per-round cohort size
    strategies: Tuple[Strategy, ...] = (SYNC,)
    cohort_size: Optional[int] = None
    # extra FederationConfig field overrides, applied last
    fed_overrides: Tuple[Tuple[str, Any], ...] = ()
    # workload: "classification" (the Gaussian task with the MLP) or "lm"
    # (a reduced transformer over the styled corpus, tasks.
    # make_traced_lm_task). For "lm" the lm_* knobs shape the model and the
    # corpus, classes is the number of corpus styles, per_client /
    # local_steps / batch_size keep their meaning, and dim / hidden /
    # n_per_class / n_train are ignored
    task: str = "classification"
    lm_arch: str = "smollm-135m"
    lm_d_model: int = 64
    lm_layers: int = 2
    lm_seq: int = 32                # training context length
    lm_n_seqs: int = 256            # corpus size (train sequences)
    lm_n_test: int = 64             # held-out eval sequences

    def __post_init__(self):
        if self.task not in ("classification", "lm"):
            raise ValueError(
                f"SweepSpec.task={self.task!r}; expected 'classification' "
                f"or 'lm'")
        for axis in ("algorithms", "schemes", "seeds"):
            vals = getattr(self, axis)
            if not vals:
                raise ValueError(f"SweepSpec.{axis} is empty; give at least "
                                 f"one entry")
            if len(set(vals)) != len(vals):
                dupes = sorted({v for v in vals if vals.count(v) > 1})
                raise ValueError(
                    f"SweepSpec.{axis} contains duplicates {dupes}: each "
                    f"entry is one independent grid coordinate (duplicates "
                    f"would silently double-count rows and every mean/CI)")
        unknown = [a for a in self.algorithms if a not in ALGORITHMS]
        if unknown:
            raise ValueError(
                f"SweepSpec.algorithms contains unknown algorithms "
                f"{unknown}; available: {sorted(ALGORITHMS)}")
        unknown = [s for s in self.schemes if s not in SCHEMES]
        if unknown:
            raise ValueError(
                f"SweepSpec.schemes contains unknown schemes {unknown}; "
                f"available: {sorted(SCHEMES)}")
        if not self.strategies:
            raise ValueError(
                "SweepSpec.strategies is empty; give at least one Strategy "
                "(repro_torch.scale.SYNC is the synchronous default)")
        bad = [s for s in self.strategies if not isinstance(s, Strategy)]
        if bad:
            raise ValueError(
                f"SweepSpec.strategies entries must be "
                f"repro_torch.scale.Strategy, got "
                f"{[type(s).__name__ for s in bad]}")
        names = [s.name for s in self.strategies]
        if len(set(names)) != len(names):
            dupes = sorted({n for n in names if names.count(n) > 1})
            raise ValueError(
                f"SweepSpec.strategies contains duplicate names {dupes}: "
                f"each strategy is one independent grid coordinate")
        if self.cohort_size is not None \
                and not 1 <= self.cohort_size <= self.num_clients:
            raise ValueError(
                f"SweepSpec.cohort_size={self.cohort_size} must be in "
                f"[1, num_clients={self.num_clients}]")
        pop = self.cohort_size if self.cohort_size is not None \
            else self.num_clients
        for s in self.strategies:
            if not 1 <= s.buffer_size <= pop:
                raise ValueError(
                    f"SweepSpec.strategies[{s.name!r}].buffer_size="
                    f"{s.buffer_size} must be in [1, {pop}] (at most the "
                    f"{'cohort size' if self.cohort_size else 'client count'}"
                    f" — a larger buffer could never fill)")
            if s.deadline_rounds < 1:
                raise ValueError(
                    f"SweepSpec.strategies[{s.name!r}].deadline_rounds="
                    f"{s.deadline_rounds} must be >= 1 (the buffer commits "
                    f"at a round boundary at the earliest)")
            if not 0.0 <= s.staleness_discount < 1.0:
                raise ValueError(
                    f"SweepSpec.strategies[{s.name!r}].staleness_discount="
                    f"{s.staleness_discount} must be in [0, 1)")
        if self.strategies != (SYNC,):
            stateful = [a for a in self.algorithms if a not in FUSED_OPS]
            if stateful:
                raise ValueError(
                    f"SweepSpec.strategies has buffered entries but "
                    f"algorithms {stateful} keep per-client state; buffered "
                    f"semi-async aggregation covers the empty-state family "
                    f"{sorted(FUSED_OPS)} only")

    def hparam_points(self) -> List[Dict[str, float]]:
        """One dict per hyperparameter point, in ``itertools.product``
        order over ``HPARAM_FIELDS``."""
        axes = [tuple(getattr(self, f + "s")) or (getattr(self, f),)
                for f in HPARAM_FIELDS]
        return [dict(zip(HPARAM_FIELDS, combo))
                for combo in itertools.product(*axes)]

    def cell_config(self, algo: str, scheme: str) -> FederationConfig:
        if scheme not in SCHEMES:
            raise KeyError(f"unknown scheme {scheme!r}; available: "
                           f"{sorted(SCHEMES)}")
        if algo not in ALGORITHMS:
            raise KeyError(f"unknown algorithm {algo!r}; available: "
                           f"{sorted(ALGORITHMS)}")
        overrides = dict(self.fed_overrides)
        data_knobs = {"alpha", "sigma0", "delta", "gamma"} & set(overrides)
        if data_knobs:
            raise ValueError(
                f"set {sorted(data_knobs)} via SweepSpec fields or axes, not "
                f"fed_overrides (they are batched hyperparameter inputs)")
        kw: Dict[str, Any] = dict(
            algorithm=algo, num_clients=self.num_clients,
            local_steps=self.local_steps, gamma=self.gamma, delta=self.delta,
            sigma0=self.sigma0, alpha=self.alpha, **SCHEMES[scheme])
        kw.update(overrides)
        return FederationConfig(**kw)


@dataclass
class CellResult:
    """One grid cell's S-seed outcome at one hyperparameter point (numpy)."""

    algo: str
    scheme: str
    seeds: Tuple[int, ...]
    rounds: int
    eval_rounds: List[int]          # [E] round index of each eval
    test_acc: np.ndarray            # [S, E]
    train_acc: np.ndarray           # [S] final train accuracy
    loss: np.ndarray                # [S, K] per-round mean train loss
    num_active: np.ndarray          # [S, K] active-client counts
    hparams: Dict[str, float] = field(default_factory=dict)
    # the row's strategy-axis coordinate ("sync" = the synchronous engine)
    strategy: str = "sync"
    # population the participation summary normalizes by (0: dense sync)
    num_clients: int = 0
    # buffered-mode per-round traces (None for synchronous cells)
    commit: Optional[np.ndarray] = None             # [S, K] commit indicator
    commit_staleness: Optional[np.ndarray] = None   # [S, K] mean buffer age
    # the final server params [S, n] (flat layout; the port keeps them so
    # a caller can check or reuse the trained models)
    server: Optional[np.ndarray] = None

    def final_test(self, window: int = 3) -> np.ndarray:
        """Per-seed mean test accuracy over the last ``window`` evals."""
        w = min(window, self.test_acc.shape[1])
        return self.test_acc[:, -w:].mean(axis=1)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {"test_acc": summarize(self.final_test()),
               "train_acc": summarize(self.train_acc)}
        if self.num_clients and self.num_active.size:
            # mean per-round participation rate (of the materialized
            # population: m dense, C in cohort mode); dense sync cells leave
            # num_clients at 0 and keep the two-key summary
            out["participation"] = summarize(
                self.num_active.mean(axis=1) / self.num_clients)
        if self.commit is not None and self.commit.size:
            out.update(buffered_summary(self.commit, self.commit_staleness))
        return out


# --------------------------------------------------------------------------
# Executor
# --------------------------------------------------------------------------

_TASK_CACHE: Dict[tuple, ClassificationTask] = {}
_TRACED_TASK_CACHE: Dict[tuple, TracedClassificationTask] = {}
_PARTITION_CACHE: Dict[tuple, np.ndarray] = {}


def _task_key(spec: SweepSpec) -> tuple:
    """Dataset/model identity — alpha-free (the partition is per point)."""
    return (spec.data_seed, spec.num_clients, spec.dim, spec.classes,
            spec.hidden, spec.n_per_class, spec.n_train,
            spec.per_client, spec.local_steps, spec.batch_size,
            spec.task, spec.lm_arch, spec.lm_d_model, spec.lm_layers,
            spec.lm_seq, spec.lm_n_seqs, spec.lm_n_test)


def get_task(spec: SweepSpec, device=None) -> ClassificationTask:
    """The constant classification task at the spec's scalar alpha (the
    sequential baselines' task; the executor runs ``get_traced_task``)."""
    if spec.task != "classification":
        raise ValueError(
            f"get_task covers the constant classification baseline only; "
            f"the {spec.task!r} workload is traced-only (get_traced_task)")
    dev = resolve_device(device)
    key = _task_key(spec) + (spec.alpha, str(dev))
    if key not in _TASK_CACHE:
        _TASK_CACHE[key] = make_classification_task(
            data_seed=spec.data_seed, num_clients=spec.num_clients,
            dim=spec.dim, classes=spec.classes, hidden=spec.hidden,
            n_per_class=spec.n_per_class, n_train=spec.n_train,
            alpha=spec.alpha, per_client=spec.per_client,
            local_steps=spec.local_steps, batch_size=spec.batch_size,
            device=dev)
    return _TASK_CACHE[key]


def get_traced_task(spec: SweepSpec, device=None) -> TracedClassificationTask:
    dev = resolve_device(device)
    key = _task_key(spec) + (str(dev),)
    if key not in _TRACED_TASK_CACHE:
        if spec.task == "lm":
            _TRACED_TASK_CACHE[key] = make_traced_lm_task(
                data_seed=spec.data_seed, num_clients=spec.num_clients,
                arch=spec.lm_arch, d_model=spec.lm_d_model,
                layers=spec.lm_layers, seq_len=spec.lm_seq,
                classes=spec.classes, n_seqs=spec.lm_n_seqs,
                n_test=spec.lm_n_test, per_client=spec.per_client,
                local_steps=spec.local_steps, batch_size=spec.batch_size,
                device=dev)
        else:
            _TRACED_TASK_CACHE[key] = make_traced_classification_task(
                data_seed=spec.data_seed, num_clients=spec.num_clients,
                dim=spec.dim, classes=spec.classes, hidden=spec.hidden,
                n_per_class=spec.n_per_class, n_train=spec.n_train,
                per_client=spec.per_client, local_steps=spec.local_steps,
                batch_size=spec.batch_size, device=dev)
    return _TRACED_TASK_CACHE[key]


def get_partition(spec: SweepSpec, task, alpha: float) -> np.ndarray:
    """Cached Dirichlet(alpha) index table for the spec's dataset."""
    key = _task_key(spec) + (alpha,)
    if key not in _PARTITION_CACHE:
        _PARTITION_CACHE[key] = task.partition(alpha)
    return _PARTITION_CACHE[key]


def point_base_probs(spec: SweepSpec, point: Dict[str, float]) -> np.ndarray:
    """Per-seed Eq.-9 connection probabilities for one point, ``[S, m]``,
    each drawn from ``np.random.default_rng(seed)``."""
    return np.stack([
        build_base_probs(s, spec.num_clients, spec.classes,
                         alpha=point["alpha"], sigma0=point["sigma0"],
                         delta=point["delta"])[0]
        for s in spec.seeds])


def seed_base_probs(spec: SweepSpec) -> np.ndarray:
    """``[S, m]`` draws at the spec's scalar (default) hyperparameter
    point."""
    return point_base_probs(
        spec, dict(alpha=spec.alpha, sigma0=spec.sigma0, delta=spec.delta))


def _has_strategy_axis(spec: SweepSpec) -> bool:
    """Whether the spec runs the buffered engine: any strategy besides the
    bare synchronous default. (SYNC,) keeps the synchronous round; a single
    non-sync strategy, or (SYNC, buffered), puts the WHOLE cell on the
    buffered round, where SYNC's degenerate knobs reproduce the synchronous
    results bit for bit (``tests/test_torch_scale.py``)."""
    return spec.strategies != (SYNC,)


def make_cell_batch(spec: SweepSpec, fed: FederationConfig,
                    task: TracedClassificationTask,
                    algos: Optional[Tuple[str, ...]] = None,
                    device=None) -> CellBatch:
    """Flatten (algorithm x strategy x hyperparameter point x seed) into one
    leading batch, algo-major, then strategy-major, then point-major:
    ``b = ((algo_index * n_strategies + strategy_index) * n_points
    + point_index) * len(seeds) + seed_index`` (without a strategy axis
    n_strategies is 1). ``algos`` (default ``fed.algorithm``) must share one
    family; the ``algo_id`` column indexes that family's table. With a
    strategy axis the buffer knobs travel as four more hparam columns."""
    dev = resolve_device(device)
    if algos is None:
        algos = (fed.algorithm,)
    family = algo_family(algos[0])
    bad = [a for a in algos if a not in family]
    if bad:
        raise ValueError(
            f"algorithms {bad} are not state-compatible with {algos[0]!r} "
            f"(family {family}); run them as separate cells")
    points = spec.hparam_points()
    S = len(spec.seeds)
    probs_memo: Dict[tuple, np.ndarray] = {}

    def probs(pt):
        k = (pt["alpha"], pt["sigma0"], pt["delta"])
        if k not in probs_memo:
            probs_memo[k] = point_base_probs(spec, pt)
        return probs_memo[k]

    rows = [(a, st, pt) for a in algos for st in spec.strategies
            for pt in points]
    p_base = np.concatenate([probs(pt) for _, _, pt in rows])
    idx = np.stack([get_partition(spec, task, pt["alpha"])
                    for _, _, pt in rows for _ in range(S)])

    def col(f):
        return torch.tensor([pt[f] for _, _, pt in rows for _ in range(S)],
                            dtype=torch.float32, device=dev)

    B = len(rows) * S
    hparams = {"lr": col("lr"), "gamma": col("gamma"),
               "period": torch.full((B,), float(fed.period),
                                    dtype=torch.float32, device=dev)}
    if _has_strategy_axis(spec):
        hparams.update(strategy_knob_columns([st for _, st, _ in rows], S,
                                             device=dev))
    return CellBatch(
        gens=[seed_generators(s, dev) for s in spec.seeds],
        gen_index=[i for _ in rows for i in range(S)],
        gen_tags=list(spec.seeds),
        p_base=torch.as_tensor(p_base, device=dev),
        hparams=hparams,
        data={"idx": torch.as_tensor(idx, device=dev)},
        shared=task.shared,
        algo_id=torch.tensor([family.index(a) for a, _, _ in rows
                              for _ in range(S)], device=dev))


def make_runner(spec: SweepSpec, fed: FederationConfig, task, *,
                metric_keys=("loss", "num_active"), device=None,
                carry_out: bool = False, shard_mesh=None):
    """The batched runner of one (family, scheme) cell: the family's table,
    ``sgd(paper_decay(lr))`` and the configured link process
    (``carry_out``: the resumable segment runner; ``shard_mesh``: the 2-D
    sharded path). ``run.recipe`` is what a mesh's workers rebuild it
    from (``repro_torch.experiments.shard``)."""
    algo = make_algorithm_spec(algo_family(fed.algorithm), fed)
    run = make_batched_run_rounds(
        task.loss_fn, algo, fed,
        optimizer_factory=lambda hp: sgd(paper_decay(hp["lr"])),
        link_factory=lambda p, hp: make_link_process(
            p, fed, gamma=hp["gamma"], period=hp["period"]),
        source_factory=task.source_factory,
        init_params=task.init_params,
        num_rounds=spec.rounds,
        eval_every=spec.eval_every,
        eval_fn=task.eval_test,
        metric_keys=metric_keys,
        use_kernel=resolve_use_kernel(spec.use_kernel),
        cohort_size=spec.cohort_size,
        buffered=_has_strategy_axis(spec),
        carry_out=carry_out,
        shard_mesh=shard_mesh,
        device=device)
    run.recipe = RunnerRecipe(spec, fed, tuple(metric_keys), shard_mesh)
    return run


def runner_key(spec: SweepSpec, fed: FederationConfig, metric_keys, device,
               *extra) -> tuple:
    """A runner's structure, the reference's runner-cache key: the task's
    shape, the cell's config with its hyperparameter knobs zeroed and its
    algorithm made its family's first, the rounds and eval cadence, the
    metric keys, the kernel and scale modes, the device and ``extra``
    (a segment length, a mesh). Runners of equal keys compute alike."""
    canon = dataclasses.replace(fed, alpha=0.0, sigma0=0.0, delta=0.0,
                                gamma=0.0, period=0,
                                algorithm=algo_family(fed.algorithm)[0])
    return (_task_key(spec), canon, spec.rounds, spec.eval_every,
            tuple(metric_keys), resolve_use_kernel(spec.use_kernel),
            spec.cohort_size, _has_strategy_axis(spec), str(device)) + extra


_SEGMENT_RUNNERS: Dict[tuple, Any] = {}


def segment_runner_for(spec: SweepSpec, algo: str, scheme: str, *,
                       segment_rounds: int,
                       metric_keys=("loss", "num_active"), device=None):
    """The adaptive search's runner (``repro_torch.experiments.search``): a
    resumable ``carry_out`` runner of exactly ``segment_rounds`` rounds a
    ``step``, with ``eval_every == segment_rounds``, so each segment evals
    once, at its last round (the controller's prune signal).

    Cached under a structure-only key, as the reference's: the task's
    shape, the cell's config with its hyperparameter knobs zeroed and its
    algorithm made its family's first, the segment length, the metric
    keys, the kernel and scale modes and the device. So every candidate a
    search packs (unseen lr or gamma values, re-packed survivors, refilled
    fresh points) and the suite's resume probe use ONE runner object;
    ``segment_runner_for.built`` counts the runners made."""
    dev = resolve_device(device)
    task = get_traced_task(spec, dev)
    fed = spec.cell_config(algo, scheme)
    seg = dataclasses.replace(spec, rounds=segment_rounds,
                              eval_every=segment_rounds)
    key = runner_key(seg, fed, metric_keys, dev, "segment")
    if key not in _SEGMENT_RUNNERS:
        _SEGMENT_RUNNERS[key] = make_runner(seg, fed, task,
                                            metric_keys=metric_keys,
                                            device=dev, carry_out=True)
        segment_runner_for.built += 1
    return _SEGMENT_RUNNERS[key]


segment_runner_for.built = 0


def _batch_key(spec: SweepSpec) -> tuple:
    """Identity of a spec's fed-independent batch contents (dataset and
    model shape, seeds, strategies, cohort, hyperparameter points)."""
    return (_task_key(spec), spec.seeds, spec.strategies, spec.cohort_size,
            tuple(tuple(sorted(pt.items())) for pt in spec.hparam_points()))


# {(batch_key, mesh): {algos: Committed}}: one base entry, the most recent
# (spec, mesh), with a sub-entry per algorithm group, so a mixed-family
# sweep alternating groups per scheme commits each group's rows once
_SHARDED_BATCH_CACHE: Dict[tuple, Dict[Tuple[str, ...], Any]] = {}


def _sharded_cell_batch(spec: SweepSpec, fed: FederationConfig,
                        task: TracedClassificationTask, mesh,
                        algos: Tuple[str, ...], device):
    """``make_cell_batch`` padded to the mesh's batch axis and committed to
    its workers (``shard.commit``), memoized per (dataset, seeds, points,
    mesh) and algorithm group. ``fed`` is deliberately NOT in the key: only
    the ``[B]`` period column depends on it, and ``shard.run_committed``
    rebuilds that column in the workers per call, so cells (or sweeps)
    differing only in a ``period`` override reuse the committed rows. The
    committed slices live in the workers, which keep one base at a time,
    as this cache does; equal meshes hash equal, so a fresh auto-resolved
    mesh over the same devices still hits."""
    base = _batch_key(spec) + (mesh,)
    entry = _SHARDED_BATCH_CACHE.get(base)
    if entry is None:
        _SHARDED_BATCH_CACHE.clear()
        entry = _SHARDED_BATCH_CACHE.setdefault(base, {})
    if algos not in entry:
        padded, b_real = pad_batch(
            make_cell_batch(spec, fed, task, algos=algos, device=device),
            mesh.shape["batch"])
        entry[algos] = commit(padded, mesh, (hash(base), algos), b_real)
    return entry[algos]


def _placement(mesh, devices, dev):
    """The batch mesh of a call on ``dev``: ``mesh="auto"`` without
    ``devices`` splits only a CUDA call (over every visible card)."""
    if mesh == AUTO and devices is None and dev.type != "cuda":
        return None
    return resolve_batch_mesh(mesh, devices)


def run_batch_states(spec: SweepSpec, algos: Tuple[str, ...], scheme: str, *,
                     metric_keys=("loss", "num_active"), device=None,
                     draws=None, mesh=AUTO, devices=None):
    """Run one (state-compatible algorithm group, scheme) cell and return
    ``(task, states, out)``: the raw batched result behind the
    ``CellResult`` rows (``draws`` as in ``make_batched_run_rounds``), on
    ``device`` whatever the placement (``mesh``/``devices``: see
    ``run_cell_batch``)."""
    dev = resolve_device(device)
    task = get_traced_task(spec, dev)
    fed = spec.cell_config(algos[0], scheme)
    if _has_strategy_axis(spec):
        metric_keys = tuple(metric_keys) + tuple(
            k for k in BUFFER_METRIC_KEYS if k not in metric_keys)
    batch_mesh = _placement(mesh, devices, dev)
    # a mesh with a "model" axis selects the 2-D path: the runner itself is
    # built for the mesh (it splits each trajectory's clients)
    mesh2d = batch_mesh if (batch_mesh is not None
                            and "model" in batch_mesh.axis_names) else None
    runner = make_runner(spec, fed, task, metric_keys=metric_keys,
                         device=dev, shard_mesh=mesh2d)
    if batch_mesh is not None:
        # memoized pad + commit; padding rows are dropped right here, so
        # nothing downstream ever sees them
        states, out = run_committed(
            runner, _sharded_cell_batch(spec, fed, task, batch_mesh, algos,
                                        dev),
            batch_mesh, period=fed.period, device=dev, draws=draws)
    else:
        states, out = runner(make_cell_batch(spec, fed, task, algos=algos,
                                             device=dev), draws=draws)
    return task, states, out


def _run_batch(spec: SweepSpec, algos: Tuple[str, ...], scheme: str, *,
               metric_keys=("loss", "num_active"), device=None, mesh=AUTO,
               devices=None) -> List[CellResult]:
    """One (algorithm group, scheme) cell as ``CellResult`` rows, algo-major,
    then strategy-major, then point-major."""
    task, states, out = run_batch_states(spec, algos, scheme,
                                         metric_keys=metric_keys,
                                         device=device, mesh=mesh,
                                         devices=devices)
    with torch.no_grad():
        train_acc = task.eval_train(states.server, task.shared).cpu().numpy()
    if "evals" in out:
        test_acc = out["evals"].cpu().numpy()
        rounds_at = eval_rounds(spec.rounds, spec.eval_every)
    else:
        with torch.no_grad():
            test_acc = task.eval_test(states.server,
                                      task.shared).cpu().numpy()[:, None]
        rounds_at = [spec.rounds]
    mets = {k: v.cpu().numpy() for k, v in out["metrics"].items()}
    if "num_active" in mets:            # the reference's dtype
        mets["num_active"] = mets["num_active"].astype(np.int32)
    server = states.server.cpu().numpy()
    points = spec.hparam_points()
    S = len(spec.seeds)
    buffered = _has_strategy_axis(spec)
    strategies = spec.strategies
    n_str = len(strategies)
    B = len(algos) * n_str * len(points) * S
    # the per-round population the participation summary normalizes by
    pop = spec.cohort_size if spec.cohort_size is not None \
        else spec.num_clients

    def rows(a, ai, si, pi):
        lo = ((ai * n_str + si) * len(points) + pi) * S
        return a[lo:lo + S]

    return [
        CellResult(
            algo=algo, scheme=scheme, seeds=tuple(spec.seeds),
            rounds=spec.rounds, eval_rounds=rounds_at,
            test_acc=rows(test_acc, ai, si, pi),
            train_acc=rows(train_acc, ai, si, pi),
            loss=rows(mets.get("loss", np.zeros((B, 0))), ai, si, pi),
            num_active=rows(mets.get("num_active", np.zeros((B, 0))),
                            ai, si, pi),
            hparams=dict(pt),
            strategy=strat.name,
            # dense synchronous cells keep the two-key summary;
            # participation appears where it is informative (cohort mode
            # normalizes by C, buffered rows by the buffer's pool)
            num_clients=(pop if (strat.name != "sync"
                                 or spec.cohort_size is not None) else 0),
            commit=(rows(mets["commit"], ai, si, pi) if buffered else None),
            commit_staleness=(rows(mets["commit_staleness"], ai, si, pi)
                              if buffered else None),
            server=rows(server, ai, si, pi))
        for ai, algo in enumerate(algos)
        for si, strat in enumerate(strategies)
        for pi, pt in enumerate(points)]


def run_cell_batch(spec: SweepSpec, algo: str, scheme: str, *,
                   metric_keys=("loss", "num_active"), mesh=AUTO,
                   devices=None, device=None) -> List[CellResult]:
    """Run one (algo, scheme) cell: all hyperparameter points x seeds as one
    batch; one ``CellResult`` per point. ``device=None`` is the card.

    ``mesh``/``devices`` pick the placement
    (``repro_torch.experiments.shard.resolve_batch_mesh``): by default the
    batch splits over a ``("batch",)`` mesh of every visible card when more
    than one is (a CPU call stays in this process); ``mesh=None`` forces
    one device; ``devices=[...]`` splits over those devices, even one, one
    worker process each; a ``make_2d_mesh`` mesh also splits each
    trajectory's clients over its ``"model"`` axis. Results are those of
    the single-device path: bit for bit on the CPU's ranks."""
    return _run_batch(spec, (algo,), scheme, metric_keys=metric_keys,
                      device=device, mesh=mesh, devices=devices)


def run_cell(spec: SweepSpec, algo: str, scheme: str, *,
             metric_keys=("loss", "num_active"), mesh=AUTO, devices=None,
             device=None) -> CellResult:
    """Single-point convenience wrapper around ``run_cell_batch``."""
    n_points = len(spec.hparam_points()) * len(spec.strategies)
    if n_points != 1:
        raise ValueError(
            f"spec has {n_points} hyperparameter points x strategy rows; "
            f"use run_cell_batch for swept axes")
    return run_cell_batch(spec, algo, scheme, metric_keys=metric_keys,
                          mesh=mesh, devices=devices, device=device)[0]


def run_sweep(spec: SweepSpec, *, store: Optional[ResultsStore] = None,
              suite: str = "sweep", metric_keys=("loss", "num_active"),
              mesh=AUTO, devices=None, device=None) -> List[CellResult]:
    """Execute the full grid; with ``store``, append every (cell, strategy,
    point) row to it under ``suite``. Within each scheme, algorithms are
    grouped into state-compatible families and each group runs as ONE batch
    over the joint (algo x strategy x point x seed) axis. Results and rows
    keep the ``scheme -> algorithm -> strategy -> point`` order.
    ``device=None`` is the card.

    Rows are written as soon as spec order allows, and on a crash every
    row a finished group computed is still written before the error
    propagates, as in the reference. ``mesh``/``devices``: see
    ``run_cell_batch``."""
    dev = resolve_device(device)
    for scheme in spec.schemes:            # validate every cell upfront
        for algo in spec.algorithms:
            spec.cell_config(algo, scheme)
    n_points = len(spec.hparam_points()) * len(spec.strategies)
    cells: List[CellResult] = []
    for scheme in spec.schemes:
        groups: Dict[Tuple[str, ...], List[str]] = {}
        for algo in spec.algorithms:
            groups.setdefault(algo_family(algo), []).append(algo)
        by_algo: Dict[str, List[CellResult]] = {}
        pending = list(spec.algorithms)     # emission order

        def emit(algo):
            for cell in by_algo[algo]:
                cells.append(cell)
                if store is not None:       # the reference's keys and arrays
                    arrays = {"test_acc": cell.test_acc,
                              "train_acc": cell.train_acc, "loss": cell.loss,
                              "num_active": cell.num_active}
                    if cell.commit is not None:
                        arrays["commit"] = cell.commit
                        arrays["commit_staleness"] = cell.commit_staleness
                    store.append(
                        {"suite": suite, "algo": algo, "scheme": scheme,
                         "strategy": cell.strategy, "seeds": list(spec.seeds),
                         "rounds": spec.rounds, "eval_every": spec.eval_every,
                         "hparams": dict(cell.hparams),
                         "spec": dataclasses.asdict(spec),
                         "eval_rounds": cell.eval_rounds,
                         "summary": cell.summary()},
                        arrays=arrays)

        try:
            for group in groups.values():
                results = _run_batch(spec, tuple(group), scheme,
                                     metric_keys=metric_keys, device=dev,
                                     mesh=mesh, devices=devices)
                for ai, algo in enumerate(group):
                    by_algo[algo] = results[ai * n_points:(ai + 1) * n_points]
                while pending and pending[0] in by_algo:
                    emit(pending.pop(0))
        finally:
            # no-op on success; after a crash, the rows of every finished
            # group, including those held behind the failed family
            for algo in pending:
                if algo in by_algo:
                    emit(algo)
    return cells


__all__ = ["ALGOS", "SCHEMES", "HPARAM_FIELDS", "SYNC", "SweepSpec",
           "CellResult", "make_cell_batch", "make_runner", "run_batch_states",
           "run_cell", "run_cell_batch", "run_sweep", "get_task",
           "get_traced_task", "point_base_probs", "seed_base_probs",
           "runner_key", "segment_runner_for"]

"""Declarative sweep grids: ``SweepSpec`` -> batched device simulations
(port of ``repro.experiments.grid``).

A paper evaluation is a grid of ``(algorithm x unreliable-link scheme x
hyperparameter point x seed)`` cells. The executor walks the *algorithm
family x scheme* axes in Python and runs every other axis as one batch of
trajectories (``repro_torch.experiments.sweep.make_batched_run_rounds``):
state-compatible algorithms (``algo_family``: fedpbc / fedavg / fedavg_all /
fedavg_known_p) share one batch through a per-trajectory ``algo_id``, and
the ``lrs x gammas x alphas x sigma0s x deltas`` product is flattened with
the seeds into the same leading axis. ``run_sweep(store=...)`` appends one
row per (cell, point) to a ``ResultsStore`` in the reference's layout.

Entry points run on the card (``device=None``) and raise without CUDA.
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
from repro_torch.experiments.results import ResultsStore, summarize
from repro_torch.experiments.sweep import (
    CellBatch,
    eval_rounds,
    make_batched_run_rounds,
    seed_generators,
)
from repro_torch.experiments.tasks import (
    TracedClassificationTask,
    make_traced_classification_task,
)
from repro_torch.kernels.dispatch import resolve_use_kernel
from repro_torch.optim import paper_decay, sgd

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

SYNC = "sync"   # the synchronous engine: the only strategy of this slice
# the reference's ``dataclasses.asdict`` of its ``SYNC`` strategy, as store
# rows record it in ``spec["strategies"]``
_SYNC_RECORD = {"name": SYNC, "wait_for_full": False, "buffer_size": 1,
                "deadline_rounds": 1, "staleness_discount": 0.0}


@dataclass(frozen=True)
class SweepSpec:
    """One declarative grid (the reference's fields). The scalar fields give
    the default hyperparameter point; the plural axes override them with a
    swept list whose product is flattened, with ``seeds`` and (within a
    family) ``algorithms``, into one batch axis.

    Validated at construction: empty or duplicated ``algorithms``/
    ``schemes``/``seeds`` and unknown names raise ``ValueError`` naming the
    field. Knobs of later slices (buffered ``strategies``, ``cohort_size``,
    ``task="lm"``) raise ``NotImplementedError`` naming their ROADMAP item.
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
    # cross-device scale axes (ROADMAP Queue 1 item 3)
    strategies: Tuple[str, ...] = (SYNC,)
    cohort_size: Optional[int] = None
    # extra FederationConfig field overrides, applied last
    fed_overrides: Tuple[Tuple[str, Any], ...] = ()
    # workload; "lm" is ROADMAP Queue 1 item 5
    task: str = "classification"
    lm_arch: str = "smollm-135m"
    lm_d_model: int = 64
    lm_layers: int = 2
    lm_seq: int = 32
    lm_n_seqs: int = 256
    lm_n_test: int = 64

    def __post_init__(self):
        if self.task not in ("classification", "lm"):
            raise ValueError(
                f"SweepSpec.task={self.task!r}; expected 'classification' "
                f"or 'lm'")
        if self.task == "lm":
            raise NotImplementedError(
                "SweepSpec.task='lm' is not ported yet (ROADMAP Queue 1 "
                "item 5: LM slice)")
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
                "SweepSpec.strategies is empty; give at least one strategy "
                f"({SYNC!r} is the synchronous default)")
        if tuple(self.strategies) != (SYNC,):
            raise NotImplementedError(
                "SweepSpec.strategies beyond ('sync',) (buffered semi-async "
                "aggregation) are not ported yet (ROADMAP Queue 1 item 3: "
                "cross-device scale)")
        if self.cohort_size is not None:
            if not 1 <= self.cohort_size <= self.num_clients:
                raise ValueError(
                    f"SweepSpec.cohort_size={self.cohort_size} must be in "
                    f"[1, num_clients={self.num_clients}]")
            raise NotImplementedError(
                "SweepSpec.cohort_size is not ported yet (ROADMAP Queue 1 "
                "item 3: cross-device scale)")

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
    strategy: str = SYNC
    num_clients: int = 0
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
            # mean per-round participation rate; dense sync cells leave
            # num_clients at 0 and keep the two-key summary
            out["participation"] = summarize(
                self.num_active.mean(axis=1) / self.num_clients)
        return out


# --------------------------------------------------------------------------
# Executor
# --------------------------------------------------------------------------

_TASK_CACHE: Dict[tuple, TracedClassificationTask] = {}
_PARTITION_CACHE: Dict[tuple, np.ndarray] = {}


def _task_key(spec: SweepSpec) -> tuple:
    """Dataset/model identity — alpha-free (the partition is per point)."""
    return (spec.data_seed, spec.num_clients, spec.dim, spec.classes,
            spec.hidden, spec.n_per_class, spec.n_train,
            spec.per_client, spec.local_steps, spec.batch_size)


def get_traced_task(spec: SweepSpec, device=None) -> TracedClassificationTask:
    dev = resolve_device(device)
    key = _task_key(spec) + (str(dev),)
    if key not in _TASK_CACHE:
        _TASK_CACHE[key] = make_traced_classification_task(
            data_seed=spec.data_seed, num_clients=spec.num_clients,
            dim=spec.dim, classes=spec.classes, hidden=spec.hidden,
            n_per_class=spec.n_per_class, n_train=spec.n_train,
            per_client=spec.per_client, local_steps=spec.local_steps,
            batch_size=spec.batch_size, device=dev)
    return _TASK_CACHE[key]


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


def make_cell_batch(spec: SweepSpec, fed: FederationConfig,
                    task: TracedClassificationTask,
                    algos: Optional[Tuple[str, ...]] = None,
                    device=None) -> CellBatch:
    """Flatten (algorithm x hyperparameter point x seed) into one leading
    batch, algo-major then point-major:
    ``b = (algo_index * n_points + point_index) * len(seeds) + seed_index``.
    ``algos`` (default ``fed.algorithm``) must share one family; the
    ``algo_id`` column indexes that family's table."""
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

    rows = [(a, pt) for a in algos for pt in points]
    p_base = np.concatenate([probs(pt) for _, pt in rows])
    idx = np.stack([get_partition(spec, task, pt["alpha"])
                    for _, pt in rows for _ in range(S)])

    def col(f):
        return torch.tensor([pt[f] for _, pt in rows for _ in range(S)],
                            dtype=torch.float32, device=dev)

    B = len(rows) * S
    return CellBatch(
        gens=[seed_generators(s, dev) for s in spec.seeds],
        gen_index=[i for _ in rows for i in range(S)],
        p_base=torch.as_tensor(p_base, device=dev),
        hparams={"lr": col("lr"), "gamma": col("gamma"),
                 "period": torch.full((B,), float(fed.period),
                                      dtype=torch.float32, device=dev)},
        data={"idx": torch.as_tensor(idx, device=dev)},
        shared=task.shared,
        algo_id=torch.tensor([family.index(a) for a, _ in rows
                              for _ in range(S)], device=dev))


def make_runner(spec: SweepSpec, fed: FederationConfig, task, *,
                metric_keys=("loss", "num_active"), device=None):
    """The batched runner of one (family, scheme) cell: the family's table,
    ``sgd(paper_decay(lr))`` and the configured link process."""
    algo = make_algorithm_spec(algo_family(fed.algorithm), fed)
    return make_batched_run_rounds(
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
        device=device)


def run_batch_states(spec: SweepSpec, algos: Tuple[str, ...], scheme: str, *,
                     metric_keys=("loss", "num_active"), device=None,
                     draws=None):
    """Run one (state-compatible algorithm group, scheme) cell and return
    ``(task, states, out)``: the raw batched result behind the
    ``CellResult`` rows (``draws`` as in ``make_batched_run_rounds``)."""
    dev = resolve_device(device)
    task = get_traced_task(spec, dev)
    fed = spec.cell_config(algos[0], scheme)
    runner = make_runner(spec, fed, task, metric_keys=metric_keys,
                         device=dev)
    states, out = runner(make_cell_batch(spec, fed, task, algos=algos,
                                         device=dev), draws=draws)
    return task, states, out


def _run_batch(spec: SweepSpec, algos: Tuple[str, ...], scheme: str, *,
               metric_keys=("loss", "num_active"),
               device=None) -> List[CellResult]:
    """One (algorithm group, scheme) cell as ``CellResult`` rows, algo-major
    then point-major."""
    task, states, out = run_batch_states(spec, algos, scheme,
                                         metric_keys=metric_keys,
                                         device=device)
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
    B = len(algos) * len(points) * S

    def rows(a, ai, pi):
        lo = (ai * len(points) + pi) * S
        return a[lo:lo + S]

    return [
        CellResult(
            algo=algo, scheme=scheme, seeds=tuple(spec.seeds),
            rounds=spec.rounds, eval_rounds=rounds_at,
            test_acc=rows(test_acc, ai, pi),
            train_acc=rows(train_acc, ai, pi),
            loss=rows(mets.get("loss", np.zeros((B, 0))), ai, pi),
            num_active=rows(mets.get("num_active", np.zeros((B, 0))), ai, pi),
            hparams=dict(pt),
            server=rows(server, ai, pi))
        for ai, algo in enumerate(algos)
        for pi, pt in enumerate(points)]


def _later_slice_args(mesh, devices):
    if mesh is not None or devices is not None:
        raise NotImplementedError(
            "mesh/devices placement is not ported yet (ROADMAP Queue 1 "
            "item 6: multi-device batch split)")


def run_cell_batch(spec: SweepSpec, algo: str, scheme: str, *,
                   metric_keys=("loss", "num_active"), mesh=None,
                   devices=None, device=None) -> List[CellResult]:
    """Run one (algo, scheme) cell: all hyperparameter points x seeds as one
    batch; one ``CellResult`` per point. ``device=None`` is the card."""
    _later_slice_args(mesh, devices)
    return _run_batch(spec, (algo,), scheme, metric_keys=metric_keys,
                      device=device)


def run_cell(spec: SweepSpec, algo: str, scheme: str, *,
             metric_keys=("loss", "num_active"), mesh=None, devices=None,
             device=None) -> CellResult:
    """Single-point convenience wrapper around ``run_cell_batch``."""
    n_points = len(spec.hparam_points()) * len(spec.strategies)
    if n_points != 1:
        raise ValueError(
            f"spec has {n_points} hyperparameter points x strategy rows; "
            f"use run_cell_batch for swept axes")
    return run_cell_batch(spec, algo, scheme, metric_keys=metric_keys,
                          mesh=mesh, devices=devices, device=device)[0]


def _spec_record(spec: SweepSpec) -> Dict[str, Any]:
    """``dataclasses.asdict(spec)`` as the reference's store rows hold it:
    its ``strategies`` are ``Strategy`` dataclasses, the port's their names
    (only ``"sync"`` in this slice)."""
    out = dataclasses.asdict(spec)
    out["strategies"] = [dict(_SYNC_RECORD) for _ in spec.strategies]
    return out


def run_sweep(spec: SweepSpec, *, store: Optional[ResultsStore] = None,
              suite: str = "sweep", metric_keys=("loss", "num_active"),
              mesh=None, devices=None, device=None) -> List[CellResult]:
    """Execute the full grid; with ``store``, append every (cell, point)
    row to it under ``suite``. Within each scheme, algorithms are grouped
    into state-compatible families and each group runs as ONE batch over
    the joint (algo x point x seed) axis. Results and rows keep the
    ``scheme -> algorithm -> point`` order. ``device=None`` is the card.

    Rows are written as soon as spec order allows, and on a crash every
    row a finished group computed is still written before the error
    propagates, as in the reference."""
    _later_slice_args(mesh, devices)
    dev = resolve_device(device)
    for scheme in spec.schemes:            # validate every cell upfront
        for algo in spec.algorithms:
            spec.cell_config(algo, scheme)
    n_points = len(spec.hparam_points())
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
                    store.append(
                        {"suite": suite, "algo": algo, "scheme": scheme,
                         "strategy": cell.strategy, "seeds": list(spec.seeds),
                         "rounds": spec.rounds, "eval_every": spec.eval_every,
                         "hparams": dict(cell.hparams),
                         "spec": _spec_record(spec),
                         "eval_rounds": cell.eval_rounds,
                         "summary": cell.summary()},
                        arrays={"test_acc": cell.test_acc,
                                "train_acc": cell.train_acc, "loss": cell.loss,
                                "num_active": cell.num_active})

        try:
            for group in groups.values():
                results = _run_batch(spec, tuple(group), scheme,
                                     metric_keys=metric_keys, device=dev)
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
           "run_cell", "run_cell_batch", "run_sweep", "get_traced_task",
           "point_base_probs"]

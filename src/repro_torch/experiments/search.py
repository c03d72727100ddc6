"""Adaptive hyperparameter search over the sweep engine: successive halving
(ASHA-style) with elastic re-packing (port of ``repro.experiments.search``).

The exhaustive grid spends a full ``rounds`` budget on every hyperparameter
point, including the ones that are visibly losing after a few evals. This
controller runs a candidate population in *rung-sized segments* on the
resumable segment runner (``grid.segment_runner_for``, a
``make_batched_run_rounds(carry_out=True)`` runner): each wave runs
``rung_rounds`` rounds for every live candidate, ranks points on the eval
at the segment's end, and keeps the top ``1/eta`` of each budget level; the
rest are pruned with their truncated trajectories persisted. Survivors'
``(FedState, ds_state, drawer)`` carries are **elastically re-packed**
(``sweep.gather_carry``) into full-width batches, so a batch never runs
half-empty, and every re-pack, unseen hyperparameter value and refilled
candidate rides ONE runner object per (family, scheme).

A batch may mix budget levels: with ``refill=True`` a fresh level-0
candidate is packed beside level-k survivors (``sweep.select_carry``). Its
trajectories then stand at different rounds, so the batch's
``FedState.round`` is a ``[B]`` tensor, and each row draws from its own
(seed, level) generator bundle; every row computes what its own unmixed run
would.

Host and device: at a prune point the host reads ONLY the ``[W * S]``
last-eval column of each batch (the ranking signal), then starts a
non-blocking copy of the wave's metric trajectories into pinned host
memory, and only then packs and dispatches the next wave; the finished
wave's rows are sliced and persisted to the ``ResultsStore`` after that
dispatch, from the copies, without waiting on the new wave's kernels.

Rung math: a candidate's budget after surviving r waves is ``r *
rung_rounds``; ``base.rounds`` is the budget cap (``rung_rounds`` must
divide it). Candidates are ranked only against others at the SAME budget
level, so a fresh level-0 filler never knocks out a level-3 survivor.

CLI::

    python -m repro_torch.experiments.search --device cuda \\
        --algo fedpbc --scheme bernoulli_tv --seeds 0,1 --clients 32 \\
        --rounds 60 --rung-rounds 10 --candidates 16 --batch-points 8 \\
        --space lr=log:0.01:0.5 gamma=uniform:0.1:0.9 --out build/search
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.algorithms import algo_family
from repro_torch.device import resolve_device
from repro_torch.experiments.grid import (
    HPARAM_FIELDS,
    SweepSpec,
    get_partition,
    get_traced_task,
    point_base_probs,
    segment_runner_for,
)
from repro_torch.experiments.results import ResultsStore, summarize
from repro_torch.experiments.sweep import (
    CellBatch,
    concat_carries,
    gather_carry,
    seed_generators,
    select_carry,
)
from repro_torch.kernels.masked_agg import compiled_specializations
from repro_torch.scale.buffer import SYNC

SAMPLER_KINDS = ("log", "uniform", "choice")


@dataclass(frozen=True)
class SearchSpec:
    """One adaptive search: the protocol (``base``), the rung schedule, and
    the candidate space.

    ``base`` pins everything a ``SweepSpec`` pins — algorithm, scheme,
    seeds, client count, dataset/model shape — except the hyperparameter
    axes, which the sampler replaces: ``base.rounds`` is the per-candidate
    budget cap, ``base.eval_every`` is ignored (the eval cadence is
    ``rung_rounds``, one eval per segment). Exactly one algorithm, one
    scheme, and the synchronous strategy are supported per search.

    ``space`` entries are ``(field, (kind, *args))`` with ``field`` in
    ``HPARAM_FIELDS`` and ``kind`` one of ``log`` (log-uniform in
    ``(lo, hi)``), ``uniform``, or ``choice`` (uniform over the listed
    values); unsampled fields keep ``base``'s scalar. ``points`` instead
    passes an explicit candidate pool (e.g. a grid, for an
    early-stopping-vs-exhaustive comparison); missing fields again default
    to ``base``'s scalars.
    """

    base: SweepSpec
    rung_rounds: int
    eta: int = 2
    num_candidates: int = 8
    # points per batch (the elastic re-pack width W; batch width is W *
    # len(seeds) trajectories). None: the whole population in one batch.
    batch_points: Optional[int] = None
    space: Tuple[Tuple[str, tuple], ...] = ()
    points: Optional[Tuple[Dict[str, float], ...]] = None
    # fill partial batches with freshly sampled level-0 candidates (free
    # exploration in slots that would otherwise be duplicate padding)
    refill: bool = False
    max_candidates: Optional[int] = None    # total sampling cap for refill
    # stop the whole search once any candidate's point-mean eval reaches
    # this (time-to-target mode); None runs every survivor to the budget cap
    target: Optional[float] = None
    search_seed: int = 0

    def __post_init__(self):
        base = self.base
        for axis, n in (("algorithms", len(base.algorithms)),
                        ("schemes", len(base.schemes))):
            if n != 1:
                raise ValueError(
                    f"SearchSpec.base.{axis} has {n} entries; a search "
                    f"drives one (algorithm, scheme) cell — run one search "
                    f"per cell")
        if base.strategies != (SYNC,):
            raise ValueError(
                "SearchSpec.base.strategies must be (SYNC,): the controller "
                "ranks on the synchronous eval contract")
        hp_axes = [f for f in HPARAM_FIELDS if getattr(base, f + "s")]
        if hp_axes:
            raise ValueError(
                f"SearchSpec.base carries swept axes {hp_axes}; the search "
                f"samples its own points — pass them via space= or points=")
        if self.rung_rounds < 1:
            raise ValueError(f"rung_rounds={self.rung_rounds} must be >= 1")
        if base.rounds % self.rung_rounds:
            raise ValueError(
                f"rung_rounds={self.rung_rounds} must divide the budget cap "
                f"base.rounds={base.rounds} (segments are same-length by "
                f"construction — one scan compile)")
        if self.eta < 2:
            raise ValueError(f"eta={self.eta} must be >= 2")
        if self.points is not None:
            if not self.points:
                raise ValueError("points= is empty; give at least one "
                                 "candidate")
            for pt in self.points:
                bad = sorted(set(pt) - set(HPARAM_FIELDS))
                if bad:
                    raise ValueError(
                        f"points entry has unknown fields {bad}; "
                        f"hyperparameter fields are {HPARAM_FIELDS}")
        elif self.num_candidates < 1:
            raise ValueError(
                f"num_candidates={self.num_candidates} must be >= 1")
        for name, dist in self.space:
            if name not in HPARAM_FIELDS:
                raise ValueError(
                    f"space field {name!r} is not a hyperparameter; "
                    f"expected one of {HPARAM_FIELDS}")
            kind = dist[0] if dist else None
            if kind not in SAMPLER_KINDS:
                raise ValueError(
                    f"space[{name!r}] kind {kind!r}; expected one of "
                    f"{SAMPLER_KINDS}")
            if kind in ("log", "uniform"):
                if len(dist) != 3 or not dist[1] < dist[2]:
                    raise ValueError(
                        f"space[{name!r}]=({kind}, lo, hi) needs lo < hi, "
                        f"got {dist[1:]}")
                if kind == "log" and dist[1] <= 0:
                    raise ValueError(
                        f"space[{name!r}] log-sampling needs lo > 0, got "
                        f"{dist[1]}")
            elif len(dist) < 2 or not dist[1]:
                raise ValueError(
                    f"space[{name!r}]=('choice', (v, ...)) needs at least "
                    f"one value")
        if self.batch_points is not None and self.batch_points < 1:
            raise ValueError(
                f"batch_points={self.batch_points} must be >= 1")
        if self.refill and not self.space:
            raise ValueError(
                "refill=True needs a space= to sample fresh candidates from")
        pop = len(self.points) if self.points is not None \
            else self.num_candidates
        if self.max_candidates is not None and self.max_candidates < pop:
            raise ValueError(
                f"max_candidates={self.max_candidates} is below the initial "
                f"population {pop}")

    @property
    def population(self) -> int:
        return len(self.points) if self.points is not None \
            else self.num_candidates

    @property
    def width(self) -> int:
        """Points per batch — the fixed pack width W."""
        return min(self.batch_points or self.population, self.population)

    @property
    def max_level(self) -> int:
        """Segments to the budget cap (a candidate's level is its count of
        completed segments; budget = level * rung_rounds)."""
        return self.base.rounds // self.rung_rounds


def sample_point(rng: np.random.Generator,
                 search: SearchSpec) -> Dict[str, float]:
    """Draw one candidate from ``search.space`` (unsampled fields keep the
    base spec's scalar knobs); the reference's draws from the same
    ``rng``."""
    pt = {f: float(getattr(search.base, f)) for f in HPARAM_FIELDS}
    for name, dist in search.space:
        kind = dist[0]
        if kind == "log":
            lo, hi = float(dist[1]), float(dist[2])
            pt[name] = float(np.exp(rng.uniform(np.log(lo), np.log(hi))))
        elif kind == "uniform":
            pt[name] = float(rng.uniform(float(dist[1]), float(dist[2])))
        else:   # choice
            vals = dist[1]
            pt[name] = float(vals[int(rng.integers(len(vals)))])
    return pt


@dataclass
class Candidate:
    """Host-side bookkeeping for one search candidate (a hyperparameter
    point across all seeds)."""

    cid: int
    point: Dict[str, float]
    level: int = 0                  # completed rung_rounds-sized segments
    rung: int = 0                   # prune points survived
    status: str = "alive"           # alive | pruned | finished | stopped
    evals: List[float] = field(default_factory=list)    # point-mean, per seg
    test_acc: List[np.ndarray] = field(default_factory=list)    # [S] per seg
    metrics: Dict[str, List[np.ndarray]] = field(default_factory=dict)
    pool_point: int = -1            # point index into the last wave's carry
    record_id: Optional[int] = None

    @property
    def last_eval(self) -> float:
        return self.evals[-1] if self.evals else float("-inf")


@dataclass
class SearchOutcome:
    """What one ``run_search`` spent and found."""

    candidates: List[Candidate]
    waves: int
    # trajectory-rounds dispatched: Sum over batches of W * S * rung_rounds
    # (seeds and duplicate-padding slots included — they cost device work)
    total_device_rounds: int
    # per wave: cumulative device rounds + the best point-mean eval so far
    wave_log: List[Dict[str, float]]
    target_hit: bool
    # eager PyTorch compiles no programs: "init" and "scan" are None (the
    # reference's cache_size where it cannot count); "agg_kernel" counts
    # the Triton aggregation's specialisations compiled during the search
    # (None where Triton does not say)
    compile_entries: Dict[str, Optional[int]]
    # per wave, per dispatched batch: the budget levels its real occupants
    # stood at when it was dispatched
    wave_batches: List[List[Tuple[int, ...]]] = field(default_factory=list)

    @property
    def best(self) -> Candidate:
        return max((c for c in self.candidates if c.evals),
                   key=lambda c: (c.last_eval, c.level))

    @property
    def mixed_batches(self) -> int:
        """Dispatched batches whose occupants stood at different levels."""
        return sum(len(set(lv)) > 1 for wave in self.wave_batches
                   for lv in wave)

    def device_rounds_to(self, target: float) -> Optional[int]:
        """Cumulative device rounds at the first wave whose best eval
        reached ``target`` (None: never reached)."""
        for entry in self.wave_log:
            if entry["best_eval"] >= target - 1e-9:
                return int(entry["device_rounds"])
        return None


def run_search(search: SearchSpec, *, store: Optional[ResultsStore] = None,
               suite: str = "search",
               metric_keys=("loss", "num_active"),
               verbose: bool = False, device=None,
               draws_factory: Optional[Callable] = None,
               p_base_factory: Optional[Callable] = None) -> SearchOutcome:
    """Run one successive-halving search; optionally persist one store row
    per candidate (truncated trajectories for pruned points, full-budget
    ones for finished points), each stamped with ``search`` provenance
    (rung, budget_rounds, status) that ``results.cell_key`` folds into the
    row's identity. ``device=None`` is the card.

    Test seams, as the runner's ``draws=``: ``draws_factory(seeds)`` gives
    the drawer of a freshly initialised batch whose row ``b`` has seed
    ``seeds[b]`` (default: the batch's ``seed_generators``);
    ``p_base_factory(spec, point)`` the ``[S, m]`` Eq.-9 probabilities of a
    point (default ``grid.point_base_probs``)."""
    dev = resolve_device(device)
    spec = search.base
    algo, scheme = spec.algorithms[0], spec.schemes[0]
    task = get_traced_task(spec, dev)
    fed = spec.cell_config(algo, scheme)
    algo_idx = algo_family(algo).index(algo)
    runner = segment_runner_for(spec, algo, scheme,
                                segment_rounds=search.rung_rounds,
                                metric_keys=metric_keys, device=dev)
    seg = search.rung_rounds
    seeds = list(spec.seeds)
    S = len(seeds)
    W = search.width
    max_level = search.max_level
    rng = np.random.default_rng(search.search_seed)
    p_base_factory = p_base_factory or point_base_probs
    agg_before = compiled_specializations()

    defaults = {f: float(getattr(spec, f)) for f in HPARAM_FIELDS}
    if search.points is not None:
        pool = [dict(defaults, **pt) for pt in search.points]
    else:
        pool = [sample_point(rng, search)
                for _ in range(search.num_candidates)]
    cap = search.max_candidates if search.max_candidates is not None \
        else len(pool)
    candidates = [Candidate(cid=i, point=pt) for i, pt in enumerate(pool)]

    # the Eq.-9 draw depends only on (alpha, sigma0, delta); memoize across
    # waves so re-packs never redo host-side sampling
    probs_memo: Dict[tuple, np.ndarray] = {}

    def probs(pt):
        k = (pt["alpha"], pt["sigma0"], pt["delta"])
        if k not in probs_memo:
            probs_memo[k] = np.asarray(p_base_factory(spec, pt), np.float32)
        return probs_memo[k]

    # the seeds' generators at their start, built once: ``init`` copies
    # them for a batch's level-0 slots and never advances them, and a batch
    # of survivors only carries them
    gens = [seed_generators(s, dev) for s in seeds]

    def build_batch(pts: List[Dict[str, float]]) -> CellBatch:
        B = len(pts) * S

        def col(f):
            return torch.tensor([pt[f] for pt in pts for _ in range(S)],
                                dtype=torch.float32, device=dev)

        idx = np.stack([get_partition(spec, task, pt["alpha"])
                        for pt in pts for _ in range(S)])
        return CellBatch(
            gens=gens,
            gen_index=[i for _ in pts for i in range(S)],
            gen_tags=list(seeds),
            p_base=torch.as_tensor(np.concatenate([probs(pt) for pt in pts]),
                                   device=dev),
            hparams={"lr": col("lr"), "gamma": col("gamma"),
                     "period": torch.full((B,), float(fed.period),
                                          dtype=torch.float32, device=dev)},
            data={"idx": torch.as_tensor(idx, device=dev)},
            shared=task.shared,
            algo_id=torch.full((B,), algo_idx, dtype=torch.long, device=dev))

    def init(batch: CellBatch):
        draws = None if draws_factory is None else draws_factory(
            [seeds[i] for i in batch.gen_index])
        return runner.init(batch, draws)

    prev_pool = None                # concatenated last-wave carry [P*W*S]
    total_rounds = 0
    wave_log: List[Dict[str, float]] = []
    wave_batches: List[List[Tuple[int, ...]]] = []
    target_hit = False
    waves = 0

    def dispatch_wave(alive: List[Candidate]):
        """Pack the live population into full-width batches (survivors
        carried, level-0 slots freshly initialised, leftover slots refilled
        or duplicate-padded) and dispatch every segment. Returns the list
        of ``(occupants, n_real, carry, out)``."""
        nonlocal total_rounds
        # deterministic pack order: deepest budget first (survivors stay
        # contiguous across re-packs), best-eval-first within a level
        alive = sorted(alive, key=lambda c: (-c.level, -c.last_eval, c.cid))
        groups = [alive[i:i + W] for i in range(0, len(alive), W)]
        last = groups[-1]
        while len(last) < W and search.refill and search.space \
                and len(candidates) < cap:
            c = Candidate(cid=len(candidates),
                          point=sample_point(rng, search))
            candidates.append(c)
            last.append(c)
        handles = []
        wave_batches.append([tuple(c.level for c in occ) for occ in groups])
        for occ in groups:
            n_real = len(occ)
            # duplicate-pad to full width; padded slots replicate occupant
            # 0 (its carry AND its batch columns) and are dropped on read
            occ = occ + [occ[0]] * (W - n_real) if n_real < W else occ
            batch = build_batch([c.point for c in occ])
            cont = np.array([c.level > 0 for c in occ])
            rows = np.zeros((W * S,), np.int64)
            for j, c in enumerate(occ):
                if c.level > 0:
                    rows[j * S:(j + 1) * S] = c.pool_point * S + np.arange(S)
            if cont.all():
                carry = gather_carry(prev_pool, rows)
            elif not cont.any():
                carry = init(batch)
            else:
                # mixed batch: survivors gather from the previous wave's
                # pool, fresh (refilled) slots take the batch's init
                carry = select_carry(np.repeat(cont, S),
                                     gather_carry(prev_pool, rows),
                                     init(batch))
            # each row's round, known here: an int where they agree (the
            # program an unmixed batch runs), else a [B] tensor
            rounds = [c.level * seg for c in occ for _ in range(S)]
            st = dataclasses.replace(
                carry[0], round=rounds[0] if len(set(rounds)) == 1
                else torch.tensor(rounds, dtype=torch.long, device=dev))
            carry, out = runner.step((st,) + tuple(carry[1:]), batch)
            total_rounds += W * S * seg
            handles.append((occ, n_real, carry, out))
        return handles

    def fetch(handles):
        """Start copying a finished wave's metrics and evals to the host
        (pinned memory, non-blocking on the card) and return the copies
        with the event that marks them done."""
        copies = []
        for occ, n_real, _, out in handles:
            host = {}
            for k, v in list(out["metrics"].items()) + [
                    ("evals", out["evals"])]:
                if v.is_cuda:
                    h = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                    h.copy_(v, non_blocking=True)
                    host[k] = h
                else:
                    host[k] = v
            copies.append((occ, n_real, host))
        event = None
        if dev.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        return copies, event

    def drain(fetched) -> None:
        """Slice a finished wave's trajectories into its candidates and
        persist every candidate the prune step stopped — after the next
        wave was dispatched, from the host copies."""
        copies, event = fetched
        if event is not None:
            event.synchronize()
        for occ, n_real, host in copies:
            acc = host["evals"].numpy()
            for j, c in enumerate(occ[:n_real]):
                rows = slice(j * S, (j + 1) * S)
                c.test_acc.append(acc[rows, -1])
                for k in metric_keys:
                    c.metrics.setdefault(k, []).append(
                        host[k].numpy()[rows])
        if store is None:
            return
        for occ, n_real, _ in copies:
            for c in occ[:n_real]:
                if c.status != "alive" and c.record_id is None:
                    persist(c)

    def persist(c: Candidate) -> None:
        budget = c.level * seg
        ta = np.stack(c.test_acc, axis=1)           # [S, E]
        w = min(3, ta.shape[1])
        rec = {
            "suite": suite, "algo": algo, "scheme": scheme,
            "strategy": "sync", "seeds": list(spec.seeds),
            "rounds": budget, "eval_every": seg,
            "hparams": dict(c.point),
            "spec": dataclasses.asdict(dataclasses.replace(
                spec, rounds=budget, eval_every=seg)),
            "eval_rounds": [seg * (i + 1) for i in range(c.level)],
            "search": {"rung": c.rung, "budget_rounds": budget,
                       "status": c.status, "cid": c.cid,
                       "rung_rounds": seg, "eta": search.eta,
                       "population": search.population},
            "summary": {"test_acc": summarize(ta[:, -w:].mean(axis=1))},
        }
        arrays = {"test_acc": ta}
        for k in metric_keys:
            arr = np.concatenate(c.metrics[k], axis=1)
            if k == "num_active":           # the reference's dtype
                arr = arr.astype(np.int32)
            arrays[k] = arr
        c.record_id = store.append(rec, arrays=arrays)["record_id"]

    def prune(handles) -> None:
        """The prune point: read only the [W * S] last-eval column of each
        batch, then decide who survives. Candidates are ranked within their
        own budget level; each level keeps ceil(n / eta)."""
        nonlocal target_hit
        advanced: List[Candidate] = []
        best_eval = float("-inf")
        for occ, n_real, _, out in handles:
            col = out["evals"][:, -1].cpu().numpy().reshape(W, S).mean(
                axis=1)
            for j, c in enumerate(occ[:n_real]):
                c.level += 1
                c.evals.append(float(col[j]))
                advanced.append(c)
                best_eval = max(best_eval, c.evals[-1])
        wave_log.append({"device_rounds": total_rounds,
                         "best_eval": best_eval})
        for c in advanced:
            if c.level >= max_level:
                c.status = "finished"
        if search.target is not None and best_eval >= search.target - 1e-9:
            target_hit = True
            for c in advanced:
                if c.status == "alive":
                    c.status = "stopped"
            return
        by_level: Dict[int, List[Candidate]] = {}
        for c in advanced:
            if c.status == "alive":
                by_level.setdefault(c.level, []).append(c)
        for grp in by_level.values():
            grp.sort(key=lambda c: (-c.last_eval, c.cid))
            keep = -(-len(grp) // search.eta)       # ceil: never kill a level
            for c in grp[:keep]:
                c.rung += 1
            for c in grp[keep:]:
                c.status = "pruned"

    pending = None
    while True:
        alive = [c for c in candidates if c.status == "alive"]
        if not alive:
            break
        handles = dispatch_wave(alive)
        waves += 1
        if pending is not None:
            drain(pending)      # from host copies made before this wave
        prune(handles)
        if verbose:
            n_alive = sum(c.status == "alive" for c in candidates)
            print(f"# search wave {waves}: {len(handles)} batch(es), "
                  f"best_eval={wave_log[-1]['best_eval']:.4f}, "
                  f"alive={n_alive}, device_rounds={total_rounds}",
                  flush=True)
        pending = fetch(handles)
        # carries of this wave become the next re-pack's gather pool
        prev_pool = concat_carries([carry for _, _, carry, _ in handles])
        for bi, (occ, n_real, _, _) in enumerate(handles):
            for j, c in enumerate(occ[:n_real]):
                c.pool_point = bi * W + j
    if pending is not None:
        drain(pending)

    agg_after = compiled_specializations()
    entries = {"init": None, "scan": None,
               "agg_kernel": (None if agg_before is None or agg_after is None
                              else agg_after - agg_before)}
    return SearchOutcome(candidates=candidates, waves=waves,
                         total_device_rounds=total_rounds,
                         wave_log=wave_log, target_hit=target_hit,
                         compile_entries=entries, wave_batches=wave_batches)


def _parse_space(items) -> Tuple[Tuple[str, tuple], ...]:
    """``name=kind:v1:v2[:v3...]`` -> SearchSpec.space entries (choice takes
    every listed value)."""
    out = []
    for item in items:
        try:
            name, rest = item.split("=", 1)
            kind, *vals = rest.split(":")
            vals = tuple(float(v) for v in vals)
        except ValueError:
            raise SystemExit(
                f"--space entry {item!r}; expected name=kind:v1:v2[:...] "
                f"(e.g. lr=log:0.01:0.5 or alpha=choice:0.1:1.0)")
        out.append((name, (kind, vals) if kind == "choice"
                    else (kind,) + vals))
    return tuple(out)


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(
        description="Successive-halving (ASHA-style) hyperparameter search "
                    "over the batched sweep engine of the PyTorch port: "
                    "candidates run in rung-sized segments, losers are "
                    "pruned on the segments' evals, survivors are "
                    "elastically re-packed into full batches of ONE "
                    "segment runner.")
    ap.add_argument("--algo", default="fedpbc")
    ap.add_argument("--scheme", default="bernoulli_ti")
    ap.add_argument("--seeds", default="0,1", help="comma list of ints")
    ap.add_argument("--rounds", type=int, default=40,
                    help="per-candidate budget cap (a multiple of "
                    "--rung-rounds)")
    ap.add_argument("--rung-rounds", type=int, default=10,
                    help="segment length: rounds between prune points")
    ap.add_argument("--eta", type=int, default=2,
                    help="keep top 1/eta of each budget level per prune")
    ap.add_argument("--candidates", type=int, default=8)
    ap.add_argument("--batch-points", type=int, default=None,
                    help="points per batch (default: the whole population)")
    ap.add_argument("--space", nargs="*", default=["lr=log:0.01:0.5"],
                    help="sampler per hyperparameter: name=kind:v1:v2[:...] "
                    "with kind in log|uniform|choice")
    ap.add_argument("--refill", action="store_true",
                    help="fill freed batch slots with fresh candidates")
    ap.add_argument("--max-candidates", type=int, default=None,
                    help="total sampling cap when refilling")
    ap.add_argument("--target", type=float, default=None,
                    help="stop the search once any candidate reaches this "
                    "test accuracy")
    ap.add_argument("--search-seed", type=int, default=0)
    ap.add_argument("--clients", type=int, default=32)
    ap.add_argument("--local-steps", type=int, default=5)
    ap.add_argument("--use-kernel", action="store_true",
                    help="server update through the fused Triton kernel")
    ap.add_argument("--out", default="build/search",
                    help="results-store directory (JSONL + npz)")
    ap.add_argument("--suite", default="search",
                    help="suite tag on the records")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without it)")
    args = ap.parse_args(argv)

    base = SweepSpec(
        algorithms=(args.algo,), schemes=(args.scheme,),
        seeds=tuple(int(s) for s in args.seeds.split(",")),
        rounds=args.rounds, eval_every=args.rung_rounds,
        num_clients=args.clients, local_steps=args.local_steps,
        use_kernel=args.use_kernel or None)
    search = SearchSpec(
        base=base, rung_rounds=args.rung_rounds, eta=args.eta,
        num_candidates=args.candidates, batch_points=args.batch_points,
        space=_parse_space(args.space), refill=args.refill,
        max_candidates=args.max_candidates, target=args.target,
        search_seed=args.search_seed)
    store = ResultsStore(args.out)
    outcome = run_search(search, store=store, suite=args.suite, verbose=True,
                         device=args.device)
    print("search,cid,status,rung,budget_rounds,hparams,last_eval",
          flush=True)
    for c in sorted(outcome.candidates, key=lambda c: -c.last_eval):
        hp = ";".join(f"{k}={v:g}" for k, v in sorted(c.point.items()))
        ev = f"{c.last_eval:.4f}" if c.evals else "nan"
        print(f"search,{c.cid},{c.status},{c.rung},"
              f"{c.level * args.rung_rounds},{hp},{ev}", flush=True)
    best = outcome.best
    grid_rounds = (len(outcome.candidates) * len(base.seeds) * args.rounds)
    print(f"# best cid={best.cid} eval={best.last_eval:.4f} | "
          f"device_rounds={outcome.total_device_rounds} "
          f"(exhaustive grid of the same pool: {grid_rounds}) | "
          f"waves={outcome.waves} target_hit={outcome.target_hit}",
          flush=True)
    print(f"# results appended to {store.path}", flush=True)


if __name__ == "__main__":
    main()

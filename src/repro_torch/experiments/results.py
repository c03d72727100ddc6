"""Append-only results store for experiment sweeps (port of
``repro.experiments.results``; plain numpy, the same file format).

Each appended record is one JSON line in ``<root>/results.jsonl`` — scalar
metadata and summaries only — and (optionally) one ``.npz`` file under
``<root>/arrays/`` holding the record's array payloads (per-seed trajectories,
final accuracies, ...). Records are keyed by a monotonically increasing
``record_id`` and stamped with the repo's git SHA, so a sweep re-run after a
code change appends new rows instead of silently overwriting old ones; the
CSV printing the paper-table benchmarks used to do is now a *view* over this
store, not the storage itself.

The format is deliberately dependency-free: JSONL for greppable metadata,
``numpy.savez_compressed`` for arrays.

Stores from different sessions/machines union with ``ResultsStore.merge``
(dedup by ``cell_key``, later stores win), also exposed as a CLI::

    python -m repro_torch.experiments.results merge --out merged store_a store_b

which reports the merged rows grouped by their recorded git SHA.

Both packages write and read one layout: the same JSONL keys, the same npz
array names, the same ``record_id`` and ``git_sha`` fields, so either
package reads, merges and exports the other's stores.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import uuid
from typing import Any, Dict, Iterable, List, Optional, Union

import numpy as np


def git_sha(cwd: Optional[str] = None) -> str:
    """Short git SHA of the repo containing ``cwd`` (or this file); falls back
    to ``"unknown"`` outside a git checkout (e.g. an installed wheel)."""
    if cwd is None:
        cwd = os.path.dirname(os.path.abspath(__file__))
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], cwd=cwd,
            capture_output=True, text=True, timeout=10)
        sha = out.stdout.strip()
        return sha if out.returncode == 0 and sha else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def summarize(values, confidence: str = "ci95") -> Dict[str, float]:
    """Mean / std / normal-approx 95% CI half-width over a 1-D seed axis.

    NaN entries are dropped before summarizing (``n`` counts the finite
    values): variable-length trajectories — e.g. early-pruned search
    candidates pooled with full-budget ones — are NaN-padded to a common
    width, and the padding must not poison the statistics."""
    v = np.asarray(values, np.float64).ravel()
    v = v[~np.isnan(v)]
    n = int(v.size)
    mean = float(v.mean()) if n else float("nan")
    std = float(v.std(ddof=1)) if n > 1 else 0.0
    half = 1.96 * std / math.sqrt(n) if n > 1 else 0.0
    return {"mean": mean, "std": std, "n": n, confidence: half}


def buffered_summary(commit: np.ndarray,
                     commit_staleness: np.ndarray) -> Dict[str, Any]:
    """Per-seed summaries of a buffered cell's commit trace.

    ``commit [S, K]`` is the per-round commit indicator (0/1), and
    ``commit_staleness [S, K]`` the mean buffered-contribution age at each
    commit (0 on non-commit rounds). Returns ``commits`` (commits per
    trajectory) and ``commit_staleness`` (per-seed commit-weighted mean age)
    summarized over seeds — the staleness/participation fields the sweep
    store records for buffered strategies.
    """
    commit = np.asarray(commit, np.float64)
    stale = np.asarray(commit_staleness, np.float64)
    n_commits = commit.sum(axis=1)
    mean_stale = (stale * commit).sum(axis=1) / np.maximum(n_commits, 1.0)
    return {"commits": summarize(n_commits),
            "commit_staleness": summarize(mean_stale)}


# SweepSpec fields (beyond rounds/eval_every, recorded top-level) that change
# what a cell measures; folded into cell_key from the record's "spec" dict so
# e.g. an m=32 run never deduplicates against an m=100 run of the same suite.
_PROTOCOL_FIELDS = ("num_clients", "local_steps", "batch_size", "data_seed",
                    "dim", "classes", "hidden", "n_per_class", "n_train",
                    "per_client", "fed_overrides", "cohort_size")


def _hashable(v):
    if isinstance(v, (list, tuple)):
        return tuple(_hashable(x) for x in v)
    return v


def cell_key(record: Dict[str, Any]) -> tuple:
    """Canonical identity of a record's grid cell: suite, algorithm, scheme,
    seed set, round protocol, hyperparameter coordinates, and the spec's
    protocol fields (client count, dataset/model shape, overrides). Two
    records with equal ``cell_key`` measure the same thing (possibly from
    different sessions / code revisions) and deduplicate under
    ``ResultsStore.merge``.
    """
    spec = record.get("spec") or {}
    # adaptive-search rows carry a budget coordinate: a candidate pruned at
    # rung 1 and the same point run to the full budget measure different
    # things, so the (rung, budget_rounds) pair joins the identity. Records
    # without a "search" dict normalize to () — legacy keys are unchanged.
    search = record.get("search") or {}
    hp = record.get("hparams")
    if hp is None:
        # legacy (pre-hyperparameter-axis) records: the swept value lives
        # only in the spec's scalar knobs — fold those in so e.g. old fig8
        # delta-ablation rows don't collapse into one cell
        hp = {f: spec[f] for f in ("lr", "gamma", "alpha", "sigma0", "delta")
              if f in spec}
    return (record.get("suite"), record.get("algo"), record.get("scheme"),
            # strategy-axis coordinate; records predating the axis carry no
            # field and normalize to "sync" (they ARE synchronous cells)
            record.get("strategy") or "sync",
            _hashable(record.get("seeds")), record.get("rounds"),
            record.get("eval_every"),
            tuple(sorted((k, _hashable(v)) for k, v in hp.items())),
            tuple((f, _hashable(spec.get(f))) for f in _PROTOCOL_FIELDS
                  if f in spec),
            tuple((k, _hashable(search.get(k)))
                  for k in ("rung", "budget_rounds") if k in search))


def _jsonable(x):
    if isinstance(x, (np.integer,)):
        return int(x)
    if isinstance(x, (np.floating,)):
        return float(x)
    if isinstance(x, (np.ndarray,)):
        return x.tolist()
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    return x


class ResultsStore:
    """Append-only JSONL + npz store rooted at a directory.

    >>> store = ResultsStore("build/paper/sweeps")
    >>> rec = store.append({"suite": "table1", "algo": "fedpbc"},
    ...                    arrays={"test_acc": acc})   # acc: [S, E]
    >>> rows = store.records(suite="table1")
    >>> store.load_arrays(rows[-1])["test_acc"]
    """

    def __init__(self, root: str):
        self.root = root
        self.arrays_dir = os.path.join(root, "arrays")
        self.path = os.path.join(root, "results.jsonl")
        os.makedirs(self.arrays_dir, exist_ok=True)
        # cached (line count, file size) as of this handle's last look; the
        # size check invalidates the cache whenever ANOTHER handle grew the
        # file, so interleaved same-process handles keep ids unique while
        # bulk writers like merge() stay O(N) instead of re-counting per row
        self._count: Optional[int] = None
        self._size: int = -1

    def _file_size(self) -> int:
        try:
            return os.path.getsize(self.path)
        except OSError:
            return 0

    def _next_id(self) -> int:
        size = self._file_size()
        if self._count is None or size != self._size:
            if not os.path.exists(self.path):
                self._count = 0
            else:
                with open(self.path) as f:
                    self._count = sum(1 for line in f if line.strip())
            self._size = size
        return self._count

    def append(self, record: Dict[str, Any],
               arrays: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Write one record; returns it with ``record_id`` / ``git_sha`` /
        ``arrays`` (npz relpath) fields filled in."""
        rec = dict(record)
        rec["record_id"] = self._next_id()
        rec.setdefault("git_sha", git_sha())
        if arrays:
            # record_id is derived from the line count, so two processes
            # appending concurrently can both claim id N; the random suffix
            # keeps their array payloads from clobbering each other (each
            # record references its own npz)
            rel = os.path.join(
                "arrays", f"r{rec['record_id']:06d}-{uuid.uuid4().hex[:8]}.npz")
            np.savez_compressed(
                os.path.join(self.root, rel),
                **{k: np.asarray(v) for k, v in arrays.items()})
            rec["arrays"] = rel
        line = json.dumps(_jsonable(rec), sort_keys=True)
        with open(self.path, "a") as f:
            f.write(line + "\n")
        self._count = rec["record_id"] + 1
        self._size = self._file_size()
        return rec

    def records(self, **filters) -> List[Dict[str, Any]]:
        """All records whose top-level fields equal ``filters`` (e.g.
        ``records(suite="table1", algo="fedpbc")``), in append order."""
        if not os.path.exists(self.path):
            return []
        out = []
        with open(self.path) as f:
            for line in f:
                if not line.strip():
                    continue
                rec = json.loads(line)
                if all(rec.get(k) == v for k, v in filters.items()):
                    out.append(rec)
        return out

    def load_arrays(self, record: Dict[str, Any]) -> Dict[str, np.ndarray]:
        rel = record.get("arrays")
        if not rel:
            return {}
        with np.load(os.path.join(self.root, rel)) as z:
            return {k: z[k] for k in z.files}

    @classmethod
    def merge(cls, dest_root: str,
              *stores: Union[str, "ResultsStore"]) -> "ResultsStore":
        """Union several stores into a fresh store at ``dest_root``.

        Records are deduplicated by ``cell_key``: when two stores hold the
        same cell, the LAST one (in argument order, then append order) wins —
        so merging an old session's store before a re-run's store keeps the
        re-run. Surviving records are re-appended in their original order
        with fresh ``record_id``s (the source id is kept as
        ``source_record_id``); array payloads are copied; the recorded
        ``git_sha`` of each source row is preserved, so a merged store can
        group rows by the code revision that produced them.

        A record whose npz payload is missing on disk (e.g. a partially
        copied store) is kept with its metadata and a warning instead of
        aborting the merge halfway.

        ``dest_root`` must be a FRESH (empty) store: merging onto existing
        rows would bypass dedup and silently duplicate cells, so a non-empty
        destination is refused — include it as a *source* instead
        (``merge(new_dir, old_dest, more...)``).
        """
        import sys

        dest_jsonl = os.path.join(dest_root, "results.jsonl")
        if os.path.exists(dest_jsonl) and os.path.getsize(dest_jsonl) > 0:
            raise ValueError(
                f"merge destination {dest_root!r} already has records; "
                f"merge into a fresh directory (pass the old destination as "
                f"a source to re-merge)")
        # a typo'd source path must fail loudly — the constructor would
        # happily mkdir an empty store there and contribute zero rows
        for s in stores:
            if not isinstance(s, cls) and not os.path.exists(
                    os.path.join(s, "results.jsonl")):
                raise FileNotFoundError(
                    f"source store {s!r} has no results.jsonl")
        opened = [s if isinstance(s, cls) else cls(s) for s in stores]
        rows: List[tuple] = []          # (key, record, source store)
        for store in opened:
            for rec in store.records():
                rows.append((cell_key(rec), rec, store))
        last = {key: i for i, (key, _, _) in enumerate(rows)}
        merged = cls(dest_root)
        for i, (key, rec, store) in enumerate(rows):
            if last[key] != i:
                continue
            try:
                arrays = store.load_arrays(rec)
            except OSError as e:
                print(f"warning: skipping arrays of record "
                      f"{rec.get('record_id')} in {store.root}: {e}",
                      file=sys.stderr)
                arrays = {}
            out = {k: v for k, v in rec.items()
                   if k not in ("record_id", "arrays")}
            out["source_record_id"] = rec.get("record_id")
            merged.append(out, arrays=arrays or None)
        return merged


def group_by_sha(records: Iterable[Dict[str, Any]]) -> Dict[str, List[Dict[str, Any]]]:
    """Rows grouped by their recorded git SHA, preserving append order."""
    out: Dict[str, List[Dict[str, Any]]] = {}
    for rec in records:
        out.setdefault(rec.get("git_sha", "unknown"), []).append(rec)
    return out


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.experiments.results",
        description="Results-store tools.")
    sub = ap.add_subparsers(dest="cmd", required=True)
    mp = sub.add_parser(
        "merge", help="union stores into --out, dedup by cell key "
                      "(later stores win), report rows grouped by git SHA")
    mp.add_argument("stores", nargs="+", help="source store directories")
    mp.add_argument("--out", required=True, help="destination store directory")
    args = ap.parse_args(argv)

    if args.cmd == "merge":
        merged = ResultsStore.merge(args.out, *args.stores)
        rows = merged.records()
        print(f"merged {len(args.stores)} stores -> {merged.path} "
              f"({len(rows)} rows)")
        for sha, group in group_by_sha(rows).items():
            suites: Dict[str, int] = {}
            for rec in group:
                suites[rec.get("suite", "?")] = \
                    suites.get(rec.get("suite", "?"), 0) + 1
            detail = ", ".join(f"{s}={n}" for s, n in sorted(suites.items()))
            print(f"  git {sha}: {len(group)} rows ({detail})")


if __name__ == "__main__":
    main()

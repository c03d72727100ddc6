"""Figure-style curve exports straight from a results store — no re-runs
(port of ``repro.experiments.plots``; plain numpy, the same file names and
bytes).

The table/figure benchmarks already persist per-seed trajectories
(``test_acc [S, E]``, ``loss [S, K]``) next to every record; this module
turns them into the fig-3 / fig-8 style curve files (mean ± normal-approx
95% CI over the seed axis) without executing a single round:

    from repro_torch.experiments.plots import export_curves
    export_curves(ResultsStore("build/paper/sweeps"), "build/paper/curves",
                  suite="table1")

or::

    python -m repro_torch.experiments.plots --store build/paper/sweeps \
        --out build/paper/curves --suite fig8_alpha

Records sharing a curve identity (same suite/algo/scheme/rounds/hparams but
e.g. different seed batches from different sessions) are pooled along the
seed axis before summarizing. Output is dependency-free CSV: one
``<slug>_acc.csv`` (round, mean, std, ci95, n_seeds) and one
``<slug>_loss.csv`` per curve.
"""
from __future__ import annotations

import hashlib
import math
import os
from typing import Any, Dict, List

import numpy as np

from repro_torch.experiments.results import ResultsStore, cell_key


def _curve_key(record: Dict[str, Any]) -> tuple:
    """Curve identity: ``cell_key`` minus the seed set, so records of
    different seed batches pool along the seed axis while every
    protocol-distinguishing field still separates curves."""
    (suite, algo, scheme, strategy, _seeds, rounds, ee, hp,
     proto, search) = cell_key(record)
    return (suite, algo, scheme, strategy, rounds, ee, hp, proto, search)


def _slug(key: tuple) -> str:
    """Filename for one curve. Every component of ``_curve_key`` must reach
    the name or distinct curves would overwrite each other's CSVs: the
    human-readable parts come first (hparams rendered at %g precision for
    the eye), and the EXACT hparam + protocol values are folded into a short
    digest suffix so curves differing only beyond display precision (e.g.
    logspace-generated lrs) still get distinct files."""
    suite, algo, scheme, strategy, rounds, ee, hp, proto, search = key
    parts = [str(suite), str(algo), str(scheme)]
    # synchronous cells keep their historical filenames; buffered-strategy
    # curves get the strategy name as one more distinguishing part
    if strategy != "sync":
        parts.append(str(strategy))
    parts += [f"r{rounds}", f"e{ee}"]
    parts += [f"{k}{v:g}" for k, v in hp]
    # adaptive-search budget coordinate; non-search curves (search == ())
    # keep their historical filenames and digests
    for k, v in search:
        parts.append(f"{'rung' if k == 'rung' else 'b'}{v:g}")
    if hp or proto or search:
        parts.append("p" + hashlib.md5(
            repr((hp, proto, search) if search
                 else (hp, proto)).encode()).hexdigest()[:6])
    return "-".join(p.replace("/", "_").replace(" ", "") for p in parts)


def _summarize_rows(a: np.ndarray):
    """[S, T] -> (mean [T], std [T], ci95 [T], n [T]) over the seed axis,
    NaN-aware: pooled rows of different lengths are NaN-padded, so every
    per-round statistic is computed over the seeds that actually reached
    that round (``n`` is the per-round finite count)."""
    valid = ~np.isnan(a)
    n = valid.sum(axis=0)
    mean = np.where(n > 0, np.nansum(a, axis=0) / np.maximum(n, 1), np.nan)
    d = np.where(valid, a - mean, 0.0)
    var = np.where(n > 1, (d ** 2).sum(axis=0) / np.maximum(n - 1, 1), 0.0)
    std = np.sqrt(var)
    ci95 = np.where(n > 1, 1.96 * std / np.sqrt(np.maximum(n, 1)), 0.0)
    return mean, std, ci95, n


def _write_curve(path: str, xs, a: np.ndarray) -> str:
    mean, std, ci95, n = _summarize_rows(a)
    with open(path, "w") as f:
        f.write("round,mean,std,ci95,n_seeds\n")
        for x, m, sd, ci, k in zip(xs, mean, std, ci95, n):
            f.write(f"{int(x)},{m:.6f},{sd:.6f},{ci:.6f},{int(k)}\n")
    return path


def _pool_seed_rows(recs, payloads, name) -> "np.ndarray | None":
    """Pool one array field across a curve's records along the seed axis,
    deduplicating by seed: when two records carry the same seed (a later
    session re-ran a superset batch), the later record's row wins — simple
    concatenation would double-count the shared seeds and understate the CI.
    Records without a usable ``seeds`` list contribute all rows under
    synthetic never-colliding ids. Rows of different lengths (truncated
    early-pruned trajectories pooled with full ones) are right-padded with
    NaN to the longest row; the summaries mask the padding out."""
    rows: Dict[Any, np.ndarray] = {}
    for i, (rec, p) in enumerate(zip(recs, payloads)):
        arr = p.get(name)
        if arr is None or arr.size == 0:
            continue
        seeds = rec.get("seeds")
        if not isinstance(seeds, list) or len(seeds) != arr.shape[0]:
            seeds = [("anon", i, j) for j in range(arr.shape[0])]
        for s, row in zip(seeds, arr):
            rows[_hashable_seed(s)] = row
    if not rows:
        return None
    width = max(r.shape[0] for r in rows.values())
    return np.stack([
        np.pad(r.astype(np.float64), (0, width - r.shape[0]),
               constant_values=np.nan) if r.shape[0] < width else r
        for r in rows.values()])


def _hashable_seed(s):
    return tuple(s) if isinstance(s, list) else s


def export_curves(store: ResultsStore, out_dir: str,
                  **filters) -> List[str]:
    """Emit accuracy/loss curve CSVs for every curve in ``store`` matching
    ``filters`` (same semantics as ``store.records``); returns the written
    paths. Records without array payloads — including records whose npz file
    is missing on disk (partially copied store) — are skipped with a warning.

    The store is append-only, so a re-run of the same cell appends a second
    record with the same ``cell_key``: only the LATEST record per cell is
    used (re-runs supersede), while records of different seed batches pool
    along the seed axis (per-seed dedup, later records win on overlap).

    A store with NO records matching ``filters`` raises ``ValueError`` (an
    empty/missing store or an over-narrow filter is a caller mistake — a
    silent zero-file export would just move the confusion downstream)."""
    import sys

    # latest record per cell over ALL records — a later arrays-less record
    # (e.g. merge kept its metadata after a lost npz) must SUPERSEDE an older
    # run, not let the older run's stale arrays masquerade as current
    latest: Dict[tuple, Dict[str, Any]] = {}
    for rec in store.records(**filters):
        latest[cell_key(rec)] = rec     # later append wins
    if not latest:
        what = (f"matching filters {filters}" if filters
                else "(empty or missing store)")
        raise ValueError(
            f"no records to export from {store.path} {what}")
    groups: Dict[tuple, List[Dict[str, Any]]] = {}
    for rec in latest.values():
        if not rec.get("arrays"):
            print(f"warning: skipping record {rec.get('record_id')} "
                  f"(no array payload)", file=sys.stderr)
            continue
        groups.setdefault(_curve_key(rec), []).append(rec)
    os.makedirs(out_dir, exist_ok=True)
    written: List[str] = []
    for key, group in groups.items():
        recs, payloads = [], []
        # append order (record_id) so later re-runs win per-seed dedup
        for rec in sorted(group, key=lambda r: r.get("record_id", 0)):
            try:
                payloads.append(store.load_arrays(rec))
                recs.append(rec)
            except OSError as e:
                print(f"warning: skipping record {rec.get('record_id')} "
                      f"(missing arrays): {e}", file=sys.stderr)
        if not recs:
            continue
        slug = _slug(key)
        acc = _pool_seed_rows(recs, payloads, "test_acc")
        if acc is not None:
            # pooled width = the LONGEST record's trajectory; take the eval
            # axis from whichever record spans it (truncated rows are
            # NaN-padded up to it)
            rounds_at = max(
                (r.get("eval_rounds") for r in recs
                 if isinstance(r.get("eval_rounds"), list)),
                key=len, default=None)
            if rounds_at is None or len(rounds_at) != acc.shape[1]:
                rounds_at = list(range(1, acc.shape[1] + 1))
            written.append(_write_curve(
                os.path.join(out_dir, f"{slug}_acc.csv"), rounds_at, acc))
        loss = _pool_seed_rows(recs, payloads, "loss")
        if loss is not None:
            written.append(_write_curve(
                os.path.join(out_dir, f"{slug}_loss.csv"),
                range(1, loss.shape[1] + 1), loss))
    return written


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.experiments.plots",
        description="Export mean±CI curve CSVs from a results store "
                    "(no cells are re-run).")
    ap.add_argument("--store", required=True, help="results-store directory")
    ap.add_argument("--out", required=True, help="output directory for CSVs")
    ap.add_argument("--suite", default=None, help="only this suite tag")
    args = ap.parse_args(argv)
    filters = {"suite": args.suite} if args.suite else {}
    written = export_curves(ResultsStore(args.store), args.out, **filters)
    for path in written:
        print(path)
    print(f"# {len(written)} curve files -> {args.out}")


if __name__ == "__main__":
    main()

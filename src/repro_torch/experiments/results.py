"""Seed-axis summaries (port of ``repro.experiments.results.summarize``;
the JSONL/npz ``ResultsStore`` is ROADMAP Queue 1 item 2)."""
from __future__ import annotations

import math
from typing import Dict

import numpy as np


def summarize(values, confidence: str = "ci95") -> Dict[str, float]:
    """Mean / std / normal-approx 95% CI half-width over a 1-D seed axis;
    NaN entries are dropped first (``n`` counts the finite values)."""
    v = np.asarray(values, np.float64).ravel()
    v = v[~np.isnan(v)]
    n = int(v.size)
    mean = float(v.mean()) if n else float("nan")
    std = float(v.std(ddof=1)) if n > 1 else 0.0
    half = 1.96 * std / math.sqrt(n) if n > 1 else 0.0
    return {"mean": mean, "std": std, "n": n, confidence: half}

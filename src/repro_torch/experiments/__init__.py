"""Batched experiment sweeps on the PyTorch port.

- ``sweep``   — ``make_batched_run_rounds``: all (algorithm x point x seed)
  trajectories of one (family, scheme) cell as one batch; the sweep CLI.
- ``grid``    — ``SweepSpec`` grids and the executor (``run_sweep``).
- ``results`` — the append-only JSONL/npz results store (the reference's
  format) with mean/CI summaries and cross-store ``merge`` + CLI.
- ``plots``   — figure-style curve CSV exports straight from a store.
- ``tasks``   — the shared synthetic task and the flat-buffer MLP.
"""
from repro_torch.experiments.grid import (
    ALGOS,
    HPARAM_FIELDS,
    SCHEMES,
    CellResult,
    SweepSpec,
    run_cell,
    run_cell_batch,
    run_sweep,
)
from repro_torch.experiments.results import ResultsStore, git_sha, summarize
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
)

__all__ = [
    "ALGOS",
    "HPARAM_FIELDS",
    "SCHEMES",
    "CellResult",
    "SweepSpec",
    "run_cell",
    "run_cell_batch",
    "run_sweep",
    "ResultsStore",
    "git_sha",
    "summarize",
    "CellBatch",
    "eval_rounds",
    "make_batched_run_rounds",
    "seed_generators",
    "ClassificationTask",
    "TracedClassificationTask",
    "make_classification_task",
    "make_traced_classification_task",
]

"""Batched experiment sweeps on the PyTorch port.

- ``sweep``   — ``make_batched_run_rounds``: all (algorithm x point x seed)
  trajectories of one (family, scheme) cell as one batch;
  ``make_vmap_run_rounds`` is its single-point seed-axis wrapper; the
  sweep CLI.
- ``grid``    — ``SweepSpec`` grids and the executor (``run_sweep``).
- ``shard``   — a cell's batch split over a mesh's devices, one worker
  process each (``run_sharded``, ``run_sharded_2d``).
- ``results`` — the append-only JSONL/npz results store (the reference's
  format) with mean/CI summaries and cross-store ``merge`` + CLI.
- ``plots``   — figure-style curve CSV exports straight from a store.
- ``search``  — adaptive hyperparameter search (successive halving on
  resumable rung segments, elastic re-packing) and its CLI.
- ``tasks``   — the shared synthetic task and the flat-buffer MLP; the
  LM task (a reduced transformer over a styled corpus).
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
    seed_base_probs,
)
from repro_torch.experiments.results import ResultsStore, git_sha, summarize
from repro_torch.experiments.search import (
    SearchOutcome,
    SearchSpec,
    run_search,
    sample_point,
)
from repro_torch.experiments.sweep import (
    CellBatch,
    eval_rounds,
    make_batched_run_rounds,
    make_vmap_run_rounds,
    seed_generators,
)
from repro_torch.experiments.tasks import (
    ClassificationTask,
    TracedClassificationTask,
    make_classification_task,
    make_traced_classification_task,
    mlp_accuracy,
    mlp_init,
    mlp_loss,
    with_label_noise,
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
    "seed_base_probs",
    "ResultsStore",
    "git_sha",
    "summarize",
    "SearchOutcome",
    "SearchSpec",
    "run_search",
    "sample_point",
    "CellBatch",
    "eval_rounds",
    "make_batched_run_rounds",
    "make_vmap_run_rounds",
    "seed_generators",
    "ClassificationTask",
    "TracedClassificationTask",
    "make_classification_task",
    "make_traced_classification_task",
    "mlp_accuracy",
    "mlp_init",
    "mlp_loss",
    "with_label_noise",
]

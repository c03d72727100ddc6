"""Cross-device scale in PyTorch (port of ``repro.scale``): cohort
subsampling, buffered semi-async aggregation and sparse per-client state.
``core/federated.py`` threads them through the round engine
(``make_round_fn(strategy=..., cohort_size=...)``) and
``experiments/grid.py`` exposes them as sweep axes
(``SweepSpec.strategies`` / ``SweepSpec.cohort_size``)."""
from repro_torch.scale.buffer import (
    BUFFER_METRIC_KEYS,
    STRATEGY_KNOB_FIELDS,
    SYNC,
    BufferState,
    Strategy,
    buffered_aggregate,
    init_buffer_state,
    knobs_of,
    strategy_knob_columns,
)
from repro_torch.scale.participation import (
    cohort_arrivals,
    sample_cohort,
    scatter_mask,
)
from repro_torch.scale.sparse_state import COHORT_STATEFUL, cohort_branch

__all__ = [
    "BUFFER_METRIC_KEYS",
    "STRATEGY_KNOB_FIELDS",
    "SYNC",
    "BufferState",
    "Strategy",
    "buffered_aggregate",
    "init_buffer_state",
    "knobs_of",
    "strategy_knob_columns",
    "cohort_arrivals",
    "sample_cohort",
    "scatter_mask",
    "COHORT_STATEFUL",
    "cohort_branch",
]

from repro_torch.data.partition import dirichlet_partition
from repro_torch.data.sources import (
    DataSource,
    classification_source,
    fixed_source,
    lm_source,
    memory_shape,
    traced_classification_source,
)
from repro_torch.data.synthetic import make_classification_data

__all__ = [
    "dirichlet_partition",
    "make_classification_data",
    "DataSource",
    "classification_source",
    "fixed_source",
    "lm_source",
    "memory_shape",
    "traced_classification_source",
]

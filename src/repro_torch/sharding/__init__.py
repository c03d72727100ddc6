"""Multi-device execution of the port (the reference's GSPMD placement).

- ``pool`` starts and runs one worker process per mesh device, and its
  ``ModelAxis`` is the round's all-gather over a ``"model"`` axis;
  ``repro_torch.experiments.shard`` drives it for the sweep.
- ``specs`` is the reference's spec chooser for parameters, optimizer
  state and caches, with the activation hooks and the spec's DTensor
  placements; ``spmd`` runs rank 0 of a production mesh under a simulated
  process group, where the dry run places its steps as DTensor programs.
"""
from repro_torch.sharding.specs import (
    P,
    activation_sharding,
    activation_spec,
    infer_pytree_specs,
    maybe_constrain,
    placements,
    set_activation_spec,
    set_mesh,
    spec_for_shape,
)

__all__ = [
    "P",
    "activation_sharding",
    "activation_spec",
    "infer_pytree_specs",
    "maybe_constrain",
    "placements",
    "set_activation_spec",
    "set_mesh",
    "spec_for_shape",
]

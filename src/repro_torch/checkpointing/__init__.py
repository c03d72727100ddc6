"""Checkpoints of the port's state trees (port of ``repro.checkpointing``)."""
from repro_torch.checkpointing.checkpoint import latest_step, restore, save

__all__ = ["save", "restore", "latest_step"]

"""Meshes of the sweep's multi-device split (port of
``repro.launch.mesh``'s sweep meshes). Factories only: importing this
module touches no device state.

A :class:`Mesh` names the devices one sharded call runs on, one worker
process each (``repro_torch.sharding.pool``), laid out row-major over its
axes: rank ``r`` runs on ``devices[r]``, and on a ``("batch", "model")``
mesh it is batch index ``r // model`` and model index ``r % model``. The
same device may appear more than once (several ranks sharing one card, or
CPU ranks).

The production meshes (``make_production_mesh``, ``dp_axes``,
``num_clients_for``) are the dry run's: the reference's ``(16, 16)`` over
``("data", "model")`` and ``(2, 16, 16)`` over ``("pod", "data",
"model")``, as layouts of H100 cards. No host holds 256 of them, so their
devices are ``meta``; ``repro_torch.sharding.spmd`` runs rank 0 of such a
mesh under a simulated process group.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

import torch


@dataclass(frozen=True)
class Mesh:
    """``axis_names`` with their sizes ``dims`` over ``devices`` (rank
    order, ``prod(dims)`` of them). Equal meshes hash equal."""

    axis_names: Tuple[str, ...]
    dims: Tuple[int, ...]
    devices: Tuple[torch.device, ...]

    def __post_init__(self):
        object.__setattr__(self, "axis_names", tuple(self.axis_names))
        object.__setattr__(self, "dims", tuple(int(d) for d in self.dims))
        object.__setattr__(self, "devices",
                           tuple(torch.device(d) for d in self.devices))
        if len(self.axis_names) != len(self.dims):
            raise ValueError(f"mesh axes {self.axis_names} and sizes "
                             f"{self.dims} differ in length")
        if self.size != len(self.devices):
            raise ValueError(f"a mesh of sizes {self.dims} needs {self.size} "
                             f"devices, got {len(self.devices)}")

    @property
    def shape(self) -> Dict[str, int]:
        """``{axis name: size}``, as ``mesh.shape["batch"]`` reads it."""
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        """The number of ranks (devices, with repeats)."""
        n = 1
        for d in self.dims:
            n *= d
        return n


def _devices(devices) -> Tuple[torch.device, ...]:
    if devices is not None:
        return tuple(torch.device(d) for d in devices)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch meshes default to every visible CUDA device and "
            "CUDA is not available here; pass devices=[...] (e.g. "
            "['cpu'] * 4) to run the ranks on the CPU")
    return tuple(torch.device("cuda", i)
                 for i in range(torch.cuda.device_count()))


def make_batch_mesh(devices: Sequence = None) -> Mesh:
    """1-D ``("batch",)`` mesh splitting a cell's trajectory axis over
    ``devices`` (default: every visible CUDA device; raises without one)."""
    devs = _devices(devices)
    return Mesh(("batch",), (len(devs),), devs)


def make_2d_mesh(batch: int, model: int, devices: Sequence = None) -> Mesh:
    """2-D ``("batch", "model")`` mesh for the sharded sweep: trajectories
    split over ``"batch"``, each trajectory's clients over ``"model"``
    (``repro_torch.experiments.shard.run_sharded_2d``). ``batch * model``
    must equal the device count; ``make_2d_mesh(n, 1)`` is the 1-D split
    with a degenerate model axis."""
    devs = _devices(devices)
    if batch * model != len(devs):
        raise ValueError(
            f"make_2d_mesh({batch}, {model}) needs {batch * model} devices, "
            f"got {len(devs)}")
    return Mesh(("batch", "model"), (batch, model), devs)


def make_host_mesh() -> Mesh:
    """Single-device mesh for CPU smoke runs (the reference's axis names
    ``("data", "model")``; it has no ``"batch"`` axis)."""
    return Mesh(("data", "model"), (1, 1), (torch.device("cpu"),))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh, ``(16, 16)`` over ``("data",
    "model")`` or, ``multi_pod``, ``(2, 16, 16)`` over ``("pod", "data",
    "model")``, its devices ``meta`` (a layout of cards, not cards)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for d in shape:
        n *= d
    return Mesh(axes, shape, (torch.device("meta"),) * n)


def dp_axes(mesh) -> tuple:
    """The data-parallel axes: ``("pod", "data")`` on the multi-pod mesh."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def num_clients_for(mesh) -> int:
    """``pod_silo`` placement: one federated client per pod."""
    return mesh.shape["pod"] if "pod" in mesh.axis_names else 1


__all__ = ["Mesh", "dp_axes", "make_batch_mesh", "make_2d_mesh",
           "make_host_mesh", "make_production_mesh", "num_clients_for"]

"""Sharding specs for parameters, optimizer state and caches (port of
``repro.sharding.specs``).

The reference's rule-based GSPMD spec chooser, rule for rule. For each
array leaf:
  - an explicit leading *client* axis (the federated ``pod_silo``
    placement) is sharded over ``"pod"`` when the mesh has it;
  - the last dimension divisible by the ``"model"`` axis is tensor-sharded;
  - the largest remaining dimension divisible by the ``"data"`` axis is
    FSDP-sharded;
  - everything else is replicated.

A spec is a :class:`P`: one entry per tensor dim, each an axis name,
``None`` (replicated) or a tuple of names (one dim over several axes,
major first), as ``jax.sharding.PartitionSpec``. The spec functions read a
mesh's ``axis_names`` and ``shape[name]`` only, so they take the port's
``launch.mesh.Mesh`` (and, in the tests, the reference's abstract meshes).
:func:`placements` turns a spec into DTensor placements on that mesh: a
dim over two axes is ``Shard(d)`` on both mesh dims, major axis first, the
layout JAX gives it; an uneven dim stays uneven (DTensor shards as
``torch.chunk``, so rank 0 holds the ceiling: GSPMD's padded shard).

Activations use Megatron-style sequence parallelism between blocks: the
residual stream ``[B, T, D]`` is constrained to ``P(dp, "model", None)``
(T over the tensor axis) through the ``set_activation_spec`` context hook
that ``repro_torch.models.model`` consults at each period's boundaries
(:func:`maybe_constrain`). Without a mesh (:func:`set_mesh`), or on a tensor
that is not a DTensor, the hook returns its input unchanged. The sharded
sweep's worker processes split sequences another way, with explicit
collectives (:func:`sequence_axis`, ``sharding.pool.SequenceAxis``).
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Optional

_ctx = threading.local()


class P(tuple):
    """A partition spec: ``P("data", None, ("pod", "data"))``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):
        return tuple(self)      # pickles as P(*entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def set_activation_spec(spec: Optional[P]):
    _ctx.spec = spec


def activation_spec() -> Optional[P]:
    return getattr(_ctx, "spec", None)


@contextmanager
def activation_sharding(spec: Optional[P]):
    old = activation_spec()
    set_activation_spec(spec)
    try:
        yield
    finally:
        set_activation_spec(old)


def sequence_axis():
    """The sequence-parallel axis of the forward running in this thread
    (``repro_torch.sharding.pool.SequenceAxis``, installed by its
    ``active()``), or None: ``repro_torch.models.model`` then splits each
    sequence over the axis's ranks and all-gathers K and V."""
    return getattr(_ctx, "sequence", None)


@contextmanager
def sequence_parallel(axis):
    """Install ``axis`` as :func:`sequence_axis` for the block."""
    old = sequence_axis()
    _ctx.sequence = axis
    try:
        yield
    finally:
        _ctx.sequence = old


def set_mesh(mesh, device_mesh=None):
    """The mesh the hooks place on (``None``: no mesh), and its
    ``torch.distributed`` ``DeviceMesh`` (``sharding.spmd`` sets both)."""
    _ctx.mesh = mesh
    _ctx.device_mesh = device_mesh


def current_mesh():
    return getattr(_ctx, "mesh", None)


def _entry_size(mesh, ax) -> int:
    size = 1
    for a in (ax if isinstance(ax, tuple) else (ax,)):
        size *= mesh.shape[a]
    return size


def maybe_constrain(x):
    """Apply the context activation spec to a residual whose trailing dims
    are the spec's (``[B, T, D]``; the port's ``[G, b, T, D]`` carries the
    models' axis G first), when a mesh is set and ``x`` is a DTensor: each
    trailing dim over its spec axes where their size divides it (else
    replicated), as the reference's ``with_sharding_constraint``; a
    leading dim keeps a mesh axis the spec does not use."""
    spec = activation_spec()
    mesh = current_mesh()
    dmesh = getattr(_ctx, "device_mesh", None)
    if spec is None or mesh is None or dmesh is None:
        return x
    from torch.distributed.tensor import DTensor, Replicate, Shard

    lead = x.dim() - len(spec) if isinstance(x, DTensor) else -1
    if lead < 0:
        return x
    ok = P(*([None] * lead), *[
        ax if ax is not None and dim % _entry_size(mesh, ax) == 0 else None
        for dim, ax in zip(x.shape[lead:], spec)])
    want = list(placements(ok, mesh))
    for i, (have, new) in enumerate(zip(x.placements, want)):
        if (isinstance(new, Replicate) and isinstance(have, Shard)
                and have.dim < lead):
            want[i] = have
    want = tuple(want)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(dmesh, want)


def _axis_ok(dim: int, mesh, axis: str) -> bool:
    return axis in mesh.axis_names and dim % mesh.shape[axis] == 0


def spec_for_shape(shape, mesh, *, client_axis: bool = False,
                   model_axis="model", data_axis="data", pod_axis="pod") -> P:
    """Choose a spec for one array shape.

    A dim that does not divide the model axis is still sharded when it is at
    least as large as the axis (GSPMD pads the ragged last shard): LM leaves
    with odd dims (a 49152x577 tied embedding) would otherwise replicate on
    every device. Dims smaller than the axis replicate."""
    spec = [None] * len(shape)
    start = 0
    if client_axis and len(shape) >= 1:
        start = 1  # the client axis is never tensor/fsdp-sharded
        if (pod_axis in mesh.axis_names
                and shape[0] % mesh.shape[pod_axis] == 0):
            spec[0] = pod_axis
    body = list(range(start, len(shape)))
    if not body:
        return P(*spec)
    # tensor axis: last divisible dim (prefer the true last)
    for d in reversed(body):
        if (_axis_ok(shape[d], mesh, model_axis)
                and shape[d] >= mesh.shape[model_axis]):
            spec[d] = model_axis
            body.remove(d)
            break
    else:
        # pad-or-replicate fallback: no dim divides the model axis; shard
        # the largest dim that can still fill every device (>= axis size)
        if model_axis in mesh.axis_names:
            n = mesh.shape[model_axis]
            cands = [d for d in body if shape[d] >= n]
            if cands:
                d = max(cands, key=lambda d: shape[d])
                spec[d] = model_axis
                body.remove(d)
    # fsdp axis: largest remaining divisible dim
    body.sort(key=lambda d: -shape[d])
    for d in body:
        if (_axis_ok(shape[d], mesh, data_axis)
                and shape[d] >= mesh.shape[data_axis] * 2):
            spec[d] = data_axis
            break
    return P(*spec)


def _moe_expert_spec(shape, mesh, *, client_axis: bool) -> Optional[P]:
    """Expert-parallel: shard the expert dim of ``[E, d, f]`` weights over
    ``"model"`` (each shard owns E/model experts; token routing becomes an
    all-to-all)."""
    off = 1 if client_axis else 0
    if len(shape) != 3 + off:
        return None
    e = shape[off]
    if not _axis_ok(e, mesh, "model"):
        return None
    spec = ([("pod" if "pod" in mesh.axis_names
              and shape[0] % mesh.shape["pod"] == 0 else None)]
            if client_axis else [])
    spec += ["model", None, None]
    if _axis_ok(shape[off + 1], mesh, "data"):
        spec[off + 1] = "data"
    elif _axis_ok(shape[off + 2], mesh, "data"):
        spec[off + 2] = "data"
    return P(*spec)


def leaf_spec(name: str, shape, mesh, *, client_axis: bool = False) -> P:
    """The spec of the leaf ``name`` (dotted, ``blocks.0.moe.up``): the
    expert rule where a name part is ``moe``, else :func:`spec_for_shape`."""
    if "moe" in name.split("."):
        sp = _moe_expert_spec(tuple(shape), mesh, client_axis=client_axis)
        if sp is not None:
            return sp
    return spec_for_shape(tuple(shape), mesh, client_axis=client_axis)


def infer_pytree_specs(tree, mesh, *, client_axis: bool = False):
    """:func:`leaf_spec` over a dict of leaves ``{name: tensor or shape}``
    (the port's leaf dicts), keyed alike."""
    return {name: leaf_spec(name, getattr(x, "shape", x), mesh,
                            client_axis=client_axis)
            for name, x in tree.items()}


def placements(spec: P, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh axis:
    ``Shard(d)`` where tensor dim ``d``'s entry names the axis, else
    ``Replicate()``. A dim over several axes must list them in mesh order
    (major first), the only order DTensor lays out."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate()] * len(mesh.axis_names)
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        idx = [mesh.axis_names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: dim {d} lists axes {axes} out of "
                             f"the mesh's order {mesh.axis_names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def shard_shape(shape, spec: P, mesh) -> tuple:
    """Rank 0's local shape of a ``shape`` leaf under ``spec``: each dim
    divided by its axes' sizes, rounded up (GSPMD's padded shard)."""
    out = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * len(shape)):
        if ax is None:
            out.append(dim)
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        for a in axes:
            dim = -(-dim // mesh.shape[a])
        out.append(dim)
    return tuple(out)

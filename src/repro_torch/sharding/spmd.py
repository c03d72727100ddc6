"""A simulated process group for a production mesh: rank 0 of ``mesh.size``
ranks under ``torch.distributed``'s ``"fake"`` backend, so DTensor programs
on a 256- or 512-card mesh run (and are counted, ``launch/dryrun.py``) in
one process.

Every collective of the fake group returns at once and delivers no other
rank's data: the local tensors of a program run this way have the shapes
and dtypes rank 0 would hold and computes on them, but a value that passed
through a collective is not rank 0's real value.
"""
from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Dict

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves, tree_map_only

from repro_torch.sharding import specs


@contextmanager
def simulated_mesh(mesh, device_type: str = "cpu"):
    """Yield the ``DeviceMesh`` of ``mesh`` (the port's ``Mesh``: its sizes
    and axis names) as rank 0 of a fake group of ``mesh.size`` ranks, with
    the spec hooks set to it (``specs.set_mesh``). ``device_type``: where
    the local tensors live, ``"cpu"`` (meta tensors included) or
    ``"cuda"``. Refuses when a group is already up; on exit the group is
    destroyed and the hooks cleared, also after an error."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a torch.distributed group is already up; the "
                           "simulated mesh needs a process of its own")
    clear_propagation_caches()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=mesh.size)
    try:
        dmesh = init_device_mesh(device_type, tuple(mesh.dims),
                                 mesh_dim_names=tuple(mesh.axis_names))
        specs.set_mesh(mesh, dmesh)
        yield dmesh
    finally:
        specs.set_mesh(None)
        dist.destroy_process_group()


def clear_propagation_caches():
    """Empty DTensor's sharding-propagation caches. Their keys leave out
    some scalar arguments (``topk``'s ``k``), so a program run after
    another on a mesh of the same shape could take the other's output
    shapes."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    prop = DTensor._op_dispatcher.sharding_propagator
    prop.propagate_op_sharding.cache_clear()
    ShardingPropagator._propagate_tensor_meta_cached.cache_clear()
    torch._C._clear_DTensor_sharding_propagator_cache()


def distribute_empty(shape, dtype, spec, mesh, dmesh, device="meta",
                     fill=None):
    """A DTensor of global ``shape`` placed by ``spec`` (``specs.P``) on
    ``dmesh``: rank 0's local shard, empty (``fill=None``) or
    ``fill(local_shape, dtype)``'s tensor, on ``device``."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )

    pl = specs.placements(spec, mesh)
    local, _ = compute_local_shape_and_global_offset(tuple(shape), dmesh, pl)
    t = (torch.empty(local, dtype=dtype, device=device) if fill is None
         else fill(tuple(local), dtype))
    stride = torch.empty(tuple(shape), device="meta").stride()
    return DTensor.from_local(t, dmesh, pl, shape=torch.Size(shape),
                              stride=stride, run_check=False)


def view_placements(in_shape, out_shape, placements, mesh_sizes) -> tuple:
    """``(input placements, output placements)`` of a contiguous view from
    ``in_shape`` to ``out_shape`` on a mesh of ``mesh_sizes``.

    Each input dim is factored as its shards in mesh order (a dim sharded
    by ``pod`` then ``data`` splits as ``(n_pod, n_data, rest)``), and the
    factors are laid out along the output dims: a shard factor that starts
    an output dim, or follows only shard factors there in mesh order,
    shards that output dim; one that would straddle two output dims or
    follow a plain factor is not a layout DTensor can hold, and that mesh
    dim is replicated before the view (as is an uneven or strided shard).
    Partial sums pass through."""
    from torch.distributed.tensor import Replicate, Shard

    dropped = {i for i, p in enumerate(placements)
               if isinstance(p, Shard) and type(p) is not Shard}
    while True:
        mapped = _lay_out(in_shape, out_shape, placements, mesh_sizes,
                          dropped)
        if isinstance(mapped, dict):
            break
        dropped.add(mapped)
    p_in = [Replicate() if i in dropped else p
            for i, p in enumerate(placements)]
    p_out = [Shard(mapped[i]) if i in mapped else p
             for i, p in enumerate(p_in)]
    return tuple(p_in), tuple(p_out)


def _lay_out(in_shape, out_shape, placements, mesh_sizes, dropped):
    """``{mesh dim: output dim}`` of ``view_placements``, or the first mesh
    dim whose shard cannot be laid out."""
    from torch.distributed.tensor import Shard

    atoms = []                              # [size, mesh dim or None]
    for d, size in enumerate(in_shape):
        dims = [i for i, p in enumerate(placements) if i not in dropped
                and isinstance(p, Shard) and p.dim == d]
        n = math.prod(mesh_sizes[i] for i in dims)
        if size % n:
            return dims[-1]                 # uneven: replicate its shards
        for i in dims:
            atoms.append([mesh_sizes[i], i])
        atoms.append([size // n, None])
    mapped = {}
    k = 0
    for e, need in enumerate(out_shape):
        plain, last = False, -1
        while k < len(atoms) and (need > 1 or atoms[k][0] == 1):
            size, tag = atoms[k]
            if tag is not None:
                if size == 1:               # a mesh dim of one: any place
                    mapped[tag] = e
                elif plain or need % size or tag < last:
                    return tag
                else:
                    mapped[tag], last, need = e, tag, need // size
                k += 1
            elif size == 1:
                k += 1
            elif need % size == 0:
                need //= size
                plain = True
                k += 1
            elif size % need == 0:
                atoms[k][0] = size // need
                need, plain = 1, True
            else:                           # no common factoring
                tags = [t for _, t in atoms if t is not None]
                return tags[0] if tags else {}
    for size, tag in atoms[k:]:
        if tag is not None:
            mapped[tag] = len(out_shape) - 1
    return mapped


_VIEWS = ("aten::view", "aten::_unsafe_view")


def _index_copy_along(func, x, dim, index, source):
    """``x.index_copy(dim, index, source)`` where DTensor has no rule:
    the mesh dims that shard ``dim`` replicated, the others kept (the copy
    acts along ``dim`` alone), on rank 0's local tensors; ``index``
    replicated, ``source`` laid out as ``x``."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = x.device_mesh
    dim = dim % x.dim()
    pl = tuple(Replicate() if isinstance(p, Shard) and p.dim == dim
               else p for p in x.placements)
    rep = (Replicate(),) * mesh.ndim

    def local(t, placements):
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, rep, run_check=False)
        return t.redistribute(mesh, placements).to_local()

    out = func(local(x, pl), dim, local(index, rep), local(source, pl))
    return DTensor.from_local(out, mesh, pl, shape=x.shape,
                              stride=x.stride(), run_check=False)


# The ops of the port's steps that DTensor has no working rule for on some
# layout, each with the errors DTensor raises for it (type, a part of the
# message), as torch 2.13 and 2.11 raise them: only these are retried
# (``LayoutFixups``). Any other error, of these ops or of any other, is the
# program's and propagates.
_NO_STRATEGY = (NotImplementedError, "does not have a sharding strategy")
RETRIED = {
    # an argmax over a sharded dim: DTensor views its local result at a
    # shape of the global one
    "aten.argmax.default": ((RuntimeError, "is invalid for input of size"),),
    # the MoE's in-place scatter into a plain buffer, by DTensor indices
    # (DTensor's assertion carries no message: the op and type decide)
    "aten.scatter_add_.default": ((AssertionError, ""),),
    # a view of a non-contiguous sharded tensor (``_view`` places the
    # contiguous ones), as 2.13 and 2.11 word the refusal
    "aten.view.default": ((RuntimeError, "requires redistribution"),
                          (RuntimeError, "performed without redistribution")),
    # 2.11: the embedding's lookup in a vocab-sharded table on 2x16x16
    "aten.index.Tensor": ((RuntimeError, "Sharding propagation failed on "
                           "op aten.index.Tensor"),),
    # the decode cache's write: no rule in 2.11
    "aten.index_copy.default": (_NO_STRATEGY,),
    # the embedding gradient's accumulation in a 2x16x16 round: 2.11's
    # propagator refuses its own un-normalized Shard(-1)
    "aten.index_put.default": (_NO_STRATEGY,
                               (RuntimeError, "must be normalized")),
}


def _no_rule(func, err: BaseException) -> bool:
    """Whether ``err`` is a refusal of ``func`` that ``RETRIED`` lists."""
    return any(isinstance(err, kind) and part in str(err)
               for kind, part in RETRIED.get(str(func), ()))


class LayoutFixups(TorchDispatchMode):
    """DTensor fix-ups for the simulated mesh, as a dispatch mode over
    DTensor:

    - views (``aten.view``, ``aten._unsafe_view``) are placed by
      :func:`view_placements`, rank 0's local tensor viewed to its local
      shape: DTensor's own rule makes strided layouts whose redistribution
      plans cost seconds each on a 3-D mesh, and mislays a split of an
      unevenly sharded dim;
    - an op of ``RETRIED`` that DTensor refuses on its inputs' layout,
      with the error listed there, is retried on those inputs replicated,
      the layout GSPMD falls back to, and failing so again (an in-place op
      on a plain tensor that takes DTensor operands) on rank 0's
      replicated local tensors, its result replicated; ``index_copy`` (the
      decode cache's write, which some DTensor versions have no rule for)
      is replicated only along the dim it writes (``_index_copy_along``);
      ``retries`` counts them by op. Every other error propagates.

    ``snapshot()`` / ``restore(state)`` (a counting mode's) undo what a
    failed attempt counted; ``op`` names the DTensor op running (None
    between ops: a redistribution the program asks for itself)."""

    def __init__(self, snapshot=None, restore=None):
        super().__init__()
        self.retries: Dict[str, int] = {}
        self._snapshot, self._restore = snapshot, restore
        self.op = None

    def _view(self, func, x, size):
        from torch.distributed.tensor import DTensor
        from torch.distributed.tensor._utils import (
            compute_local_shape_and_global_offset,
        )

        size = list(size)
        if -1 in size:
            k = size.index(-1)
            size[k] = 1
            size[k] = x.numel() // math.prod(size)
        mesh = x.device_mesh
        p_in, p_out = view_placements(tuple(x.shape), tuple(size),
                                      tuple(x.placements), tuple(mesh.shape))
        if p_in != tuple(x.placements):
            x = x.redistribute(mesh, p_in)
        local, _ = compute_local_shape_and_global_offset(tuple(size), mesh,
                                                         p_out)
        loc = x.to_local()
        # a redistribution's local chunk of an inner dim is a strided view
        out = func(loc if loc.is_contiguous() else loc.contiguous(),
                   list(local))
        stride = torch.empty(tuple(size), device="meta").stride()
        return DTensor.from_local(out, mesh, p_out, shape=torch.Size(size),
                                  stride=stride, run_check=False)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if not any(issubclass(t, DTensor) for t in types):
            return func(*args, **kwargs)
        outer, self.op = self.op, self.op or str(func)
        try:
            return self._dispatch(func, args, kwargs)
        finally:
            self.op = outer

    def _dispatch(self, func, args, kwargs):
        from torch.distributed.tensor import DTensor, Replicate

        if (func.name() in _VIEWS and isinstance(args[0], DTensor)
                and args[0].is_contiguous()):
            return self._view(func, args[0], args[1])
        state = self._snapshot() if self._snapshot else None
        try:
            return func(*args, **kwargs)
        except Exception as err:   # noqa: BLE001 (re-raised unless listed)
            if not _no_rule(func, err):
                raise
            if self._restore:
                self._restore(state)
        key = str(func)
        self.retries[key] = self.retries.get(key, 0) + 1
        if func.name() == "aten::index_copy" and not kwargs:
            return _index_copy_along(func, *args)
        mesh = next(a.device_mesh for a in tree_leaves((args, kwargs))
                    if isinstance(a, DTensor))
        rep = (Replicate(),) * mesh.ndim
        args, kwargs = tree_map_only(
            DTensor, lambda a: a.redistribute(mesh, rep), (args, kwargs))
        state = self._snapshot() if self._snapshot else None
        try:
            return func(*args, **kwargs)
        except Exception as err:   # noqa: BLE001 (re-raised unless listed)
            if not _no_rule(func, err):
                raise
            if self._restore:
                self._restore(state)
        args, kwargs = tree_map_only(DTensor, lambda a: a.to_local(),
                                     (args, kwargs))
        out = func(*args, **kwargs)
        if func._schema.is_mutable:
            return out
        return tree_map_only(torch.Tensor, lambda t: DTensor.from_local(
            t, mesh, rep, run_check=False), out)


def _local_layout(x, keep_dims, ok=lambda d, size: True) -> tuple:
    """``x``'s placements with every ``Shard`` of a dim outside
    ``keep_dims`` (or refused by ``ok(dim, axis size)``) and every
    ``Partial`` made ``Replicate``."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = x.device_mesh
    return tuple(
        p if isinstance(p, Shard) and p.dim in keep_dims
        and ok(p.dim, mesh.size(i)) else Replicate()
        for i, p in enumerate(x.placements))


def _to_layout(x, placements, like):
    """``x`` (a DTensor, or a plain tensor: replicated on ``like``'s mesh)
    in ``placements``, as rank 0's local tensor."""
    from torch.distributed.tensor import DTensor, Replicate

    mesh = like.device_mesh
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, (Replicate(),) * mesh.ndim,
                               run_check=False)
    return x.redistribute(mesh, placements).to_local()


def _from_local(local, like, placements, shape=None):
    from torch.distributed.tensor import DTensor

    shape = torch.Size(shape if shape is not None else like.shape)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, like.device_mesh, placements,
                              shape=shape, stride=stride, run_check=False)


def local_attention(attention):
    """``attention(q, k, v, **kw)`` (``dispatch.attention``'s signature)
    for DTensors: GQA's KV heads repeated on the mesh, then q, k and v laid
    out alike with only the batch (dim 0) and, where the mesh axis divides
    them, the heads (dim 2) sharded, and ``attention`` run on each rank's
    local tensors, the shapes its kernels launch at. Plain tensors pass
    straight through."""
    from torch.distributed.tensor import DTensor

    from repro_torch.models.attention import repeat_kv

    def run(q, k, v, **kw):
        if not isinstance(q, DTensor):
            return attention(q, k, v, **kw)
        n_rep = q.shape[2] // k.shape[2]
        k, v = repeat_kv(k, n_rep), repeat_kv(v, n_rep)
        heads = q.shape[2]
        pl = _local_layout(q, (0, 2), lambda d, n: d == 0 or heads % n == 0)
        out = attention(*(_to_layout(x, pl, q) for x in (q, k, v)), **kw)
        return _from_local(out, q, pl)

    return run


def local_wkv6(wkv6):
    """``wkv6(r, k, v, w, u, s0, **kw)`` (``dispatch.wkv6``'s signature)
    for DTensors: ``r, k, v, w [B, H, T, D]`` and ``s0 [B, H, D, D]`` with
    only the batch (dim 0) sharded as ``r`` is, ``u [H, D]`` replicated,
    and ``wkv6`` run on each rank's local tensors."""
    from torch.distributed.tensor import DTensor, Replicate

    def run(r, k, v, w, u, s0, **kw):
        if not isinstance(r, DTensor):
            return wkv6(r, k, v, w, u, s0, **kw)
        pl = _local_layout(r, (0,))
        rep = (Replicate(),) * len(pl)
        o, s_t = wkv6(*(_to_layout(x, pl, r) for x in (r, k, v, w)),
                      _to_layout(u, rep, r), _to_layout(s0, pl, r), **kw)
        return (_from_local(o, r, pl),
                _from_local(s_t, r, pl, shape=tuple(s0.shape)))

    return run

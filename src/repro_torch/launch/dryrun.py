"""Dry run on the meta device (port of ``repro.launch.dryrun``): every
(architecture × input shape) step at the config's published size, run on
tensors that carry shapes and dtypes and no data, counted and put on the
H100's roofline. It needs no card and allocates nothing of the model's size.

For each arch × ``applicable_shapes(cfg)`` the step of ``launch/steps.py``
(train: one FedPBC round of one client holding the shape's global batch,
one local step, as the reference's single-pod mesh; prefill: ``forward``;
decode: one ``decode_step`` against a full cache) runs eagerly on meta:

- FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` (every matmul,
  forward and backward, and each activation-checkpointed chunk recomputed);
- bytes: the sum over the step's aten ops of each input's and each
  output's bytes (an input that broadcasts counts its storage), the
  counterpart of XLA's "bytes accessed"; views, which move nothing, count
  nothing;
- parameter bytes and the step's input bytes (the ``FedState`` and batches,
  or the params, cache and tokens), and whether those fit one 80 GB card
  (activations are not counted: meta tensors have no allocator to ask).

Attention is counted as the card runs it (``dispatch.attention`` is
swapped for ``_card_attention`` while the step runs): at the flash
kernels' shapes (``dispatch.flash_shape_ok``) the torch ops around the
kernels (GQA's repeat, the transposes, the wrapper's contiguous copies)
run on meta and each of the three kernels adds its work
(``roofline.flash_work``: the causal pairs only, each operand moved
once), so no ``T x T`` score tensor is counted; every other shape takes
the plain version, as on the card. The WKV6 recurrence (the rwkv rows)
likewise: ``dispatch.wkv6`` is swapped for ``_card_wkv6``, whose forward
and backward add ``roofline.wkv6_work`` and raise for a head dim the
kernels do not take (``rwkv6_chunk.HEAD_DIMS``), as the card does. The
steps ask for the plain versions (``steps.BACKEND``: no kernel has a meta
mode), which these swaps stand in for. The aggregation is the engine's
branch path, the launcher's default. Eager counting sees every loop trip, so the
reference's depth extrapolation (``_extrapolate`` over unrolled 1- and
2-period programs, ``models/flags.py``) has no counterpart. An arch ×
shape that cannot run on meta is a ``FAIL`` row with its error.

On the reference's production meshes (``main``'s rows: ``16x16`` over
``("data", "model")``, with ``--multi-pod`` ``2x16x16`` over ``("pod",
"data", "model")``, with ``--both-meshes`` both; ``launch/mesh.py``; the
one-card count is ``lower_pair(multi_pod=None)``) the step is a DTensor
program, PyTorch's
counterpart of GSPMD's sharding propagation: its inputs are placed by the
reference's specs (``launch/steps.py``, ``sharding/specs.py``) on a
simulated process group of 256 or 512 ranks (``sharding/spmd.py``), and
the residual stream takes the activation spec (``_act_spec``). The row is
rank 0's, per device: its local ops' flops (``flop_registry``) and bytes,
the flash and WKV6 kernels' work at the local shapes rank 0 would launch
(``spmd.local_attention``, ``spmd.local_wkv6``), its collectives by kind
with each op's output bytes (the reference's convention; an all-to-all that
DTensor makes as all-gather plus chunk on a CPU mesh is counted as the
all-to-all), ``param_bytes`` and ``argument_bytes`` of its shards, and the
collective term at ``LINK_BW``. Views are placed by
``spmd.view_placements``; an op DTensor has no rule for runs on its inputs
replicated (``index_copy`` only along its dim), and the row counts them
(``replicated_ops``; ``spmd.LayoutFixups``). The ops of the sharding
propagator itself (on fake tensors, at global shapes) are not counted.

Usage (CPU only):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m \\
      --both-meshes
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out X.json
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import time
import traceback
import warnings
from contextlib import contextmanager
from typing import Optional
from unittest import mock

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from repro_torch.configs import (
    ARCH_IDS,
    INPUT_SHAPES,
    ShapeConfig,
    applicable_shapes,
    get_config,
)
from repro_torch.kernels import dispatch as kdispatch
from repro_torch.kernels.flash_attention import padded_head_dim
from repro_torch.kernels.rwkv6_chunk import HEAD_DIMS as WKV6_HEAD_DIMS
from repro_torch.launch import steps
from repro_torch.launch.mesh import dp_axes, make_production_mesh
from repro_torch.launch.roofline import (
    Roofline,
    flash_work,
    model_flops_for,
    wkv6_work,
)
from repro_torch.models.attention import attention_ref, repeat_kv
from repro_torch.sharding import spmd
from repro_torch.sharding.specs import P, activation_sharding

MESH = "1xH100"
CARD_BYTES = 80e9
COUNTED_THROUGH = ("attention at the flash kernels' shapes as the kernels' "
                   "work (causal pairs, operands moved once); the WKV6 "
                   "recurrence as its kernels' work (roofline.wkv6_work); "
                   "the aggregation as the engine's branch path")
_ATEN = torch.ops.aten
# ops that move no bytes: allocation without a write
_NO_BYTES = {_ATEN.empty.memory_format, _ATEN.empty_strided.default,
             _ATEN.empty_like.default, _ATEN._unsafe_view.default}


def _nbytes(t: torch.Tensor) -> int:
    """A tensor's bytes, an input that broadcasts at its storage's size."""
    return min(t.numel() * t.element_size(), t.untyped_storage().nbytes())


class ByteCounter(TorchDispatchMode):
    """Sums each aten op's input and output bytes (views count nothing)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view and func not in _NO_BYTES:
            self.ops += 1
            self.bytes += sum(_nbytes(t) for t in tree_leaves(
                (args, kwargs, out)) if isinstance(t, torch.Tensor))
        return out


class FlashTally:
    """The flash kernels' work in a counted step: flops, bytes and
    launches by kernel."""

    def __init__(self):
        self.flops = 0
        self.bytes = 0
        self.launches = {"fwd": 0, "dq": 0, "dkdv": 0}
        self.shapes = set()     # (bh, t, d, window) of the forward launches

    def add(self, q: torch.Tensor, window: int, *kernels: str):
        bh, t, d = q.shape
        if "fwd" in kernels:
            self.shapes.add((bh, t, d, window))
        work = flash_work(bh, t, padded_head_dim(d), window,
                          q.element_size())
        for name in kernels:
            self.flops += work[name][0]
            self.bytes += work[name][1]
            self.launches[name] += 1


class _FlashWork(torch.autograd.Function):
    """The three flash kernels on meta ``[BH, T, D]``: empty outputs of
    their shapes, their work added to a ``FlashTally``."""

    @staticmethod
    def forward(ctx, q, k, v, window, tally):
        ctx.window, ctx.tally = window, tally
        tally.add(q, window, "fwd")
        return torch.empty_like(q)

    @staticmethod
    def backward(ctx, do):
        do = do.contiguous()                # as the wrapper's backward
        ctx.tally.add(do, ctx.window, "dq", "dkdv")
        return (torch.empty_like(do), torch.empty_like(do),
                torch.empty_like(do), None, None)


def _card_attention(tally: FlashTally):
    """``dispatch.attention`` as the card runs it, on meta (the module
    docstring); ``backend`` is ignored."""

    def attention(q, k, v, *, kind="full", window=4096, logit_softcap=0.0,
                  chunk=1024, q_offset=0, backend=None):
        if not kdispatch.flash_shape_ok(kind, q.shape[1], k.shape[1],
                                       q_offset):
            return attention_ref(q, k, v, kind=kind, window=window,
                                 logit_softcap=logit_softcap, chunk=chunk,
                                 q_offset=q_offset)
        b, t, h, d = q.shape
        n_rep = h // k.shape[2]
        flat = [x.transpose(1, 2).reshape(b * h, t, d).contiguous()
                for x in (q, repeat_kv(k, n_rep), repeat_kv(v, n_rep))]
        out = _FlashWork.apply(*flat, window if kind == "swa" else 0, tally)
        return out.view(b, h, t, d).transpose(1, 2)

    return attention


class WKV6Tally:
    """The WKV6 kernels' work in a counted step: flops, bytes and launches
    by direction."""

    def __init__(self):
        self.flops = 0
        self.bytes = 0
        self.launches = {"fwd": 0, "bwd": 0}

    def add(self, r: torch.Tensor, heads: int, direction: str):
        b, h, t, d = r.shape
        flops, nbytes = wkv6_work(b * h, t, d, heads)[direction]
        self.flops += flops
        self.bytes += nbytes
        self.launches[direction] += 1


class _WKV6Work(torch.autograd.Function):
    """The WKV6 kernels on meta ``[B, H, T, D]``: empty outputs of their
    shapes, their work added to a ``WKV6Tally``."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0, tally):
        ctx.tally, ctx.heads = tally, u.shape[0]
        tally.add(r, u.shape[0], "fwd")
        return torch.empty_like(r), torch.empty_like(s0)

    @staticmethod
    def backward(ctx, do, ds_t):
        do = do.contiguous()                # as the wrapper's backward
        ctx.tally.add(do, ctx.heads, "bwd")
        b, h, _, d = do.shape
        empty = [torch.empty_like(do) for _ in range(4)]
        return (*empty, do.new_empty((ctx.heads, d)),
                do.new_empty((b, h, d, d)), None)


def _card_wkv6(tally: WKV6Tally):
    """``dispatch.wkv6`` as the card runs it, on meta: the kernels' work,
    and the card's refusal of another head dim; ``backend`` is ignored."""

    def wkv6(r, k, v, w, u, s0, *, backend=None):
        if r.shape[-1] not in WKV6_HEAD_DIMS:
            raise ValueError(f"the WKV6 kernels take head dims "
                             f"{WKV6_HEAD_DIMS}, got {r.shape[-1]}")
        return _WKV6Work.apply(r, k, v, w, u, s0, tally)

    return wkv6


def _tree_bytes(tree) -> int:
    """A tree's bytes (on a mesh, rank 0's: a DTensor counts its local
    shard, a plain tensor its size, as replicated)."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, DTensor):
        tree = tree.to_local()
    if dataclasses.is_dataclass(tree):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(x) for x in tree)
    return _nbytes(tree) if isinstance(tree, torch.Tensor) else 0


def count_step(cfg, shape: ShapeConfig, *, num_clients: int = 1,
               local_steps: int = 1, algorithm: str = "fedpbc") -> dict:
    """Run one step of ``shape.mode`` on meta; returns ``{"flops", "bytes",
    "ops", "input_bytes", "flash_launches", "wkv6_launches"}``:
    FlopCounterMode's flops and the aten ops' bytes, each with the flash
    and WKV6 kernels' work added."""
    with torch.no_grad():
        if shape.mode == "train":
            args = steps.train_input_specs(
                cfg, shape, num_clients=num_clients,
                local_steps=local_steps, algorithm=algorithm)
            step = steps.make_train_step(
                cfg, num_clients=num_clients, local_steps=local_steps,
                algorithm=algorithm)
        elif shape.mode == "prefill":
            args = steps.prefill_input_specs(cfg, shape)
            step = steps.make_prefill_step(cfg)
        else:
            args = steps.serve_input_specs(cfg, shape)
            step = steps.make_serve_step(cfg)
    counter, flash, wkv = ByteCounter(), FlashTally(), WKV6Tally()
    with FlopCounterMode(display=False) as flops, counter, \
            mock.patch.object(kdispatch, "attention",
                              _card_attention(flash)), \
            mock.patch.object(kdispatch, "wkv6", _card_wkv6(wkv)):
        step(*args)
    return {"flops": float(flops.get_total_flops() + flash.flops
                           + wkv.flops),
            "bytes": float(counter.bytes + flash.bytes + wkv.bytes),
            "ops": counter.ops, "input_bytes": _tree_bytes(args),
            "flash_launches": dict(flash.launches),
            "wkv6_launches": dict(wkv.launches)}


def param_bytes(cfg) -> int:
    return _tree_bytes(steps.empty_params(cfg))


# ---------------------------------------------------------------------------
# Production meshes: rank 0's DTensor program
# ---------------------------------------------------------------------------

# functional collectives by the reference's kind names (output bytes a rank)
_COLLECTIVES = (("all_gather", "all-gather"), ("reduce_scatter",
                                               "reduce-scatter"),
                ("all_reduce", "all-reduce"), ("all_to_all", "all-to-all"),
                ("alltoall", "all-to-all"), ("broadcast",
                                             "collective-permute"))
_COMM_NS = ("_c10d_functional", "c10d_functional", "_dtensor")


def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


class LocalCounter(TorchDispatchMode):
    """Rank 0's local ops under DTensor (the module docstring): the mode
    yields a DTensor op to DTensor (``NotImplemented``) and counts the
    local ops DTensor then runs, not the propagator's fake ones. Flops by
    ``flop_registry``, bytes as ``ByteCounter``, collectives by kind."""

    def __init__(self, axis_of_group=None):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.coll_bytes: dict = {}
        self.coll_count: dict = {}
        self.axis_bytes: dict = {}        # collective bytes by mesh axis
        self.op_bytes: dict = {}          # ... by the DTensor op behind it
        self.axis_of_group = axis_of_group or {}
        self.op_of = lambda: None
        self.quiet = 0

    def snapshot(self):
        return (self.flops, self.bytes, self.ops, dict(self.coll_bytes),
                dict(self.coll_count), dict(self.axis_bytes),
                dict(self.op_bytes))

    def restore(self, state):
        self.flops, self.bytes, self.ops = state[:3]
        (self.coll_bytes, self.coll_count, self.axis_bytes,
         self.op_bytes) = (dict(x) for x in state[3:])

    def collective(self, kind: str, out: torch.Tensor, axis=None):
        n = _nbytes(out)
        self.coll_bytes[kind] = self.coll_bytes.get(kind, 0) + n
        self.coll_count[kind] = self.coll_count.get(kind, 0) + 1
        axis = axis or "?"
        self.axis_bytes[axis] = self.axis_bytes.get(axis, 0) + n
        op = self.op_of() or "redistribute"
        self.op_bytes[op] = self.op_bytes.get(op, 0) + n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.quiet or any(issubclass(t, FakeTensor) for t in types):
            return out
        name = func.name()
        if name.split("::")[0] in _COMM_NS:
            kind = next((k for key, k in _COLLECTIVES if key in name), None)
            if kind is not None and isinstance(out, torch.Tensor):
                group = next((a for a in reversed(args)
                              if isinstance(a, str)), None)
                self.collective(kind, out, self.axis_of_group.get(group))
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs,
                                                out_val=out)
        if not func.is_view and func not in _NO_BYTES:
            self.ops += 1
            self.bytes += sum(_nbytes(t) for t in tree_leaves(
                (args, kwargs, out)) if isinstance(t, torch.Tensor))
        return out


def _counted_alltoall(counter: LocalCounter):
    """DTensor's ``shard_dim_alltoall``, counted as one all-to-all of its
    output whatever collectives it makes (on a CPU mesh: all-gather plus
    chunk)."""
    from torch.distributed.tensor import placement_types

    orig = placement_types.shard_dim_alltoall

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        counter.quiet += 1
        try:
            out = orig(input, gather_dim, shard_dim, mesh, mesh_dim)
        finally:
            counter.quiet -= 1
        counter.collective("all-to-all", out, mesh.mesh_dim_names[mesh_dim])
        return out

    return mock.patch.object(placement_types, "shard_dim_alltoall",
                             alltoall)


@contextmanager
def _quiet():
    """DTensor's notes on the simulated group (the CPU mesh's all-to-all
    fallback, sequential gathers, scalars made replicated) silenced; they
    say nothing of the count."""
    log = logging.getLogger("torch.distributed.tensor")
    level = log.level
    log.setLevel(logging.ERROR)
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=".*implicitly creating"
                                    " a replicated DTensor")
            yield
    finally:
        log.setLevel(level)


def _act_spec(mode_flag, mesh, train=True) -> Optional[P]:
    """The residual's activation spec: ``"seq"`` (sequence parallel, T over
    ``"model"``), ``"dmodel"`` (D over ``"model"``) or None (batch only);
    the batch over ``"data"`` in training, over the data-parallel axes
    otherwise."""
    dp = ("data",) if train else dp_axes(mesh)
    if mode_flag == "seq":
        return P(dp if not train else "data", "model", None)
    if mode_flag == "dmodel":
        return P(dp if not train else "data", None, "model")
    return None


def count_step_meshed(cfg, shape: ShapeConfig, multi_pod: bool = False, *,
                      mesh=None, local_steps: int = 1,
                      algorithm: str = "fedpbc", seq_parallel=True,
                      tp2d: bool = False) -> dict:
    """Rank 0's count of one step of ``shape.mode`` on the production mesh
    (the module docstring), or on ``mesh`` (a ``launch.mesh.Mesh`` over
    ``("data", "model")`` or ``("pod", "data", "model")``, such as the
    host mesh). ``seq_parallel``: True/``"seq"``, False/None (batch only)
    or ``"dmodel"``; ``tp2d``: decode's 2-D tensor-parallel weights."""
    from torch.distributed.tensor.experimental import implicit_replication

    if seq_parallel is True:
        seq_parallel = "seq"
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    with spmd.simulated_mesh(mesh) as dmesh:
        with torch.no_grad():
            if shape.mode == "train":
                args = steps.placed_train_inputs(
                    cfg, shape, mesh, dmesh, local_steps=local_steps,
                    algorithm=algorithm)
                step = steps.make_fed_setup(cfg, mesh,
                                            local_steps=local_steps,
                                            algorithm=algorithm)[-1]
                act = _act_spec(seq_parallel, mesh) if seq_parallel else None
                pbytes = _tree_bytes(args[0].server)
                extra = {"num_clients": args[0].last_active.shape[1],
                         "client_placements": repr(tuple(
                             args[0].clients[0].placements))}
            elif shape.mode == "prefill":
                args = steps.placed_prefill_inputs(cfg, shape, mesh, dmesh)
                step = steps.make_prefill_step(cfg)
                act = _act_spec(seq_parallel, mesh, train=False) \
                    if seq_parallel else None
                pbytes = _tree_bytes(args[0])
                extra = {}
            else:
                args = steps.placed_serve_inputs(cfg, shape, mesh, dmesh,
                                                 tp2d=tp2d)
                step = steps.make_serve_step(cfg)
                act = None
                pbytes = _tree_bytes(args[0])
                extra = {}
        counter = LocalCounter({
            dmesh.get_group(a).group_name: a for a in mesh.axis_names})
        flash, wkv = FlashTally(), WKV6Tally()
        fallback = spmd.LayoutFixups(counter.snapshot, counter.restore)
        counter.op_of = lambda: fallback.op
        with activation_sharding(act), implicit_replication(), _quiet(), \
                counter, fallback, _counted_alltoall(counter), \
                mock.patch.object(kdispatch, "attention", spmd.local_attention(
                    _card_attention(flash))), \
                mock.patch.object(kdispatch, "wkv6",
                                  spmd.local_wkv6(_card_wkv6(wkv))):
            step(*args)
    return {"flops": float(counter.flops + flash.flops + wkv.flops),
            "bytes": float(counter.bytes + flash.bytes + wkv.bytes),
            "ops": counter.ops, "input_bytes": _tree_bytes(args),
            "param_bytes": pbytes,
            "coll_bytes": dict(counter.coll_bytes),
            "coll_count": dict(counter.coll_count),
            "coll_bytes_by_axis": dict(counter.axis_bytes),
            "coll_bytes_by_op": dict(sorted(
                counter.op_bytes.items(), key=lambda kv: -kv[1])[:8]),
            "replicated_ops": dict(fallback.retries),
            "act_spec": None if act is None else repr(act),
            "flash_launches": dict(flash.launches),
            "flash_shapes": list(flash.shapes),
            "wkv6_launches": dict(wkv.launches), **extra}


def run_rank0(cfg, shape: ShapeConfig, *, measure, device=None) -> dict:
    """Rank 0's DTensor program of the 16x16 prefill row, run on the card:
    the port's counterpart of the reference's compile proof
    (``lowered.compile()``). The inputs are placed as
    ``count_step_meshed`` places them (the ``"seq"`` activation spec), rank
    0's shards drawn from seed 0 on ``device`` (the card by default), under
    the simulated group, and ``forward`` runs with the kernels: attention
    through ``dispatch.attention`` on rank 0's local tensors
    (``spmd.local_attention``), so the flash kernel launches at the local
    shapes the count predicts. Values past a collective are not rank 0's
    real ones: the fake group's collectives deliver no other rank's data.

    The step runs twice: a warm call, then ``measure(fn)``, which calls
    ``fn`` once and returns what it measured (a profiler window or CUDA
    events on the card). Returns ``{"flash_shapes", "launches",
    "out_shape", "out_local_shape", "input_bytes", "measured",
    "attention"}`` of the measured call (``input_bytes``: rank 0's placed
    inputs), and on the card ``"peak_bytes"`` (the most allocated above
    what was allocated before it, the inputs included). ``attention``: the
    first call at a flash shape, ``{"shape", "dtype", "kw"}`` (rank 0's
    local ``q`` as ``dispatch.attention`` took it, k and v alike after
    GQA's repeat, and its keywords), the call to hold the kernel against
    the plain version at; its tensors are not kept, since they passed the
    simulated group's all-gather, whose output no rank fills. On the CPU
    (``device="cpu"``, small shapes) the attention is the plain version;
    the shapes recorded are those the card would launch."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.device import resolve_device
    from repro_torch.models.model import forward

    if shape.mode != "prefill":
        raise ValueError(f"run_rank0 runs prefill rows, not {shape.mode}")
    dev = resolve_device(device)
    mesh = make_production_mesh()
    gen = torch.Generator(device=dev).manual_seed(0)

    def fill(local, dtype):
        if dtype.is_floating_point:
            return (torch.randn(local, generator=gen, device=dev)
                    * 0.02).to(dtype)
        return torch.randint(0, cfg.vocab_size, local, generator=gen,
                             device=dev, dtype=dtype)

    attention = kdispatch.attention
    launched, first = [], {}

    def recorded(q, k, v, *, kind="full", window=4096, **kw):
        if kdispatch.flash_shape_ok(kind, q.shape[1], k.shape[1],
                                   kw.get("q_offset", 0)):
            launched.append((q.shape[0] * q.shape[2], q.shape[1],
                             padded_head_dim(q.shape[3]),
                             window if kind == "swa" else 0))
            if not first:
                first.update(shape=list(q.shape), dtype=q.dtype,
                             kw=dict(kw, kind=kind, window=window))
        return attention(q, k, v, kind=kind, window=window, **kw)

    out = {}
    with spmd.simulated_mesh(mesh, device_type=dev.type) as dmesh:
        params, tokens, memory = steps.placed_prefill_inputs(
            cfg, shape, mesh, dmesh, fill=fill)
        res = {}

        def step():
            res["y"] = forward(params, cfg, tokens, memory=memory)[0][:, -1]

        with torch.no_grad(), \
                activation_sharding(_act_spec("seq", mesh, train=False)), \
                implicit_replication(), _quiet(), spmd.LayoutFixups(), \
                mock.patch.object(kdispatch, "attention",
                                  spmd.local_attention(recorded)):
            step()                                   # warm
            launched.clear()
            card = dev.type == "cuda"
            if card:
                torch.cuda.synchronize(dev)
                torch.cuda.reset_peak_memory_stats(dev)
                base = torch.cuda.memory_allocated(dev)
            out["measured"] = measure(step)
            if card:
                torch.cuda.synchronize(dev)
                out["peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                     - base)
        y = res["y"]
        out.update(flash_shapes=sorted(set(launched)),
                   launches=len(launched), out_shape=list(y.shape),
                   out_local_shape=list(y.to_local().shape),
                   input_bytes=_tree_bytes((params, tokens, memory)),
                   attention=first)
    return out


def lower_pair(arch: str, shape_name: str, *, multi_pod=None,
               verbose: bool = True, algorithm: str = "fedpbc",
               dispatch: Optional[str] = None, seq_parallel=True,
               analyze: bool = True, tp2d: bool = False, cfg=None) -> dict:
    """One row: the arch (or ``cfg``) × shape counted on meta and put on
    the roofline, or a ``skip`` / ``FAIL`` row. ``multi_pod``: None counts
    one card; False the ``16x16`` mesh, True the ``2x16x16`` one (rank 0's
    count, the module docstring). ``dispatch`` overrides the MoE
    dispatch; ``seq_parallel``, ``tp2d`` as ``count_step_meshed`` (the
    mesh only); ``analyze`` is the reference's depth extrapolation, which
    the eager count has no need of: the row is the same either way."""
    cfg = cfg or get_config(arch)
    if dispatch and cfg.moe:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, dispatch=dispatch))
    shape = INPUT_SHAPES[shape_name]
    mesh = MESH if multi_pod is None else _mesh_name(multi_pod)
    row = {"arch": arch, "shape": shape_name, "mesh": mesh}
    if shape.name not in [s.name for s in applicable_shapes(cfg)]:
        return {**row, "status": "skip",
                "reason": "full-attention arch at 500k / enc-dec long decode"}
    t0 = time.time()
    try:
        if multi_pod is None:
            c = count_step(cfg, shape, algorithm=algorithm)
        else:
            c = count_step_meshed(cfg, shape, multi_pod, algorithm=algorithm,
                                  seq_parallel=seq_parallel, tp2d=tp2d)
    except Exception as e:     # the row records any step that cannot run
        return {**row, "status": "FAIL", "mode": shape.mode,
                "error": f"{type(e).__name__}: {e}",
                "trace": traceback.format_exc()[-2500:]}
    coll = c.get("coll_bytes", {})
    rf = Roofline(flops=c["flops"], hbm_bytes=c["bytes"],
                  coll_bytes=float(sum(coll.values())),
                  chips=1 if multi_pod is None else 512 if multi_pod else 256,
                  model_flops=model_flops_for(cfg, shape, mode=shape.mode))
    pbytes = c.get("param_bytes", None) or param_bytes(cfg)
    result = {
        **row, "status": "ok", "mode": shape.mode,
        "count_s": round(time.time() - t0, 2), "aten_ops": c["ops"],
        "param_bytes": pbytes, "argument_bytes": c["input_bytes"],
        "fits_one_card": c["input_bytes"] <= CARD_BYTES,
        "temp_bytes_per_device": None,
        "collectives": {k: [c["coll_count"][k], coll[k]] for k in coll},
        "flash_launches": c["flash_launches"],
        "wkv6_launches": c["wkv6_launches"],
        "counted_through": COUNTED_THROUGH, **rf.row(),
    }
    if multi_pod is not None:
        result.update(per_device="rank 0's local count",
                      act_spec=c["act_spec"], tp2d=tp2d,
                      collective_bytes_by_axis=c["coll_bytes_by_axis"],
                      collective_bytes_by_op=c["coll_bytes_by_op"],
                      replicated_ops=c["replicated_ops"],
                      flash_shapes=sorted(c["flash_shapes"]),
                      **{k: c[k] for k in ("num_clients",
                                           "client_placements") if k in c})
    if cfg.moe:
        result["moe_dispatch"] = cfg.moe.dispatch
    if not analyze:
        result["analyze"] = ("off: accepted; the eager count sees every "
                             "period, so there is no depth extrapolation "
                             "to skip and the row is the same")
    if verbose:
        print(f"== {arch} x {shape_name} mesh={mesh} ==")
        print(f"params {pbytes / 1e9:.3f} GB, step inputs "
              f"{c['input_bytes'] / 1e9:.3f} GB a device (fit one 80 GB "
              f"card: {result['fits_one_card']}); {c['ops']} aten ops")
        print("counted: flops=%.3e bytes=%.3e" % (rf.flops, rf.hbm_bytes))
        print("collectives:", result["collectives"])
        print("roofline: compute=%.4fs memory=%.4fs collective=%.4fs -> %s"
              % (rf.t_compute, rf.t_memory, rf.t_collective, rf.bottleneck))
        print("useful fraction (model/counted flops): %.3f"
              % rf.useful_fraction)
    return result


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--algorithm", default="fedpbc")
    ap.add_argument("--dispatch", default=None, help="override MoE dispatch")
    ap.add_argument("--no-seq-parallel", action="store_true")
    ap.add_argument("--act-spec", default=None, choices=["seq", "dmodel"])
    ap.add_argument("--tp2d", action="store_true",
                    help="decode: 2D tensor-parallel weights")
    ap.add_argument("--no-analyze", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = (list(INPUT_SHAPES) if (args.all or not args.shape)
              else [args.shape])
    # as the reference: 16x16, --multi-pod 2x16x16, --both-meshes both
    # (the one-card count is lower_pair's multi_pod=None)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    results = []
    for mp in meshes:
        for a in archs:
            for s in shapes:
                sp = args.act_spec or (not args.no_seq_parallel)
                r = lower_pair(a, s, multi_pod=mp, algorithm=args.algorithm,
                               dispatch=args.dispatch, seq_parallel=sp,
                               analyze=not args.no_analyze, tp2d=args.tp2d)
                print(json.dumps({k: v for k, v in r.items()
                                  if k != "trace"}), flush=True)
                if r["status"] == "FAIL":
                    print(r.get("trace", ""), flush=True)
                results.append(r)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skip" for r in results)
    n_fail = sum(r["status"] == "FAIL" for r in results)
    print(f"DONE ok={n_ok} skip={n_skip} fail={n_fail}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())

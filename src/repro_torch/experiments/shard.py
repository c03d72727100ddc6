"""Multi-device execution of the batched sweep runner (port of
``repro.experiments.shard``).

``make_batched_run_rounds`` runs all B = algos x points x seeds trajectories
of one (family, scheme) cell over a leading batch axis. Trajectories never
exchange data, so that axis splits over devices. The reference does it with
GSPMD from one controller; the port runs one worker process per mesh device
(``repro_torch.sharding.pool``), since its eager round is host-bound and one
Python thread feeding N cards would add host time N times:

- a ``("batch",)`` mesh (``repro_torch.launch.mesh.make_batch_mesh``), or a
  ``("batch", "model")`` one (``make_2d_mesh``) whose model ranks also
  split each trajectory's clients, or with ``activation_spec=P(None,
  "model", None)`` each LM sequence (``run_sharded_2d``);
- B padded up to a multiple of the batch axis by repeating the last
  trajectory (``pad_batch``): a padding row is a full, finite simulation
  that draws exactly what its twin draws, and it is dropped on the host
  before anything reaches a ``CellResult`` or a ``ResultsStore`` row;
- batch rank ``r`` runs rows ``[r * B / n, (r + 1) * B / n)``
  (``shard_batch``) with the generator bundles of its own rows: each
  worker rebuilds them as ``seed_generators(tag)`` from the batch's
  ``gen_tags`` (its seeds), so every trajectory draws the numbers it draws
  on one device; an injected ``draws=`` is sliced with its own ``take``;
- each rank returns its ``(states, out)`` on the host, and the caller joins
  the slices in row order.

The port's runner is a closure over the task and its factories and cannot
be pickled, so a worker rebuilds it, and the batch, from what
``grid.make_runner`` and ``make_cell_batch`` key on: the runner's
``recipe`` (the spec, the cell's ``FederationConfig``, the metric keys and
the mesh it was built for) and the batch's rows (its tensors on the host
and its seeds). Only these cross the process boundary. A worker keeps the
runners it built (one per structure, as the reference's runner cache) and
the slices committed to it (``commit``, ``run_committed``: the executor's
batch cache), so a sweep sends its heavy arrays once.
"""
from __future__ import annotations

import dataclasses
import hashlib
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Union

import torch

from repro_torch.experiments.sweep import CellBatch, map_carry, seed_generators
from repro_torch.launch.mesh import Mesh, make_batch_mesh
from repro_torch.sharding import pool as pool_mod
from repro_torch.sharding.specs import P

# run_cell_batch's default: shard automatically when >1 card is visible.
AUTO = "auto"
# run_sharded_2d's one activation spec: the LM residual [b, T, d] with T
# over "model" (Megatron-style sequence parallelism)
SEQUENCE_SPEC = P(None, "model", None)


def sequence_split(spec, activation_spec, model: int) -> bool:
    """Whether a call of ``run_sharded_2d`` with ``activation_spec``, for a
    runner of ``spec`` (a ``grid.SweepSpec``) on a model axis of ``model``
    ranks, splits each sequence over the axis: ``SEQUENCE_SPEC`` on the LM
    task when the sequence length divides over the axis. Otherwise (no
    spec, a task without a sequence, a length that does not divide) the
    call runs as with ``None``, as ``specs.maybe_constrain`` leaves a dim
    it cannot split replicated. Raises ``ValueError`` for any other spec
    (the residual's ``d`` over ``"model"``, or a spec over ``"batch"``),
    as the reference's ``run_sharded_2d`` does: its trajectory and client
    vmaps already name both mesh axes as their ``spmd_axis_name``, so its
    ``with_sharding_constraint`` refuses a spec that names either. The
    sequence split itself goes beyond the reference, which refuses
    ``SEQUENCE_SPEC`` the same way. The LM's forward raises for an arch of
    the vlm or audio family."""
    if activation_spec is None:
        return False
    if tuple(activation_spec) != tuple(SEQUENCE_SPEC):
        raise ValueError(
            f"run_sharded_2d takes activation_spec=None or "
            f"{SEQUENCE_SPEC!r} (each sequence over 'model'); got "
            f"{activation_spec!r}, which the reference refuses too: its "
            f"trajectory and client vmaps already use both mesh axes, so "
            f"no other spec can place an activation")
    return spec.task == "lm" and model > 1 and spec.lm_seq % model == 0


def resolve_batch_mesh(mesh: Union[str, Mesh, None] = AUTO,
                       devices: Optional[Sequence] = None) -> Optional[Mesh]:
    """The mesh a sweep call should execute on, or None for the plain
    single-device path.

    - ``mesh`` a :class:`Mesh`: used as given (must carry a ``"batch"`` axis).
    - ``mesh=None``: force the single-device path regardless of ``devices``.
    - ``mesh="auto"`` (default): a ``("batch",)`` mesh over ``devices`` when
      given (even a single device: an explicit list opts in to the sharded
      wrapper), else over every visible CUDA device when more than one is.
    """
    if mesh is None:
        return None
    if isinstance(mesh, Mesh):
        if "batch" not in mesh.axis_names:
            raise ValueError(
                f"sweep mesh needs a 'batch' axis; got {mesh.axis_names}")
        return mesh
    if mesh != AUTO:
        raise ValueError(f"mesh must be a Mesh, None, or 'auto'; got {mesh!r}")
    if devices is not None:
        return make_batch_mesh(devices)
    return make_batch_mesh() if torch.cuda.device_count() > 1 else None


def _rows(batch: CellBatch, lo: int, hi: int) -> CellBatch:
    """Rows ``[lo, hi)`` with the generator bundles they use."""
    idx = batch.gen_index[lo:hi]
    used = list(dict.fromkeys(idx))
    remap = {b: i for i, b in enumerate(used)}

    def cut(x):
        return x[lo:hi]

    return CellBatch(
        gens=[batch.gens[b] for b in used],
        gen_index=[remap[b] for b in idx],
        gen_tags=(None if batch.gen_tags is None
                  else [batch.gen_tags[b] for b in used]),
        p_base=cut(batch.p_base), hparams=map_carry(cut, batch.hparams),
        data=map_carry(cut, batch.data), shared=batch.shared,
        algo_id=None if batch.algo_id is None else cut(batch.algo_id))


def pad_batch(batch: CellBatch, multiple: int) -> tuple:
    """Pad the leading ``[B]`` axis of the batched fields (``p_base``,
    ``hparams``, ``data``, ``algo_id``, ``gen_index``) up to a multiple of
    ``multiple`` by repeating the last trajectory; ``shared`` and the
    bundles are untouched. Returns ``(padded, B)`` with B the real batch
    size, so the caller can slice the padding back off the results."""
    B = batch.batch_size
    pad = (-B) % multiple
    if pad == 0:
        return batch, B

    def _pad(x):
        return torch.cat([x, x[-1:].expand((pad,) + tuple(x.shape[1:]))])

    return dataclasses.replace(
        batch, p_base=_pad(batch.p_base),
        hparams=map_carry(_pad, batch.hparams),
        data=map_carry(_pad, batch.data),
        algo_id=None if batch.algo_id is None else _pad(batch.algo_id),
        gen_index=list(batch.gen_index) + [batch.gen_index[-1]] * pad), B


def shard_batch(batch: CellBatch, mesh: Mesh) -> List[CellBatch]:
    """The batch's slice for each index of the mesh's ``"batch"`` axis: rows
    ``[r * B / n, (r + 1) * B / n)`` for index ``r`` (each with the bundles
    of its own rows), still on the batch's device. On a 2-D mesh the model
    ranks of one batch index share its slice. The batch size must already
    be a multiple of the axis (see ``pad_batch``)."""
    n = mesh.shape["batch"]
    if batch.batch_size % n:
        raise ValueError(
            f"batch size {batch.batch_size} not divisible by the mesh's "
            f"batch axis ({n}); pad_batch first")
    w = batch.batch_size // n
    return [_rows(batch, r * w, (r + 1) * w) for r in range(n)]


# -- what crosses to the workers --------------------------------------------


@dataclass(frozen=True)
class RunnerRecipe:
    """What a worker rebuilds a ``grid.make_runner`` runner from."""

    spec: Any                   # grid.SweepSpec
    fed: Any                    # the cell's FederationConfig
    metric_keys: tuple
    shard_mesh: Optional[Mesh] = None


def _host(x):
    return x.cpu() if isinstance(x, torch.Tensor) else x


def _wire(batch: CellBatch) -> Dict[str, Any]:
    """A slice's rows as they cross: tensors on the host, bundles by seed."""
    tags = batch.gen_tags
    if tags is None or not all(isinstance(t, int) for t in tags):
        raise ValueError(
            "a sharded run rebuilds each rank's generator bundles as "
            "seed_generators(tag) from the batch's gen_tags (its seeds, as "
            f"make_cell_batch sets them); this batch has gen_tags={tags}")
    return {"p_base": batch.p_base.cpu(),
            "hparams": map_carry(_host, batch.hparams),
            "data": map_carry(_host, batch.data),
            "algo_id": None if batch.algo_id is None else batch.algo_id.cpu(),
            "gen_index": list(batch.gen_index), "gen_tags": list(tags)}


def _unwire(wire: Dict[str, Any], shared, dev) -> CellBatch:
    def to(x):
        return x.to(dev) if isinstance(x, torch.Tensor) else x

    return CellBatch(
        gens=[seed_generators(t, dev) for t in wire["gen_tags"]],
        gen_index=wire["gen_index"], gen_tags=wire["gen_tags"],
        p_base=wire["p_base"].to(dev), hparams=map_carry(to, wire["hparams"]),
        data=map_carry(to, wire["data"]), shared=shared,
        algo_id=to(wire["algo_id"]))


# -- the worker side ----------------------------------------------------------

# a worker's runners by structure, how many it built, and the slices
# committed to it (of one base at a time: the parent's cache keeps one)
_WORKER: Dict[str, Any] = {"runners": {}, "built": 0, "base": None,
                           "committed": {}}


def _worker_runner(recipe: RunnerRecipe, task, dev):
    from repro_torch.experiments import grid

    key = grid.runner_key(recipe.spec, recipe.fed, recipe.metric_keys, dev,
                          recipe.shard_mesh)
    if key not in _WORKER["runners"]:
        _WORKER["runners"][key] = grid.make_runner(
            recipe.spec, recipe.fed, task, metric_keys=recipe.metric_keys,
            device=dev, shard_mesh=recipe.shard_mesh)
        _WORKER["built"] += 1
    return _WORKER["runners"][key]


def _worker_batch(token, wire, period, shared, dev) -> CellBatch:
    if token is None:
        batch = _unwire(wire, shared, dev)
    else:
        base, key = token
        if _WORKER["base"] != base:
            _WORKER["committed"].clear()
            _WORKER["base"] = base
        if wire is not None:
            _WORKER["committed"][key] = _unwire(wire, shared, dev)
        if key not in _WORKER["committed"]:
            raise RuntimeError(f"no batch {key} is committed to this worker")
        batch = _WORKER["committed"][key]
    if period is not None:
        batch = dataclasses.replace(batch, hparams=dict(
            batch.hparams, period=torch.full(
                (batch.batch_size,), float(period), dtype=torch.float32,
                device=dev)))
    return batch


def _launch_counters():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import masked_agg

    return {"fused_masked_agg": masked_agg.fused_masked_agg,
            "flash_attention_fwd": fa.flash_attention_fwd,
            "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
            "flash_attention_bwd_dkdv": fa.flash_attention_bwd_dkdv,
            "flash_attention_wide_fwd": fa.flash_attention_wide_fwd,
            "flash_attention_wide_bwd_dq": fa.flash_attention_wide_bwd_dq,
            "flash_attention_wide_bwd_dkdv": fa.flash_attention_wide_bwd_dkdv}


def _wkv6_launches(rk) -> Dict[str, int]:
    """The WKV6 wrapper's counts: forward calls, backward calls, and those
    of each that took the zero-padded route and the block route."""
    return {"wkv6_fwd": rk.rwkv6_chunk.launches,
            "wkv6_bwd": rk.rwkv6_chunk.launches_by_route["backward"],
            "wkv6_fwd_padded": rk.rwkv6_chunk.padded_launches["forward"],
            "wkv6_bwd_padded": rk.rwkv6_chunk.padded_launches["backward"],
            "wkv6_fwd_blocked": rk.rwkv6_chunk.blocked_launches["forward"],
            "wkv6_bwd_blocked": rk.rwkv6_chunk.blocked_launches["backward"]}


def _digest(tree) -> str:
    """A SHA-256 of every tensor's bytes in ``tree`` (in carry order)."""
    h = hashlib.sha256()

    def add(x):
        if isinstance(x, torch.Tensor):
            h.update(x.detach().reshape(-1).contiguous().view(torch.uint8)
                     .cpu().numpy().tobytes())
        return x

    map_carry(add, tree)
    return h.hexdigest()


def _rank_call(recipe: RunnerRecipe, token, wire, period, draws,
               activation_spec=None):
    """One rank's share of a sharded call (runs in a pool worker): its
    batch slice through the rebuilt runner, its model axis splitting the
    clients or, under ``activation_spec`` (``sequence_split``), each
    sequence. Model rank 0 of each batch index returns the slice's
    ``(states, out)`` on the host; every rank returns whether it split
    sequences, its kernel launches (the flash kernels' also at an offset,
    the WKV6 wrapper's by direction and through its zero-padded route),
    its plain attention and WKV6 calls, its collectives, its peak device
    memory, a digest of its server and outputs and how many runners its
    worker has built."""
    from repro_torch.experiments import grid
    from repro_torch.kernels import dispatch
    from repro_torch.kernels import rwkv6_chunk as rk

    ctx = pool_mod.worker_context()
    dev = ctx.device
    task = grid.get_traced_task(recipe.spec, dev)
    runner = _worker_runner(recipe, task, dev)
    batch = _worker_batch(token, wire, period, task.shared, dev)
    split = sequence_split(recipe.spec, activation_spec,
                           ctx.mesh.shape.get("model", 1))
    counters = _launch_counters()
    for c in counters.values():
        c.launches = 0
        c.offset_launches = 0
    rk.reset_counts()
    dispatch.plain_attention_calls = dispatch.plain_wkv6_calls = 0
    ctx.split = "sequence" if split else "clients"
    axis = ctx.axis()
    if axis is not None:
        axis.reset()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    try:
        states, out = runner(batch, draws=draws)
    finally:
        ctx.split = "clients"
    peak = None
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
    value = None
    if axis is None or axis.index == 0:
        value = (map_carry(_host, states), map_carry(_host, out))
    gathers = None
    if axis is not None:
        st = axis.stats()
        gathers = {"bytes_by_kind": st.bytes_by_kind,
                   "count_by_kind": st.count_by_kind,
                   "seconds": axis.seconds}
    return {"value": value, "rows": batch.batch_size, "seq_split": split,
            "launches": {**{k: c.launches for k, c in counters.items()},
                         **_wkv6_launches(rk)},
            "offset_launches": {k: getattr(c, "offset_launches", 0)
                                for k, c in counters.items()},
            "plain_attention": dispatch.plain_attention_calls,
            "plain_wkv6": dispatch.plain_wkv6_calls,
            "gathers": gathers, "peak_bytes": peak,
            "digest": _digest((getattr(states, "server", states), out)),
            "runners_built": _WORKER["built"]}


# -- the caller side ------------------------------------------------------------

_LAST: List[pool_mod.PoolResult] = []


def last_run() -> pool_mod.PoolResult:
    """The pool's result of the latest sharded call in this process: each
    rank's value (``seq_split``: whether it split sequences; ``launches``
    (the WKV6 wrapper's as ``wkv6_fwd``, ``wkv6_bwd`` and their
    ``_padded`` parts) and the flash kernels' ``offset_launches``;
    ``plain_attention`` and ``plain_wkv6``, its calls of the plain
    versions; ``gathers``, its collectives' bytes and
    counts by kind and their wall seconds; ``peak_bytes``, its peak device
    memory, None on the CPU; ``digest``, a SHA-256 of its server and
    outputs; ``rows``, ``runners_built``), device and wall seconds, and the
    backend."""
    if not _LAST:
        raise RuntimeError("no sharded call has run in this process")
    return _LAST[-1]


def _recipe_of(runner) -> RunnerRecipe:
    recipe = getattr(runner, "recipe", None)
    if recipe is None:
        raise TypeError(
            "a sharded run rebuilds its runner in each worker from the "
            "runner's recipe: pass a runner made by "
            "repro_torch.experiments.grid.make_runner")
    if runner.carry_out:
        raise ValueError("a sharded run is one-shot: carry_out runners run "
                         "on one device")
    return recipe


def _execute(runner, mesh: Mesh, wires, b_real: int, size: int, device, *,
             token=None, period=None, draws=None, activation_spec=None):
    """Run the runner's recipe on every rank of ``mesh`` (``wires[r]``: the
    rows of batch index ``r``, or None where the worker holds them under
    ``token``); join the batch indices' results in row order, drop the
    padding rows and put the result on ``device``."""
    recipe = _recipe_of(runner)
    n = mesh.shape["batch"]
    k = mesh.size // n
    per = size // n
    args = []
    for r in range(mesh.size):
        b = r // k
        d = None
        if draws is not None:       # padding rows draw as their twin
            d = draws.take([min(i, b_real - 1)
                            for i in range(b * per, (b + 1) * per)])
        args.append((recipe, token, wires[b], period, d, activation_spec))
    result = pool_mod.pool_for(mesh).run(_rank_call, args)
    _LAST[:] = [result]
    parts = [v["value"] for v in result.values if v["value"] is not None]

    def join(*xs):
        return torch.cat(xs) if isinstance(xs[0], torch.Tensor) else xs[0]

    def place(x):
        return x[:b_real].to(device) if isinstance(x, torch.Tensor) else x

    states = map_carry(join, *[p[0] for p in parts])
    out = map_carry(join, *[p[1] for p in parts])
    return map_carry(place, states), map_carry(place, out)


def run_sharded(runner, batch: CellBatch, mesh: Mesh, *, draws=None):
    """Run one cell batch on ``mesh``: pad, shard, execute on the mesh's
    pool, and drop the padding rows from every output leaf on the host.
    Same ``(states, out)`` contract as ``runner(batch, draws=draws)``, on
    the batch's device.

    ``runner`` stands for the runner object the reference passes: it must
    come from ``grid.make_runner`` (its ``recipe`` is what the workers
    rebuild it from), and ``batch`` from ``grid.make_cell_batch`` (its rows
    and seeds cross; its ``shared`` is the task's). ``draws`` (optional, as
    the runner's) must pickle and have ``take``."""
    return _run(runner, batch, mesh, draws=draws)


def _run(runner, batch: CellBatch, mesh: Mesh, *, draws=None,
         activation_spec=None):
    padded, B = pad_batch(batch, mesh.shape["batch"])
    wires = [_wire(s) for s in shard_batch(padded, mesh)]
    return _execute(runner, mesh, wires, B, padded.batch_size,
                    batch.p_base.device, draws=draws,
                    activation_spec=activation_spec)


def run_sharded_2d(runner, batch: CellBatch, mesh: Mesh, *,
                   activation_spec=None, draws=None):
    """Run one cell batch on a 2-D ``("batch", "model")`` mesh
    (``repro_torch.launch.mesh.make_2d_mesh``): trajectories split over
    ``"batch"``, each trajectory's clients over ``"model"`` by the runner
    itself, which must have been built with ``shard_mesh=mesh``
    (``grid.make_runner``, ``make_batched_run_rounds``).

    ``activation_spec``: the reference's placement of the LM residual
    ``[b, T, d]``, sent to the workers with the call (so one runner serves
    both placements). ``SEQUENCE_SPEC``, ``P(None, "model", None)``, splits
    each sequence over ``"model"`` (Megatron-style sequence parallelism,
    ``pool.SequenceAxis``): every model rank holds all the clients of its
    trajectories and trains them on its ``T / model`` tokens of every
    sequence, all-gathering K and V in each attention block (the flash
    kernels' causal-offset route), taking the token shifts', causal
    convs' and recurrent states' carries from the earlier ranks (RWKV6's
    WKV6 and the hybrid's Mamba blocks) and routing each MoE row as one
    group across the ranks, and all-reducing each step's gradient and the
    losses, so every model rank ends with the same bits and the result
    equals the single-device run up to fp32 reassociation. Every family
    of the LM sweep takes it but the vlm and audio ones, which raise. On a
    task without a sequence, or where ``T`` does not divide over the
    axis, the call runs as with ``None`` (clients split); any other spec
    raises ``ValueError`` (``sequence_split``). The evals run whole on
    every rank, either way. Same pad / execute / host-side slice contract
    as ``run_sharded``.
    """
    missing = {"batch", "model"} - set(mesh.axis_names)
    if missing:
        raise ValueError(
            f"run_sharded_2d needs a ('batch', 'model') mesh; "
            f"{mesh.axis_names} lacks {sorted(missing)}")
    rmesh = getattr(runner, "shard_mesh", None)
    if rmesh is None or rmesh != mesh:
        raise ValueError(
            "runner was not built for this mesh — pass shard_mesh=mesh to "
            "make_batched_run_rounds (got runner.shard_mesh="
            f"{rmesh})")
    sequence_split(_recipe_of(runner).spec, activation_spec,
                   mesh.shape["model"])
    return _run(runner, batch, mesh, draws=draws,
                activation_spec=activation_spec)


@dataclass
class Committed:
    """A padded cell batch committed to a mesh's workers under ``token``
    (the executor's batch cache, ``grid._sharded_cell_batch``): ``wires``
    are its batch indices' rows, sent with the first call of each pool
    (``generation``), after which the workers hold them."""

    token: tuple
    wires: List[Dict[str, Any]]
    b_real: int
    size: int
    generation: Optional[int] = None


def commit(padded: CellBatch, mesh: Mesh, token: tuple,
           b_real: int) -> Committed:
    """``padded`` (a multiple of the batch axis, ``pad_batch``) as a
    ``Committed`` under ``token = (base, key)``: a worker keeps the slices
    of one base at a time."""
    return Committed(token, [_wire(s) for s in shard_batch(padded, mesh)],
                     b_real, padded.batch_size)


def run_committed(runner, committed: Committed, mesh: Mesh, *, period,
                  device, draws=None):
    """``run_sharded`` of a committed batch with its ``[B]`` period column
    set to ``period``: the rows cross only if this pool has not had them."""
    pool = pool_mod.pool_for(mesh)
    send = committed.generation != pool.generation
    wires = committed.wires if send else [None] * len(committed.wires)
    out = _execute(runner, mesh, wires, committed.b_real, committed.size,
                   device, token=committed.token, period=period, draws=draws)
    committed.generation = pool.generation
    return out


__all__ = ["AUTO", "SEQUENCE_SPEC", "resolve_batch_mesh", "pad_batch",
           "shard_batch", "run_sharded", "run_sharded_2d", "sequence_split",
           "RunnerRecipe", "Committed", "commit", "run_committed",
           "last_run"]

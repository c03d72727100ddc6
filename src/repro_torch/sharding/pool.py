"""The executor of a mesh: one worker process per mesh device under
``torch.distributed``.

The reference splits a sweep over devices with GSPMD from one controller.
The port has no such thing, and its eager round is host-bound, so one
Python thread feeding N cards would add host time N times. A ``Pool``
starts one process per rank of a ``repro_torch.launch.mesh.Mesh`` instead:

- processes from the ``spawn`` context, each with ``max(1, cpu_count //
  world)`` intra-op threads (or the caller's ``threads``), on
  ``mesh.devices[rank]``;
- rendezvous through a ``FileStore`` in a temporary directory (no TCP port,
  so concurrent test workers never collide), then
  ``init_device_mesh`` with the mesh's axis names: the ``"model"`` group of
  a rank is ``device_mesh.get_group("model")``;
- the backend, chosen from the mesh's devices in ``backend_for``: NCCL when
  every rank has a CUDA device of its own, gloo otherwise (CPU ranks, or
  ranks sharing a card, which NCCL refuses). Under gloo a CUDA tensor goes
  through host memory for a collective (``ModelAxis``, ``SequenceAxis``).

Over the ``"model"`` group a rank splits each trajectory's clients
(``ModelAxis``, the default) or each sequence of the LM (``SequenceAxis``,
the reference's ``activation_spec=P(None, "model", None)``); the caller
picks one per call (``WorkerContext.split``).

``Pool.run(fn, args)`` sends rank ``r`` the pickled ``(fn, args[r])``
(``fn`` by its import path), runs it there, and returns every rank's value
with its device and wall seconds (``PoolResult``). A worker's exception
fails the call with the worker's traceback, and a rendezvous that does not
finish within ``START_TIMEOUT_S`` seconds raises ``TimeoutError``; either way
the pool is closed, since the other ranks may wait in a collective. Inside
a worker, ``worker_context()`` gives the rank's place in the mesh.
``pool_for(mesh)`` keeps one pool per mesh, reused across calls and closed
at exit (``close_pools``).
"""
from __future__ import annotations

import atexit
import contextlib
import datetime
import itertools
import multiprocessing
import os
import pickle
import shutil
import tempfile
import time
import traceback
from dataclasses import dataclass
from multiprocessing.connection import wait
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.core.params import gmap
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.roofline import CollectiveStats

# spawn, import torch, init the device, rendezvous, build the device mesh
START_TIMEOUT_S = 300.0
# the process group's own limit on one collective (a rank that died)
COLLECTIVE_TIMEOUT_S = 600.0


def backend_for(mesh: Mesh) -> str:
    """``"nccl"`` when every rank has a CUDA device of its own, else
    ``"gloo"`` (CPU ranks, or several ranks on one card)."""
    devs = mesh.devices
    if all(d.type == "cuda" and d.index is not None for d in devs) \
            and len(set(devs)) == len(devs):
        return "nccl"
    return "gloo"


class ModelAxis:
    """A rank's share of each trajectory's clients on the mesh's
    ``"model"`` axis, and the all-gather that joins them again: the round's
    ``gather_updates`` hook (``repro_torch.core.federated.make_round_fn``).

    With ``size`` model ranks, rank ``index`` holds client columns
    ``[index * m / size, (index + 1) * m / size)`` of every ``[B, m, ...]``
    client tensor (``take``); ``gather`` all-gathers such columns along
    dim 1 over ``group`` in rank order. ``host_staged`` (gloo) copies a
    CUDA tensor to the host for the collective and back. Every gather is
    tallied: its output bytes, its count and its wall seconds (``stats``,
    ``seconds``; ``reset``)."""

    def __init__(self, index: int, size: int, group, host_staged: bool):
        self.index, self.size, self.group = index, size, group
        self.host_staged = host_staged
        self.reset()

    def reset(self) -> None:
        self.bytes = self.count = 0
        self.seconds = 0.0

    def stats(self) -> CollectiveStats:
        return CollectiveStats({"all-gather": self.bytes},
                               {"all-gather": self.count})

    def take(self, x: torch.Tensor) -> torch.Tensor:
        m = x.shape[1]
        if m % self.size:
            raise ValueError(f"{m} clients do not split over a model axis "
                             f"of {self.size}")
        w = m // self.size
        return x[:, self.index * w:(self.index + 1) * w]

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist

        t0 = time.perf_counter()
        src = x.contiguous()
        if self.host_staged:
            src = src.cpu()
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        out = torch.cat(parts, 1).to(x.device)
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
        self.seconds += time.perf_counter() - t0
        self.bytes += out.numel() * out.element_size()
        self.count += 1
        return out

    def __call__(self, updates):
        """``(x_star, losses)`` of this rank's clients -> of all m (one
        gather per parameter group, one for the losses)."""
        return tuple(gmap(self.gather, u) for u in updates)


class _GatherPrefix(torch.autograd.Function):
    """``SequenceAxis.gather_prefix``: all-gather along ``dim``, keep the
    prefix up to this rank's chunk; backward: the prefix's gradient
    zero-padded to the whole sequence, all-reduced (every rank's queries
    that saw this rank's keys), this rank's chunk of it."""

    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim, ctx.t = axis, dim, x.shape[dim]
        full = axis._all_gather(x, dim)
        return full.narrow(dim, 0, (axis.index + 1) * x.shape[dim])

    @staticmethod
    def backward(ctx, g):
        axis, dim, t = ctx.axis, ctx.dim, ctx.t
        shape = list(g.shape)
        shape[dim] = t * axis.size
        full = g.new_zeros(shape)
        full.narrow(dim, 0, g.shape[dim]).copy_(g)
        full = axis._all_reduce(full)
        return full.narrow(dim, axis.index * t, t), None, None


class _GatherAll(torch.autograd.Function):
    """``SequenceAxis.gather_all``: every rank's ``x`` stacked on a new
    leading axis in rank order; backward: the stacked gradient all-reduced
    (every rank's uses of every slot), this rank's slot of it."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return axis._all_gather(x.unsqueeze(0), 0)

    @staticmethod
    def backward(ctx, g):
        axis = ctx.axis
        return axis._all_reduce(g)[axis.index], None


class _AllSum(torch.autograd.Function):
    """``SequenceAxis.all_sum``: ``x`` summed over the ranks; backward: the
    gradient summed over the ranks too (every rank's loss uses the sum)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return axis._all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis._all_reduce(g), None


class SequenceAxis:
    """A rank's share of each sequence on the mesh's ``"model"`` axis
    (Megatron-style sequence parallelism, the reference's
    ``run_sharded_2d(..., activation_spec=P(None, "model", None))``) and
    the collectives that keep the local training exact.

    With ``size`` ranks of the ``"model"`` group, rank ``index`` holds
    tokens ``[index * T / size, (index + 1) * T / size)`` of every sequence
    (``take_seq`` of ``tokens`` and ``labels``) and every client of its
    trajectories. Inside the forward (``active()``, read by
    ``repro_torch.models.model`` through ``specs.sequence_axis``) each
    attention block all-gathers K and V and keeps their prefix up to its
    chunk (``gather_prefix``: an autograd op whose backward all-reduces the
    prefix's gradient and keeps the chunk); the recurrent and routed
    layers take what the earlier ranks carry into the chunk: a token
    shift's or a causal conv's last rows (``prev_rows``), a linear
    recurrence's entering state (``carry_in``), an MoE row's expert counts
    before the chunk (``gather_all`` without a gradient) and its
    whole-row sums (``all_sum``); norms, products, the MLP and the loss
    stay local. Every exchange is an autograd op whose backward is a
    collective too, so every rank runs the same collectives in the same
    order, forward and backward. ``reduce_grads`` and ``reduce_loss``
    all-reduce a parameter gradient or the per-client losses and divide by
    ``size``: each rank's loss is the mean over its ``b * T / size``
    tokens, so that is the mean over all ``b * T`` (exact division when
    ``size`` is a power of two), and every rank holds the same bits after
    it. ``host_staged`` (gloo) copies a CUDA tensor to the host for the
    collective and back. Each collective is tallied by kind
    (``"all-gather"``, ``"all-reduce"``): its output bytes, its count and
    the wall seconds of all (``stats``, ``seconds``; ``reset``)."""

    splits_sequence = True

    def __init__(self, index: int, size: int, group, host_staged: bool):
        self.index, self.size, self.group = index, size, group
        self.host_staged = host_staged
        self.reset()

    def reset(self) -> None:
        self.bytes = {"all-gather": 0, "all-reduce": 0}
        self.count = {"all-gather": 0, "all-reduce": 0}
        self.seconds = 0.0

    def stats(self) -> CollectiveStats:
        return CollectiveStats(dict(self.bytes), dict(self.count))

    def take_seq(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's columns of the last axis (``T``) of ``x``."""
        t = x.shape[-1]
        if t % self.size:
            raise ValueError(f"a sequence of {t} does not split over a "
                             f"model axis of {self.size}")
        w = t // self.size
        return x[..., self.index * w:(self.index + 1) * w]

    def offset(self, t: int) -> int:
        """The absolute position of this rank's first token, for chunks of
        ``t``."""
        return self.index * t

    def gather_prefix(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """``x`` (this rank's chunk along ``dim``) all-gathered, up to the
        end of this rank's chunk: ``[0, (index + 1) * t)``."""
        return _GatherPrefix.apply(x, self, dim)

    def gather_all(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` stacked ``[size, *x.shape]`` in rank order;
        its gradient goes back to each slot's owner (all-reduced)."""
        return _GatherAll.apply(x, self)

    def all_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the ranks. Its backward sums the gradient over
        the ranks too, not the identity: every rank adds what it computes
        from the sum to its own loss, and ``reduce_grads`` then divides by
        ``size``."""
        return _AllSum.apply(x, self)

    def prev_rows(self, x: torch.Tensor, n: int, dim: int) -> torch.Tensor:
        """The last ``n`` rows along ``dim`` of the previous rank's chunk
        (zeros on rank 0): the left context of a token shift (``n = 1``) or
        a causal conv of width ``n + 1``. Their gradient goes back to the
        previous rank's last rows."""
        t = x.shape[dim]
        if t < n:
            raise ValueError(f"a chunk of {t} along dim {dim} holds fewer "
                             f"than the {n} rows the next rank needs")
        every = self.gather_all(x.narrow(dim, t - n, n))
        # rank 0's zeros through the same ops as every rank (the graph, and
        # so the backward's collectives, is the same on every rank)
        return torch.cat([torch.zeros_like(every[:1]), every[:-1]])[
            self.index]

    def carry_in(self, s_local: torch.Tensor,
                 log_decay: torch.Tensor) -> torch.Tensor:
        """The state entering this rank's chunk of a linear recurrence ``S
        <- exp(log_decay_t) * S + delta_t``: ``s_local`` is this chunk's
        final state run from zero, ``log_decay`` (broadcast against it) the
        chunk's summed log decay. Both are all-gathered in one collective
        and combined here in fp32, ``S_in(r) = sum_{q<r} exp(sum_{q<p<r}
        L_p) * S_loc(q)``, as the scan ``S_in(r + 1) = exp(L_r) * S_in(r) +
        S_loc(r)`` over the ranks; each contribution's gradient goes back
        to its owner."""
        n = s_local.numel()
        every = self.gather_all(torch.cat([s_local.float().reshape(-1),
                                           log_decay.float().reshape(-1)]))
        states = every[:, :n].reshape((self.size,) + s_local.shape)
        decays = every[:, n:].reshape((self.size,) + log_decay.shape)
        acc = torch.zeros_like(states[0])
        entering = [acc]
        for r in range(self.size - 1):
            acc = torch.exp(decays[r]) * acc + states[r]
            entering.append(acc)
        return torch.stack(entering)[self.index]

    def reduce_grads(self, grad):
        """A parameter gradient (or its ``Groups``) summed over the ranks
        and divided by ``size``: one all-reduce per group."""
        return gmap(self._mean, grad)

    def reduce_loss(self, loss: torch.Tensor) -> torch.Tensor:
        """The per-client losses ``[B, m]`` averaged over the ranks."""
        return self._mean(loss)

    @contextlib.contextmanager
    def active(self):
        """The model's forward splits each sequence over this axis."""
        from repro_torch.sharding.specs import sequence_parallel

        with sequence_parallel(self):
            yield

    def _mean(self, x: torch.Tensor) -> torch.Tensor:
        return self._all_reduce(x) / self.size

    def _tally(self, kind: str, out: torch.Tensor, t0: float) -> None:
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
        self.seconds += time.perf_counter() - t0
        self.bytes[kind] += out.numel() * out.element_size()
        self.count[kind] += 1

    def _all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        import torch.distributed as dist

        t0 = time.perf_counter()
        src = x.detach().contiguous()
        if self.host_staged:
            src = src.cpu()
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        out = torch.cat(parts, dim).to(x.device)
        self._tally("all-gather", out, t0)
        return out

    def _all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist

        t0 = time.perf_counter()
        buf = x.detach().to("cpu" if self.host_staged else x.device,
                            copy=True).contiguous()
        dist.all_reduce(buf, group=self.group)
        out = buf.to(x.device)
        self._tally("all-reduce", out, t0)
        return out


@dataclass
class WorkerContext:
    """A worker's place in its mesh (``worker_context()``). ``model`` and
    ``sequence`` are the two splits over its ``"model"`` group (None
    without a model axis of size > 1); ``split`` says which one the call
    in progress uses (``"clients"`` or ``"sequence"``, set by the caller's
    function, ``axis()``)."""

    rank: int
    mesh: Mesh
    device: torch.device
    backend: str
    device_mesh: Any
    model: Optional[ModelAxis]
    sequence: Optional[SequenceAxis] = None
    split: str = "clients"

    def axis(self):
        """The model-axis hook of the call in progress: the
        ``SequenceAxis`` while ``split`` is ``"sequence"``, else the
        ``ModelAxis`` (None without a model axis)."""
        return self.sequence if self.split == "sequence" else self.model


_CONTEXT: Optional[WorkerContext] = None


def worker_context() -> WorkerContext:
    """The calling worker's context; raises outside a pool worker."""
    if _CONTEXT is None:
        raise RuntimeError("not inside a repro_torch pool worker (run the "
                           "call through repro_torch.sharding.pool.Pool)")
    return _CONTEXT


# bytes a pipe message: a pickle crosses as its length, then pieces of at
# most this size (multiprocessing's recv_bytes asks the OS for all that is
# left of a message at every read, which makes one message of a GB or more,
# a large client buffer coming back, crawl)
PIECE_BYTES = 16 * 2 ** 20


def _send_obj(conn, obj) -> None:
    data = pickle.dumps(obj)
    conn.send_bytes(len(data).to_bytes(8, "little"))
    for at in range(0, len(data), PIECE_BYTES):
        conn.send_bytes(data, at, min(PIECE_BYTES, len(data) - at))


def _recv_obj(conn):
    size = int.from_bytes(conn.recv_bytes(), "little")
    buf = bytearray(size)
    at = 0
    while at < size:
        at += conn.recv_bytes_into(buf, at)
    return pickle.loads(buf)


def _send(conn, *msg) -> None:
    _send_obj(conn, msg)


def _worker_main(rank: int, mesh: Mesh, backend: str, store_path: str, conn,
                 threads: int) -> None:
    """A worker process: join the process group and the device mesh, say
    ``ready``, then run ``(fn, args)`` requests until told to stop."""
    global _CONTEXT
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    try:
        torch.set_num_threads(threads)
        dev = mesh.devices[rank]
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, mesh.size), rank=rank,
            world_size=mesh.size,
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        dm = init_device_mesh("cuda" if backend == "nccl" else "cpu",
                              mesh.dims, mesh_dim_names=mesh.axis_names)
        model = sequence = None
        if mesh.shape.get("model", 1) > 1:
            axis = (dm.get_local_rank("model"), mesh.shape["model"],
                    dm.get_group("model"))
            model = ModelAxis(*axis, host_staged=backend == "gloo")
            sequence = SequenceAxis(*axis, host_staged=backend == "gloo")
        _CONTEXT = WorkerContext(rank, mesh, dev, backend, dm, model,
                                 sequence)
        _send(conn, "ready", None, 0.0)
    except Exception:       # reported to the pool, which raises it
        _send(conn, "error", traceback.format_exc(), 0.0)
        return
    try:
        while True:
            try:
                fn, args = _recv_obj(conn)
            except EOFError:
                break
            if fn is None:
                break
            t0 = time.perf_counter()
            try:
                value = fn(*args)
            except Exception:   # reported to the caller with its traceback
                _send(conn, "error", traceback.format_exc(),
                      time.perf_counter() - t0)
            else:
                _send(conn, "ok", value, time.perf_counter() - t0)
    finally:
        dist.destroy_process_group()


@dataclass
class RankReport:
    rank: int
    device: str
    seconds: float
    pid: int


@dataclass
class PoolResult:
    """One call's values in rank order, the backend, and each rank's device,
    wall seconds inside its worker and process id."""

    values: List[Any]
    backend: str
    ranks: List[RankReport]


# pools may start from several threads at once; next() of a count is atomic
_GENERATIONS = itertools.count(1)


class Pool:
    """One worker process per rank of ``mesh`` (see the module docstring).
    ``generation`` numbers the pools made in this process, so a caller can
    tell whether state it left in the workers survives."""

    def __init__(self, mesh: Mesh, threads: Optional[int] = None):
        self.generation = next(_GENERATIONS)
        self.mesh = mesh
        self.backend = backend_for(mesh)
        self.closed = False
        self._dir = tempfile.mkdtemp(prefix="repro_torch_pool_")
        self._conns: List[Any] = []
        self._procs: List[Any] = []
        ctx = multiprocessing.get_context("spawn")
        if threads is None:
            threads = max(1, (os.cpu_count() or 1) // mesh.size)
        store = os.path.join(self._dir, "store")
        try:
            for r in range(mesh.size):
                here, there = ctx.Pipe()
                proc = ctx.Process(target=_worker_main,
                                   args=(r, mesh, self.backend, store, there,
                                         threads),
                                   name=f"repro_torch-rank{r}", daemon=True)
                proc.start()
                there.close()
                self._conns.append(here)
                self._procs.append(proc)
            self._collect(START_TIMEOUT_S, "rendezvous")
        except BaseException:
            self.close(graceful=False)
            raise

    def _collect(self, timeout: Optional[float], what: str):
        """One reply per rank: ``[(value, seconds)]`` in rank order."""
        deadline = None if timeout is None else time.monotonic() + timeout
        out: Dict[int, tuple] = {}
        while len(out) < len(self._procs):
            pending = [r for r in range(len(self._procs)) if r not in out]
            left = None if deadline is None else deadline - time.monotonic()
            if left is not None and left <= 0:
                self.close(graceful=False)
                raise TimeoutError(
                    f"the {what} of the pool on {self.mesh.devices} did not "
                    f"finish within {timeout:g} s (ranks {pending} silent)")
            ready = wait([self._conns[r] for r in pending]
                         + [self._procs[r].sentinel for r in pending],
                         timeout=left)
            for r in pending:
                conn, status = self._conns[r], None
                if conn in ready or (self._procs[r].sentinel in ready
                                     and conn.poll()):
                    try:
                        status, value, seconds = _recv_obj(conn)
                    except EOFError:
                        status, value, seconds = "died", None, 0.0
                    if status == "error":
                        self.close(graceful=False)
                        raise RuntimeError(
                            f"rank {r} of the pool on {self.mesh.devices} "
                            f"failed in its {what}:\n{value}")
                    if status != "died":
                        out[r] = (value, seconds)
                        continue
                if status == "died" or self._procs[r].sentinel in ready:
                    self._procs[r].join(1.0)
                    code = self._procs[r].exitcode
                    self.close(graceful=False)
                    raise RuntimeError(
                        f"rank {r} of the pool on {self.mesh.devices} exited "
                        f"(code {code}) during its {what}")
        return [out[r] for r in range(len(self._procs))]

    def run(self, fn: Callable, args: Sequence[tuple]) -> PoolResult:
        """``fn(*args[r])`` on every rank ``r``; ``fn`` must be importable
        by the workers (a module-level function)."""
        if self.closed:
            raise RuntimeError("this pool is closed")
        if len(args) != len(self._procs):
            raise ValueError(f"{len(args)} argument tuples for "
                             f"{len(self._procs)} ranks")
        for conn, a in zip(self._conns, args):
            _send_obj(conn, (fn, tuple(a)))
        got = self._collect(None, getattr(fn, "__name__", "call"))
        return PoolResult(
            [v for v, _ in got], self.backend,
            [RankReport(r, str(d), s, p.pid) for r, (d, p, (_, s)) in
             enumerate(zip(self.mesh.devices, self._procs, got))])

    def close(self, graceful: bool = True) -> None:
        """Stop the workers (asked first when ``graceful``, else
        terminated) and remove the rendezvous directory."""
        if self.closed:
            return
        self.closed = True
        for conn, proc in zip(self._conns, self._procs):
            if graceful and proc.is_alive():
                try:
                    _send(conn, None, ())
                except OSError:
                    pass
        for proc in self._procs:
            proc.join(10.0 if graceful else 0.0)
            if proc.is_alive():
                proc.terminate()
                proc.join(5.0)
            if proc.is_alive():
                proc.kill()
                proc.join()
        for conn in self._conns:
            conn.close()
        shutil.rmtree(self._dir, ignore_errors=True)


_POOLS: Dict[Mesh, Pool] = {}
_AT_EXIT: List[bool] = []


def pool_for(mesh: Mesh, threads: Optional[int] = None) -> Pool:
    """The pool of ``mesh``, started on first use and reused until it is
    closed (a failed call closes it; the next call starts a new one).
    ``threads`` sets a new pool's intra-op threads a worker (default
    ``max(1, cpu_count // world)``), for a caller that shares the host with
    other processes."""
    pool = _POOLS.get(mesh)
    if pool is None or pool.closed:
        if not _AT_EXIT:
            atexit.register(close_pools)
            _AT_EXIT.append(True)
        pool = _POOLS[mesh] = Pool(mesh, threads)
    return pool


def close_pools() -> None:
    """Close every pool ``pool_for`` started."""
    for pool in list(_POOLS.values()):
        pool.close()
    _POOLS.clear()


__all__ = ["Pool", "PoolResult", "RankReport", "ModelAxis", "SequenceAxis",
           "WorkerContext", "backend_for", "worker_context", "pool_for",
           "close_pools", "START_TIMEOUT_S", "COLLECTIVE_TIMEOUT_S"]

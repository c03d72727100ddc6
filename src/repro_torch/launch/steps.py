"""Step builders and input specs of one card for the dry run (port of
``repro.launch.steps``): every step runs on the meta device, so it gives
shapes and dtypes and computes no values.

- ``make_train_step``: one FedPBC round (Alg. 1) of the launcher's engine
  (``repro_torch.core.make_round_fn``): ``num_clients`` clients, each its
  share of the shape's global batch, ``local_steps`` SGD steps, the server
  aggregation;
- ``make_prefill_step``: ``forward`` over the whole sequence, the last
  position's logits returned;
- ``make_serve_step``: one ``decode_step`` against the cache plus greedy
  sampling.

An input spec is the step's inputs as meta tensors (the reference's
``ShapeDtypeStruct`` s). The vlm and audio families' memory is bf16 there,
as in the reference's specs (``MEM_DTYPE``). The steps ask for the plain
versions of attention and WKV6 (``BACKEND``): no kernel has a meta mode,
and ``dispatch.resolve_backend`` refuses meta tensors (``launch/dryrun.py``
counts attention as the flash kernels' work all the same).

Two placements, as the dry run asks:
- one card (``train_input_specs`` and the input specs below it): plain
  meta tensors, and the round holds every model in its flat buffers
  (``core/params.py``), the engine the card runs;
- a production mesh (``launch/mesh.py``): the inputs are DTensors on the
  simulated group of ``sharding/spmd.py``, each placed by the reference's
  specs (``train_shardings``, ``serve_shardings``). The round then holds
  each model leaf by leaf (``core.params.Leaves``: ``[1, m, *shape]``
  clients, ``[1, *shape]`` server), since a spec that shards a leaf's own
  dims is no slice of a flat buffer; the same algorithm, local SGD steps,
  aggregation (the engine's branch path) and postponed broadcast run over
  the leaves, in the ``pod_silo`` placement (``make_fed_setup``: one
  client per pod). Every placed leaf carries the engine's trajectory dim
  first, replicated.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import FederationConfig, ModelConfig, ShapeConfig
from repro_torch.core import (
    Groups,
    init_fed_state,
    make_algorithm_spec,
    make_link_process,
    make_round_fn,
)
from repro_torch.core.algorithms import AlgoState
from repro_torch.core.federated import FedState
from repro_torch.core.params import Leaves
from repro_torch.data import memory_shape
from repro_torch.launch.mesh import dp_axes, num_clients_for
from repro_torch.models.layers import dtype_of
from repro_torch.models.model import (
    decode_step,
    forward,
    loss_fn,
    make_cache,
    make_loss,
    param_layout,
)
from repro_torch.optim import sgd
from repro_torch.sharding.specs import (
    P,
    infer_pytree_specs,
    leaf_spec,
    spec_for_shape,
)

DEVICE = "meta"
BACKEND = "torch"
MEM_DTYPE = torch.bfloat16


def _memory(cfg: ModelConfig, lead, batch: int):
    ms = memory_shape(cfg, batch)
    if ms is None:
        return None
    return torch.empty(tuple(lead) + ms, dtype=MEM_DTYPE, device=DEVICE)


def empty_params(cfg: ModelConfig):
    """One model's leaves ``{name: shape}``, each in its dtype."""
    layout, dt = param_layout(cfg), dtype_of(cfg)
    return {name: torch.empty(tuple(shape), dtype=layout.dtype_of(name, dt),
                              device=DEVICE)
            for name, shape in layout.leaves}


def _empty_flat_params(cfg: ModelConfig):
    """The round engine's buffers ``[1, n]`` of one trajectory (``Groups``
    for a model in two parameter groups), as ``init_params`` packs them."""
    dt = dtype_of(cfg)
    bufs = [torch.empty((1, n), dtype=gdt, device=DEVICE)
            for n, gdt in zip(param_layout(cfg).sizes(dt),
                              (dt, torch.float32))]
    return Groups(bufs) if len(bufs) > 1 else bufs[0]


# ---------------------------------------------------------------------------
# Train (one federated round)
# ---------------------------------------------------------------------------


def _fed_setup(cfg: ModelConfig, num_clients: int, local_steps: int,
               algorithm: str):
    """``(fed, algo, link, opt, round_fn)`` of a round of ``num_clients``
    clients over Bernoulli uplinks at p = 0.8 with SGD at lr 1e-3 and
    momentum 0.9, as the reference's setup."""
    fed = FederationConfig(algorithm=algorithm, num_clients=num_clients,
                           local_steps=local_steps, scheme="bernoulli")
    algo = make_algorithm_spec((algorithm,), fed)
    link = make_link_process(
        torch.full((1, num_clients), 0.8, device=DEVICE), fed)
    opt = sgd(1e-3, momentum=0.9)
    round_fn = make_round_fn(make_loss(cfg, BACKEND), opt, algo, link, fed)
    return fed, algo, link, opt, round_fn


def train_input_specs(cfg: ModelConfig, shape: ShapeConfig, *,
                      num_clients: int = 1, local_steps: int = 1,
                      algorithm: str = "fedpbc"):
    """``(state, batches, u)`` of one round (``round_fn(state, batches,
    u)``): the ``FedState`` of one trajectory (``algorithm``'s state),
    batch leaves ``[1, m, s, b, T]`` with ``b = global_batch // m``, the
    link uniforms ``[1, m]``."""
    m, s = num_clients, local_steps
    b = shape.global_batch // m
    fed, algo, link, opt, _ = _fed_setup(cfg, m, s, algorithm)
    u = torch.empty((1, m), dtype=torch.float32, device=DEVICE)
    state = init_fed_state(u, _empty_flat_params(cfg), fed, algo, link, opt)
    toks = torch.empty((1, m, s, b, shape.seq_len), dtype=torch.int64,
                       device=DEVICE)
    batches = {"tokens": toks, "labels": torch.empty_like(toks)}
    memory = _memory(cfg, (1, m, s), b)
    if memory is not None:
        batches["memory"] = memory
    return state, batches, u


def make_train_step(cfg: ModelConfig, *, num_clients: int = 1,
                    local_steps: int = 1, algorithm: str = "fedpbc"):
    """``round_fn(state, batches, u) -> (state', metrics)``."""
    return _fed_setup(cfg, num_clients, local_steps, algorithm)[-1]


# ---------------------------------------------------------------------------
# Prefill / decode (serve path)
# ---------------------------------------------------------------------------


def prefill_input_specs(cfg: ModelConfig, shape: ShapeConfig):
    """``(params, tokens [b, T], memory or None)``."""
    tokens = torch.empty((shape.global_batch, shape.seq_len),
                         dtype=torch.int64, device=DEVICE)
    return (empty_params(cfg), tokens, _memory(cfg, (), shape.global_batch))


def make_prefill_step(cfg: ModelConfig):
    def prefill(params, tokens, memory=None):
        logits, _ = forward(params, cfg, tokens, memory=memory,
                            backend=BACKEND)
        # only the last position's logits (the next token) leave the step
        return logits[:, -1]
    return prefill


def serve_input_specs(cfg: ModelConfig, shape: ShapeConfig):
    """``(params, cache, token [b, 1], pos, memory or None)``: a cache of
    ``seq_len`` positions and ``pos = seq_len - 1``, the step that reads a
    full cache."""
    b = shape.global_batch
    token = torch.empty((b, 1), dtype=torch.int64, device=DEVICE)
    return (empty_params(cfg), make_cache(cfg, b, shape.seq_len,
                                          device=DEVICE),
            token, shape.seq_len - 1, _memory(cfg, (), b))


def make_serve_step(cfg: ModelConfig):
    def serve(params, cache, token, pos, memory=None):
        logits, cache = decode_step(params, cfg, token, cache, pos,
                                    memory=memory, backend=BACKEND)
        return logits[:, -1].argmax(-1)[:, None], cache
    return serve


# ---------------------------------------------------------------------------
# Placement on a production mesh (the reference's sharding half)
# ---------------------------------------------------------------------------


def _lead(spec: P) -> P:
    """A leaf's spec behind the engine's replicated trajectory dim."""
    return P(None, *spec)


def make_leaf_loss(cfg: ModelConfig):
    """The round engine's loss over ``Leaves`` (layout order), each leaf
    ``[*L, *shape]``: ``(leaves, batch) -> [*L]``."""
    names = _leaf_names(cfg)

    def loss(leaves, batch) -> torch.Tensor:
        return loss_fn(dict(zip(names, leaves)), cfg, batch, backend=BACKEND)

    return loss


def make_fed_setup(cfg: ModelConfig, mesh, *, local_steps: int = 1,
                   algorithm: str = "fedpbc"):
    """``(fed, algo, link, opt, round_fn)`` of the reference's setup on
    ``mesh``: ``pod_silo``, one client per pod (``num_clients_for``), over
    Bernoulli uplinks at p = 0.8 with SGD at lr 1e-3 and momentum 0.9; the
    round over ``Leaves``."""
    m = num_clients_for(mesh)
    fed = FederationConfig(algorithm=algorithm, num_clients=m,
                           local_steps=local_steps, scheme="bernoulli",
                           placement="pod_silo")
    algo = make_algorithm_spec((algorithm,), fed)
    link = make_link_process(torch.full((1, m), 0.8, device=DEVICE), fed)
    opt = sgd(1e-3, momentum=0.9)
    round_fn = make_round_fn(make_leaf_loss(cfg), opt, algo, link, fed)
    return fed, algo, link, opt, round_fn


def _batch_spec(shape, mesh) -> P:
    """``[m, s, B, ...]``: the client axis over ``"pod"``, the batch over
    ``"data"``."""
    spec = [None] * len(shape)
    if "pod" in mesh.axis_names and shape[0] % mesh.shape["pod"] == 0:
        spec[0] = "pod"
    if len(shape) >= 3 and shape[2] % mesh.shape["data"] == 0:
        spec[2] = "data"
    return P(*spec)


def _leaf_names(cfg: ModelConfig):
    return [name for name, _ in param_layout(cfg).leaves]


def _client_specs(x, names, mesh):
    """Specs of client-axis state: ``Leaves``/``Groups`` of ``[1, m,
    *shape]`` leaves by their names, or one ``[1, m, ...]`` tensor."""
    if isinstance(x, Groups):
        return type(x)(_lead(leaf_spec(n, t.shape[1:], mesh,
                                       client_axis=True))
                       for n, t in zip(names, x))
    return _lead(spec_for_shape(tuple(x.shape[1:]), mesh, client_axis=True))


def train_shardings(state: FedState, batches, mesh, names):
    """``(state specs, batch specs)``: the server without the client axis;
    clients, optimizer state and algorithm state with it (``"pod"``); link
    state, round and ``last_active`` replicated (``None``: no placement,
    a plain tensor is replicated). ``names``: the leaves' names."""
    st = FedState(
        server=Leaves(_lead(leaf_spec(n, t.shape[1:], mesh))
                      for n, t in zip(names, state.server)),
        clients=_client_specs(state.clients, names, mesh),
        opt_state={k: _client_specs(v, names, mesh)
                   for k, v in state.opt_state.items()},
        algo_state=AlgoState(**{
            f: _client_specs(getattr(state.algo_state, f), names, mesh)
            for f in ("gap", "sum_gaps", "n_gaps", "lam", "mem", "mom")}),
        link_state=None, round=None, last_active=None)
    b_specs = {k: _lead(_batch_spec(tuple(v.shape[1:]), mesh))
               for k, v in batches.items()}
    return st, b_specs


def _place(x, spec, mesh, dmesh, fill=None):
    """``x`` (a tensor, or ``Groups`` of them) as DTensors placed by
    ``spec`` (alike), rank 0's shards new; ``spec`` None keeps ``x``."""
    from repro_torch.sharding.spmd import distribute_empty

    if spec is None:
        return x
    if isinstance(x, Groups):
        return type(x)(_place(t, sp, mesh, dmesh, fill)
                       for t, sp in zip(x, spec))
    return distribute_empty(x.shape, x.dtype, spec, mesh, dmesh,
                            device=DEVICE if fill is None else None,
                            fill=fill)


def placed_train_inputs(cfg: ModelConfig, shape: ShapeConfig, mesh, dmesh,
                        *, local_steps: int = 1, algorithm: str = "fedpbc"):
    """``(state, batches, u)`` of one round on ``mesh`` (``round_fn(state,
    batches, u)`` of ``make_fed_setup``): the ``FedState`` over ``Leaves``
    and the batches ``[1, m, s, b, T]`` (``b = global_batch // m``), placed
    by ``train_shardings`` on ``dmesh``."""
    m, s = num_clients_for(mesh), local_steps
    b = shape.global_batch // m
    fed, algo, link, opt, _ = make_fed_setup(cfg, mesh, local_steps=s,
                                             algorithm=algorithm)
    names = _leaf_names(cfg)
    server = Leaves(t.unsqueeze(0) for t in empty_params(cfg).values())
    u = torch.empty((1, m), dtype=torch.float32, device=DEVICE)
    state = init_fed_state(u, server, fed, algo, link, opt)
    toks = torch.empty((1, m, s, b, shape.seq_len), dtype=torch.int64,
                       device=DEVICE)
    batches = {"tokens": toks, "labels": torch.empty_like(toks)}
    memory = _memory(cfg, (1, m, s), b)
    if memory is not None:
        batches["memory"] = memory
    st, b_specs = train_shardings(state, batches, mesh, names)
    placed = FedState(
        server=_place(state.server, st.server, mesh, dmesh),
        clients=_place(state.clients, st.clients, mesh, dmesh),
        opt_state={k: _place(v, st.opt_state[k], mesh, dmesh)
                   for k, v in state.opt_state.items()},
        algo_state=AlgoState(**{
            f: _place(getattr(state.algo_state, f),
                      getattr(st.algo_state, f), mesh, dmesh)
            for f in ("gap", "sum_gaps", "n_gaps", "lam", "mem", "mom")}),
        link_state=state.link_state, round=state.round,
        last_active=state.last_active)
    batches = {k: _place(v, b_specs[k], mesh, dmesh)
               for k, v in batches.items()}
    return placed, batches, u


def placed_params(cfg: ModelConfig, mesh, dmesh, *, fill=None):
    """One model's leaves placed by ``infer_pytree_specs`` on ``dmesh``."""
    params = empty_params(cfg)
    specs = infer_pytree_specs(params, mesh)
    return {k: _place(v, specs[k], mesh, dmesh, fill)
            for k, v in params.items()}


def _dp_size(mesh) -> int:
    n = 1
    for a in dp_axes(mesh):
        n *= mesh.shape[a]
    return n


def placed_prefill_inputs(cfg: ModelConfig, shape: ShapeConfig, mesh,
                          dmesh, *, fill=None):
    """``(params, tokens [b, T], memory or None)`` on ``dmesh``: the
    params by their specs, the tokens and memory over the data-parallel
    axes, as the reference's prefill."""
    params, tokens, memory = prefill_input_specs(cfg, shape)
    dp = dp_axes(mesh)
    out = (placed_params(cfg, mesh, dmesh, fill=fill),
           _place(tokens, P(dp, None), mesh, dmesh, fill))
    return out + (None if memory is None else
                  _place(memory, P(dp, None, None), mesh, dmesh, fill),)


def _cache_leaf_spec(name: str, shape, mesh, batch: int) -> P:
    """Cache leaves ``[n_periods, B, S, KV, hd]`` (attention) and the RWKV
    and SSM states: the batch over the data-parallel axes; the long
    (sequence or state) dims over ``"model"`` where it divides them."""
    dp = dp_axes(mesh)
    dp_size = _dp_size(mesh)
    nd = len(shape)
    spec = [None] * nd
    if nd >= 2 and shape[1] % dp_size == 0 and shape[1] >= dp_size:
        spec[1] = dp
    if name in ("k", "v") and nd == 5 and shape[2] % mesh.shape["model"] == 0:
        spec[2] = "model"        # cache sequence dim
    elif name == "h" and nd == 4 and shape[2] % mesh.shape["model"] == 0:
        spec[2] = "model"        # mamba d_inner
    elif name == "conv" and nd == 4 and shape[3] % mesh.shape["model"] == 0:
        spec[3] = "model"
    return P(*spec)


def _tp2d_spec(shape, mesh) -> P:
    """Decode-oriented 2-D tensor parallelism: each weight's last (output)
    dim over both mesh axes, so products consume local shards
    (contracting-dim partials are summed) and no weight is gathered."""
    both = mesh.shape["data"] * mesh.shape["model"]
    spec = [None] * len(shape)
    if len(shape) >= 2:
        if shape[-1] % both == 0 and shape[-1] >= both:
            spec[-1] = ("data", "model")
        elif shape[-1] % mesh.shape["model"] == 0:
            spec[-1] = "model"
            if (shape[-2] % mesh.shape["data"] == 0
                    and shape[-2] >= mesh.shape["data"] * 2):
                spec[-2] = "data"
        elif shape[-2] % mesh.shape["model"] == 0:
            spec[-2] = "model"
    return P(*spec)


def serve_shardings(params, cache, mesh, batch: int, *, tp2d: bool = False):
    """``(param specs, cache specs, token spec)`` of the decode step: the
    params by ``infer_pytree_specs`` (or ``_tp2d_spec``), each cache leaf
    by ``_cache_leaf_spec``, the tokens over the data-parallel axes where
    they divide the batch."""
    if tp2d:
        p_specs = {k: _tp2d_spec(v.shape, mesh) for k, v in params.items()}
    else:
        p_specs = infer_pytree_specs(params, mesh)
    c_specs = tuple({k: _cache_leaf_spec(k, v.shape, mesh, batch)
                     for k, v in c.items()} for c in cache)
    dp = dp_axes(mesh)
    tok_spec = P(dp if batch % _dp_size(mesh) == 0 else None, None)
    return p_specs, c_specs, tok_spec


def placed_serve_inputs(cfg: ModelConfig, shape: ShapeConfig, mesh, dmesh,
                        *, tp2d: bool = False):
    """``(params, cache, token [b, 1], pos, memory or None)`` on ``dmesh``,
    placed by ``serve_shardings``; the memory replicated."""
    params, cache, token, pos, memory = serve_input_specs(cfg, shape)
    p_specs, c_specs, tok_spec = serve_shardings(
        params, cache, mesh, shape.global_batch, tp2d=tp2d)
    params = {k: _place(v, p_specs[k], mesh, dmesh)
              for k, v in params.items()}
    cache = tuple({k: _place(v, cs[k], mesh, dmesh)
                   for k, v in c.items()} for c, cs in zip(cache, c_specs))
    token = _place(token, tok_spec, mesh, dmesh)
    if memory is not None:
        memory = _place(memory, P(None, None, None), mesh, dmesh)
    return params, cache, token, pos, memory

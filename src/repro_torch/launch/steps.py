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
counts attention as the flash kernels' work all the same). One card: the
production meshes these steps would be placed on (the reference's
``make_production_mesh`` and ``sharding/specs.py``) are ROADMAP item 6b.
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
from repro_torch.data import memory_shape
from repro_torch.models.layers import dtype_of
from repro_torch.models.model import (
    decode_step,
    forward,
    make_cache,
    make_loss,
    param_layout,
)
from repro_torch.optim import sgd

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

"""The synthetic stand-in task of the paper-table sweeps (port of
``repro.experiments.tasks``): the 10-class Gaussian task from
``repro_torch.data.synthetic`` with a 2-layer MLP; and the LM task
(``make_traced_lm_task``), a reduced smollm-class transformer over a styled
synthetic corpus, which rides the same sweep engine.

The MLP keeps the reference's layout, ``w1 [dim, hidden]``, ``b1``,
``w2 [hidden, classes]``, ``b2`` with ``x @ w1``, as named views into one
flat buffer (``repro_torch.core.params``). Its functions are batched over
leading model axes: local training evaluates ``B * m`` client models at
once (``[B, m, n]``), evaluation ``B`` server models (``[B, n]``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, Dict

import numpy as np
import torch

from repro_torch.core.params import ParamLayout
from repro_torch.data import (
    classification_source,
    dirichlet_partition,
    make_classification_data,
    traced_classification_source,
)
from repro_torch.data.sources import DataSource, traced_lm_source


def mlp_layout(dim=32, classes=10, hidden=64) -> ParamLayout:
    return ParamLayout((("w1", (dim, hidden)), ("b1", (hidden,)),
                        ("w2", (hidden, classes)), ("b2", (classes,))))


def mlp_init(gen: torch.Generator, dim=32, classes=10, hidden=64) -> torch.Tensor:
    """One model's flat params ``[n]`` from the generator (on its device)."""
    dev = gen.device
    w1 = torch.randn(dim, hidden, generator=gen, device=dev) * dim ** -0.5
    w2 = torch.randn(hidden, classes, generator=gen, device=dev) * hidden ** -0.5
    return torch.cat([w1.reshape(-1), torch.zeros(hidden, device=dev),
                      w2.reshape(-1), torch.zeros(classes, device=dev)])


def mlp_logits(params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """``params`` leaves carry leading model axes ``L`` (``w1 [*L, dim,
    hidden]``); ``x`` is ``[*L, b, dim]`` or shared ``[b, dim]``. Returns
    ``[*L, b, classes]``."""
    h = torch.relu(x @ params["w1"] + params["b1"].unsqueeze(-2))
    return h @ params["w2"] + params["b2"].unsqueeze(-2)


def mlp_loss(params: Dict[str, torch.Tensor], batch) -> torch.Tensor:
    """Per-model batch-mean cross entropy ``[*L]`` (``log_softmax`` of the
    logits at the label, as the reference's one-hot sum)."""
    logp = torch.log_softmax(mlp_logits(params, batch["x"]), -1)
    picked = logp.gather(-1, batch["y"].long().unsqueeze(-1)).squeeze(-1)
    return -picked.mean(-1)


def mlp_accuracy(params: Dict[str, torch.Tensor], x, y) -> torch.Tensor:
    """Per-model accuracy ``[*L]`` on a shared ``x [N, dim]``, ``y [N]``."""
    pred = mlp_logits(params, x).argmax(-1)
    return (pred == y).float().mean(-1)


def _flat_fns(layout: ParamLayout):
    def loss_fn(flat, batch):
        return mlp_loss(layout.views(flat), batch)

    def accuracy(flat, x, y):
        return mlp_accuracy(layout.views(flat), x, y)

    return loss_fn, accuracy


@dataclass(frozen=True)
class ClassificationTask:
    loss_fn: Callable[..., Any]         # (flat [B, m, n], batch) -> [B, m]
    init_params: Callable[..., Any]     # (generator) -> flat [n]
    eval_test: Callable[..., Any]       # (server [B, n]) -> [B] accuracy
    eval_train: Callable[..., Any]      # (server [B, n]) -> [B] accuracy
    source: DataSource
    layout: ParamLayout
    meta: Dict[str, Any] = field(default_factory=dict)


def _dataset(data_seed, dim, classes, n_per_class, sep, n_train, device):
    x_all, y_all = make_classification_data(data_seed, dim=dim,
                                            num_classes=classes,
                                            n_per_class=n_per_class, sep=sep)
    x, y = x_all[:n_train], y_all[:n_train]
    xt, yt = x_all[n_train:], y_all[n_train:]
    shared = {k: torch.as_tensor(v, device=device)
              for k, v in (("x", x), ("y", y.astype(np.int64)),
                           ("xt", xt), ("yt", yt.astype(np.int64)))}
    return y, shared


def make_classification_task(*, data_seed=0, num_clients=100, dim=32,
                             classes=10, hidden=64, n_per_class=600, sep=3.0,
                             n_train=5000, alpha=0.1, per_client=64,
                             local_steps=5, batch_size=32,
                             device=None) -> ClassificationTask:
    """The shared dataset + partition + source + evals at one ``alpha``."""
    rng = np.random.default_rng(data_seed)
    y, shared = _dataset(data_seed, dim, classes, n_per_class, sep, n_train,
                         device)
    idx, _ = dirichlet_partition(rng, y, num_clients, alpha=alpha,
                                 per_client=per_client)
    source = classification_source(
        shared["x"], shared["y"], torch.as_tensor(idx, device=device),
        local_steps=local_steps, batch_size=batch_size)
    layout = mlp_layout(dim, classes, hidden)
    loss_fn, accuracy = _flat_fns(layout)
    return ClassificationTask(
        loss_fn=loss_fn,
        init_params=lambda gen: mlp_init(gen, dim, classes, hidden),
        eval_test=lambda server: accuracy(server, shared["xt"], shared["yt"]),
        eval_train=lambda server: accuracy(server, shared["x"], shared["y"]),
        source=source,
        layout=layout,
        meta={"dataset": "gaussian10", "data_seed": data_seed, "dim": dim,
              "classes": classes, "hidden": hidden, "n_train": n_train,
              "alpha": alpha, "num_clients": num_clients,
              "per_client": per_client, "local_steps": local_steps,
              "batch_size": batch_size},
    )


@dataclass(frozen=True)
class TracedClassificationTask:
    """Alpha-free task bundle for the batched sweep: ``shared`` is the
    dataset on the device (``{"x", "y", "xt", "yt"}``, one copy for every
    trajectory), ``partition(alpha)`` one hyperparameter point's index table
    (host numpy), and the evals take ``(server [B, n], shared)``."""

    loss_fn: Callable[..., Any]
    init_params: Callable[..., Any]
    source_factory: Callable[..., DataSource]
    eval_test: Callable[..., Any]
    eval_train: Callable[..., Any]
    partition: Callable[[float], np.ndarray]
    shared: Dict[str, Any]
    layout: ParamLayout
    meta: Dict[str, Any] = field(default_factory=dict)


def make_traced_classification_task(*, data_seed=0, num_clients=100, dim=32,
                                    classes=10, hidden=64, n_per_class=600,
                                    sep=3.0, n_train=5000, per_client=64,
                                    local_steps=5, batch_size=32,
                                    device=None) -> TracedClassificationTask:
    """Same dataset bytes and partitions as the reference's traced task for
    the same ``data_seed``; ``partition(alpha)`` draws from a fresh
    ``default_rng(data_seed)``."""
    y, shared = _dataset(data_seed, dim, classes, n_per_class, sep, n_train,
                         device)

    def partition(alpha: float) -> np.ndarray:
        rng = np.random.default_rng(data_seed)
        idx, _ = dirichlet_partition(rng, y, num_clients, alpha=alpha,
                                     per_client=per_client)
        return idx

    layout = mlp_layout(dim, classes, hidden)
    loss_fn, accuracy = _flat_fns(layout)
    return TracedClassificationTask(
        loss_fn=loss_fn,
        init_params=lambda gen: mlp_init(gen, dim, classes, hidden),
        source_factory=lambda sh: traced_classification_source(
            sh, local_steps=local_steps, batch_size=batch_size,
            per_client=per_client),
        eval_test=lambda server, sh: accuracy(server, sh["xt"], sh["yt"]),
        eval_train=lambda server, sh: accuracy(server, sh["x"], sh["y"]),
        partition=partition,
        shared=shared,
        layout=layout,
        meta={"dataset": "gaussian10", "data_seed": data_seed, "dim": dim,
              "classes": classes, "hidden": hidden, "n_train": n_train,
              "n_test": int(len(shared["xt"])), "num_clients": num_clients,
              "per_client": per_client, "local_steps": local_steps,
              "batch_size": batch_size},
    )


def with_label_noise(shared: Dict[str, Any], gen: torch.Generator = None,
                     frac: float = 0.1, classes: int = None, *,
                     uniforms: torch.Tensor = None) -> Dict[str, Any]:
    """Same-shape label-noise variant of a task's ``shared`` dataset (the
    reference's ``with_label_noise``): a Bernoulli(``frac``) subset of the
    train labels is shifted to the next class, cyclically. The flip
    uniforms ``[N]`` are drawn from ``gen`` on the labels' device, or handed
    in as ``uniforms`` (a test passes the reference's). The dataset is an
    input of the batched runner, so the variant rides an existing runner:
    ``dataclasses.replace(batch, shared=noisy)``."""
    y = shared["y"]
    c = classes if classes is not None else int(y.max()) + 1
    if uniforms is None:
        uniforms = torch.rand(y.shape, generator=gen, device=y.device)
    flip = torch.as_tensor(uniforms, device=y.device) < frac
    return dict(shared, y=torch.where(flip, (y + 1) % c, y))


# Same fields as TracedClassificationTask: the sweep engine and grid.py
# treat both alike; the alias names the workload a call site holds.
LMTask = TracedClassificationTask

# logits elements one eval forward may hold (2^27 fp32: 512 MiB); the
# evals walk the sequences in chunks of this size
EVAL_LOGITS = 1 << 27


def _styled_corpus(rng, *, n, seq_len, vocab, classes):
    """``n`` sequences of ``seq_len + 1`` tokens, each tagged with one of
    ``classes`` styles; style ``c`` draws uniformly from the half-vocab
    window ``[c*V//(2*classes), c*V//(2*classes) + V//2)``. The
    reference's numpy calls in its order: the same generator state gives
    the same bytes."""
    styles = rng.integers(0, classes, size=n).astype(np.int32)
    offsets = (styles * (vocab // 2)) // max(classes, 1)
    toks = offsets[:, None] + rng.integers(
        0, vocab // 2, size=(n, seq_len + 1))
    return toks.astype(np.int32), styles


def make_traced_lm_task(*, data_seed=0, num_clients=8, arch="smollm-135m",
                        d_model=64, layers=2, seq_len=32, classes=4,
                        n_seqs=256, n_test=64, per_client=16, local_steps=2,
                        batch_size=2, device=None, backend=None) -> LMTask:
    """A reduced transformer LM as a sweep workload (the reference's
    ``make_traced_lm_task``).

    The model is ``reduced(get_config(arch), d_model, layers)`` in fp32,
    held as one flat buffer per model (``models.model.param_layout``); the
    corpus is ``_styled_corpus`` on the device as ``shared`` (``{"toks"
    [n, T+1], "toks_t" [n_test, T+1]}``), Dirichlet-partitioned over the
    sequences' styles as the classification task is over its labels. The
    loss is ``models.model.loss_fn`` on ``[B, m, n]`` (chunks of
    ``min(512, seq_len)`` tokens, as the reference's); the evals are the next-token accuracy ``[B]`` of
    the server models ``[B, n]``, over the sequences in chunks of at most
    ``EVAL_LOGITS`` logits. ``backend="torch"`` runs the plain attention
    on the card (to compare the paths); ``None`` launches the flash
    kernels for CUDA tensors. Under the sharded sweep's sequence split
    (``run_sharded_2d(..., activation_spec=P(None, "model", None))``) only
    the local training splits each sequence, for every arch but those of
    the vlm and audio families (which raise: this task gives their cross
    layers no memory); the attention, RWKV6, Mamba and MoE layers take
    what they need from the other ranks (``models/model.py``). Every model
    rank runs the evals whole on the whole server, which all ranks hold
    bit for bit, so their value does not depend on the placement.
    """
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import model as lm

    cfg = dataclasses.replace(reduced(get_config(arch), d_model=d_model,
                                      layers=layers), dtype="float32")
    rng = np.random.default_rng(data_seed)
    toks, styles = _styled_corpus(rng, n=n_seqs, seq_len=seq_len,
                                  vocab=cfg.vocab_size, classes=classes)
    toks_t, _ = _styled_corpus(rng, n=n_test, seq_len=seq_len,
                               vocab=cfg.vocab_size, classes=classes)
    shared = {k: torch.as_tensor(v.astype(np.int64), device=device)
              for k, v in (("toks", toks), ("toks_t", toks_t))}
    layout = lm.param_layout(cfg)

    def partition(alpha: float) -> np.ndarray:
        prng = np.random.default_rng(data_seed)
        idx, _ = dirichlet_partition(prng, styles, num_clients, alpha=alpha,
                                     per_client=per_client)
        return idx

    def next_token_accuracy(server, seqs):
        params = layout.unflatten(server)
        B, T = server.shape[0], seqs.shape[1] - 1
        rows = max(1, EVAL_LOGITS // (B * T * cfg.vocab_size))
        correct = 0
        for s in range(0, seqs.shape[0], rows):
            chunk = seqs[s:s + rows]
            logits, _ = lm.forward(
                params, cfg, chunk[:, :-1].expand(B, -1, -1),
                backend=backend)
            correct = correct + (logits.argmax(-1) == chunk[:, 1:]).sum(
                (-1, -2))
        return correct.float() / (seqs.shape[0] * T)

    return LMTask(
        # loss_fn's chunks: min(512, seq_len), the reference's ce_chunk
        loss_fn=lm.make_loss(cfg, backend),
        init_params=lambda gen: lm.init_params(gen, cfg),
        source_factory=lambda sh: traced_lm_source(
            sh, local_steps=local_steps, batch_size=batch_size,
            per_client=per_client),
        eval_test=lambda server, sh: next_token_accuracy(server,
                                                         sh["toks_t"]),
        eval_train=lambda server, sh: next_token_accuracy(server,
                                                          sh["toks"]),
        partition=partition,
        shared=shared,
        layout=layout,
        meta={"dataset": "styled-lm", "data_seed": data_seed, "arch": arch,
              "d_model": d_model, "layers": layers, "seq_len": seq_len,
              "classes": classes, "vocab": cfg.vocab_size,
              "n_train": n_seqs, "n_test": n_test,
              "num_clients": num_clients, "per_client": per_client,
              "local_steps": local_steps, "batch_size": batch_size},
    )

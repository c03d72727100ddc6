"""The synthetic stand-in task of the paper-table sweeps (port of
``repro.experiments.tasks``): the 10-class Gaussian task from
``repro_torch.data.synthetic`` with a 2-layer MLP.

The MLP keeps the reference's layout, ``w1 [dim, hidden]``, ``b1``,
``w2 [hidden, classes]``, ``b2`` with ``x @ w1``, as named views into one
flat buffer (``repro_torch.core.params``). Its functions are batched over
leading model axes: local training evaluates ``B * m`` client models at
once (``[B, m, n]``), evaluation ``B`` server models (``[B, n]``).
"""
from __future__ import annotations

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
from repro_torch.data.sources import DataSource


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

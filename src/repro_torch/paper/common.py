"""Shared harness of the port's suites (port of ``benchmarks/common.py``).

The grid definitions (``ALGOS``, ``SCHEMES``) and the synthetic stand-in
task (the 2-layer MLP on the 10-class Gaussian dataset) live in
``repro_torch.experiments``; they are re-exported here. The table and
figure suites run on the batched sweep (``run_sweep``).

``run_training`` is the reference's one-call protocol, one (algorithm,
scheme, seed) trajectory per call with its own dataset: the suites that
want a single run (``extensions``) call it. Its randomness comes from
explicit generators seeded as the reference's keys are by role
(``seed_generators(seed)``: params ``seed + 1``, link state ``seed + 2``,
source ``seed + 3``, data ``seed + 4``, the reference's ``PRNGKey(seed +
1..4)``) and its Eq.-9 ``p_base`` from ``np.random.default_rng(seed)``; the
numbers differ from ``jax.random``'s.
"""
from __future__ import annotations

import time

import torch

from repro_torch.configs import FederationConfig
from repro_torch.core import (
    GeneratorDraws,
    build_base_probs,
    init_fed_state,
    make_algorithm_spec,
    make_link_process,
    make_run_rounds,
)
from repro_torch.device import resolve_device
from repro_torch.experiments.grid import ALGOS, SCHEMES  # noqa: F401
from repro_torch.experiments.sweep import map_carry, seed_generators
from repro_torch.experiments.tasks import (  # noqa: F401  (re-export)
    make_classification_task,
    mlp_accuracy,
    mlp_init,
    mlp_loss,
)
from repro_torch.kernels.dispatch import resolve_use_kernel
from repro_torch.optim import paper_decay, sgd


def backend_name(dev) -> str:
    """The reference's ``jax.default_backend()`` name of a torch device:
    ``"gpu"`` for CUDA, else the device type."""
    return "gpu" if dev.type == "cuda" else dev.type


def tree_max_abs_diff(a, b) -> float:
    """Largest |a - b| over two result trees of one structure (dicts,
    tuples, dataclasses such as ``FedState``), in float64, skipping empty
    leaves (the reference's ``_tree_max_abs_diff``)."""
    diffs = [0.0]

    def leaf(x, y):
        if isinstance(x, torch.Tensor) and x.numel():
            diffs.append(float((x.double() - y.double()).abs().max()))
        return x
    map_carry(leaf, a, b)
    return max(diffs)


def timed(fn, dev):
    """``(wall seconds, fn())``, the card synchronised before and after."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter() - t0, out


def warm_timed(fn, dev):
    """``timed`` after one untimed warm call."""
    fn()
    return timed(fn, dev)


def accuracy(params, x, y):
    """``mlp_accuracy`` of one model as a Python float."""
    return float(mlp_accuracy(params, x, y))


def run_training(algo_name, scheme_key, *, rounds=300, m=100, seed=0,
                 alpha=0.1, sigma0=10.0, delta=0.02, gamma=0.5,
                 eval_every=25, device=None, use_kernel=None):
    """One federated run; returns ``(test-acc trajectory, train-acc
    final)``, the trajectory ``[(round, test acc)]`` every ``eval_every``
    rounds. The per-seed dataset (``make_classification_data(seed, dim=32,
    n_per_class=600, sep=3.0)``, the first 5,000 examples for training) is
    Dirichlet-partitioned from ``np.random.default_rng(seed)``; the rounds
    run in chunks of ``eval_every`` through ``make_run_rounds``. With
    ``use_kernel`` a fusable algorithm's server update is one launch of the
    fused aggregation a round (B = 1); the stateful rules keep the branch
    path."""
    dev = resolve_device(device)
    task = make_classification_task(data_seed=seed, num_clients=m,
                                    alpha=alpha, device=dev)
    fed = FederationConfig(algorithm=algo_name, num_clients=m, local_steps=5,
                           gamma=gamma, delta=delta, sigma0=sigma0,
                           alpha=alpha, **SCHEMES[scheme_key])
    p, _, _ = build_base_probs(seed, m, 10, alpha=alpha, sigma0=sigma0,
                               delta=delta)
    algo = make_algorithm_spec((algo_name,), fed)
    link = make_link_process(torch.as_tensor(p, device=dev)[None], fed)
    opt = sgd(paper_decay(0.1))
    run_rounds = make_run_rounds(task.loss_fn, opt, algo, link, fed,
                                 task.source,
                                 use_kernel=resolve_use_kernel(use_kernel),
                                 device=dev)
    draws = GeneratorDraws([seed_generators(seed, dev)], num_clients=m,
                           pick_spec=task.source.pick_spec)
    st = init_fed_state(draws.link_init(), draws.params(task.init_params),
                        fed, algo, link, opt)
    ds_state = task.source.init()
    traj = []
    t = 0
    while t < rounds:
        chunk = min(eval_every, rounds - t)
        st, ds_state, _ = run_rounds(st, ds_state, draws, chunk)
        t += chunk
        traj.append((t, float(task.eval_test(st.server)[0])))
    train_acc = float(task.eval_train(st.server)[0])
    return traj, train_acc


class Timer:
    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *a):
        self.elapsed = time.perf_counter() - self.t0

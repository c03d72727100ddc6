"""Quickstart on the PyTorch port: the paper's Fig.-3 quadratic
counterexample (the twin of ``examples/quickstart.py``).

Two client populations with very different uplink probabilities (0.9 vs
0.1). FedAvg converges to a biased point (Prop. 1); FedPBC's postponed
broadcast (implicit gossiping) removes the bias.

The 400 rounds run through the port's round engine (``make_run_rounds``)
over ``fixed_source``, which serves the same per-client objective every
round; the randomness comes from explicit ``torch.Generator`` s.

  PYTHONPATH=src python examples/torch_port/quickstart.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import FederationConfig
from repro_torch.core import (
    GeneratorDraws,
    init_fed_state,
    make_algorithm_spec,
    make_link_process,
    make_run_rounds,
)
from repro_torch.core.bias import fedavg_fixed_point
from repro_torch.data import fixed_source
from repro_torch.device import resolve_device
from repro_torch.experiments.sweep import seed_generators
from repro_torch.optim import sgd

M, D, S, ROUNDS, ETA = 20, 16, 10, 400, 2e-3


def problem(dev):
    """The clients' optima ``u [M, D]``, the true optimum and the uplink
    probabilities ``p [M]``."""
    g = torch.Generator(device=dev).manual_seed(0)
    u = (torch.arange(M, device=dev) / M)[:, None] + 0.1 * torch.randn(
        M, D, generator=g, device=dev)
    p = torch.where(torch.arange(M, device=dev) < M // 2, 0.9, 0.1)
    return u, u.mean(0), p


def run(algorithm: str, dev) -> float:
    u, x_star, p = problem(dev)
    fed = FederationConfig(algorithm=algorithm, num_clients=M, local_steps=S)
    algo = make_algorithm_spec((algorithm,), fed)
    link = make_link_process(p[None], fed)

    def loss(params, batch):                # [B, M, D] -> [B, M]
        return 0.5 * ((params - batch["u"]) ** 2).sum(-1)

    opt = sgd(ETA)
    source = fixed_source({"u": u[:, None].expand(M, S, D)})
    run_rounds = make_run_rounds(loss, opt, algo, link, fed, source,
                                 device=dev)
    draws = GeneratorDraws([seed_generators(1, dev)], num_clients=M)
    state = init_fed_state(draws.link_init(), torch.zeros(1, D, device=dev),
                           fed, algo, link, opt)
    state, _, metrics = run_rounds(state, source.init(), draws, ROUNDS)
    assert metrics["loss"].shape == (1, ROUNDS)   # stacked per-round metrics
    return float(torch.linalg.norm(state.server[0] - x_star))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cpu, or the card (default; raises without CUDA)")
    dev = resolve_device(ap.parse_args(argv).device)
    err_avg = run("fedavg", dev)
    err_pbc = run("fedpbc", dev)
    u, x_star, p = problem(dev)
    predicted_bias = float(np.linalg.norm(
        fedavg_fixed_point(p.cpu().numpy(), u.cpu().numpy())
        - x_star.cpu().numpy()))
    print(f"||x - x*||  FedAvg : {err_avg:.4f}   (Eq.-3 predicted bias "
          f"{predicted_bias:.4f})")
    print(f"||x - x*||  FedPBC : {err_pbc:.4f}   <- implicit gossiping wins")
    assert err_pbc < 0.5 * err_avg
    return {"fedavg": err_avg, "fedpbc": err_pbc, "bias": predicted_bias}


if __name__ == "__main__":
    main()

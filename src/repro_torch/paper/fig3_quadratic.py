"""Fig. 3: quadratic counterexample — ||x_PS - x*|| over rounds for FedPBC vs
FedAvg under (p0, p1) split-population Bernoulli links, 3 seeds (port of
``benchmarks/fig3_quadratic.py``).

Paper setup: m=100, d=100, s=100, 2500 rounds, eta=1e-4 (``--paper-scale``).
Default here is the reference's scaled version (m=50, s=20, 800 rounds,
eta=5e-4).

Randomness comes from explicit generators with the reference's seeds by
role: ``u`` from ``seed``, the link draws (``GeneratorDraws``: the initial
draw, then each round's uniforms) from ``seed + 1``. The numbers differ
from ``jax.random``'s; a caller can hand ``run_one`` the reference's ``u``
and draws instead. ``run`` runs each algorithm's nine (point, seed)
trajectories as one batch (``run_batch``) where the reference loops over
``run_one``: the engine's eager round is host-bound, so one round for nine
trajectories costs about what one for one does.

    python -m repro_torch.paper.fig3_quadratic [--paper-scale]
"""
from __future__ import annotations

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
from repro_torch.data import DataSource
from repro_torch.device import resolve_device
from repro_torch.experiments.sweep import seed_generators
from repro_torch.kernels.dispatch import resolve_use_kernel
from repro_torch.optim import sgd

PAPER_SCALE = dict(m=100, d=100, s=100, rounds=2500, eta=1e-4)
POINTS = ((0.5, 0.5), (0.9, 0.1), (0.5, 0.1))


def _loss(params, batch):
    """``params [B, m, d]``, ``batch["u"] [B, m, d]`` -> ``[B, m]``."""
    return 0.5 * ((params - batch["u"]) ** 2).sum(-1)


def run_one(algo_name, p0, p1, *, m, d, s, rounds, eta, seed, device=None,
            use_kernel=None, u=None, draws=None):
    """One trajectory; ``[(round, ||x_PS - x*||)]`` at 20 points. ``u [m, d]``
    and ``draws`` (a ``GeneratorDraws`` or anything with its ``link_init``
    and call) replace the seeded ones."""
    return run_batch(algo_name, [(p0, p1)], m=m, d=d, s=s, rounds=rounds,
                     eta=eta, seeds=(seed,), device=device,
                     use_kernel=use_kernel,
                     u=None if u is None else [u], draws=draws)[(p0, p1)][0]


def _draw_u(gens, m, d, dev):
    """The clients' optima ``u [m, d]`` of one seed. ``seed_generators(seed
    - 1)`` seeds its streams seed .. seed + 3: "params" (unused by the
    engine: the model starts at 0) draws u, "state" the links."""
    return (torch.arange(m, device=dev) / (10.0 * m))[:, None] + \
        0.1 * torch.randn(m, d, generator=gens["params"], device=dev)


def run_batch(algo_name, points, *, m, d, s, rounds, eta, seeds,
              device=None, use_kernel=None, u=None, draws=None):
    """Every ``(p0, p1)`` of ``points`` at every seed for one algorithm, as
    one batch of ``len(points) * len(seeds)`` trajectories through the
    engine (one round serves them all): each draws its seed's ``u`` and
    link uniforms. ``{(p0, p1): [run_one's list for each seed]}``. ``u``
    (one ``[m, d]`` a seed) and ``draws`` (for the whole batch) replace the
    seeded ones."""
    dev = resolve_device(device)
    gens = [seed_generators(sd - 1, dev) for sd in seeds]
    if u is None:
        u = [_draw_u(g, m, d, dev) for g in gens]
    index = [i for _ in points for i in range(len(seeds))]
    B = len(index)
    u = torch.stack([torch.as_tensor(x, dtype=torch.float32, device=dev)
                     for x in u])[index]
    x_star = u.mean(1)
    half = torch.arange(m, device=dev) < m // 2
    p = torch.stack([torch.where(half, p0, p1)
                     for p0, p1 in points for _ in seeds])
    fed = FederationConfig(algorithm=algo_name, num_clients=m, local_steps=s)
    algo = make_algorithm_spec((algo_name,), fed)
    link = make_link_process(p, fed)
    opt = sgd(eta)
    # each trajectory's own objective, [B, m, s, d] every round
    batches = {"u": u[:, :, None].expand(B, m, s, d)}
    source = DataSource(lambda data=None: (),
                        lambda ds_state, t, pick=None: (batches, ds_state),
                        "fixed")
    run_rounds = make_run_rounds(_loss, opt, algo, link, fed, source,
                                 use_kernel=resolve_use_kernel(use_kernel),
                                 device=dev)
    if draws is None:
        draws = GeneratorDraws(gens, index, num_clients=m)
    st = init_fed_state(draws.link_init(), torch.zeros(B, d, device=dev),
                        fed, algo, link, opt)
    ds_state = source.init()
    # 20 measurement points, as the reference's 20 scan chunks
    chunk = max(rounds // 20, 1)
    dists, t = [], 0
    while t < rounds:
        step = min(chunk, rounds - t)
        st, ds_state, _ = run_rounds(st, ds_state, draws, step)
        t += step
        dists.append((t, torch.linalg.norm(st.server - x_star,
                                           dim=-1).tolist()))
    rows = [[(t, v[b]) for t, v in dists] for b in range(B)]
    S = len(seeds)
    return {pt: rows[i * S:(i + 1) * S] for i, pt in enumerate(points)}


def run(csv=True, *, m=50, d=50, s=20, rounds=800, eta=5e-4, seeds=(0, 1, 2),
        device=None, use_kernel=None):
    if csv:
        print("fig3_quadratic,algo,p0,p1,round,dist_mean,dist_std")
    # one batch of every (point, seed) trajectory for each algorithm
    runs = {algo: run_batch(algo, POINTS, m=m, d=d, s=s, rounds=rounds,
                            eta=eta, seeds=seeds, device=device,
                            use_kernel=use_kernel)
            for algo in ("fedpbc", "fedavg")}
    out = {}
    for (p0, p1) in POINTS:
        for algo in ("fedpbc", "fedavg"):
            per_seed = runs[algo][(p0, p1)]
            rounds_axis = [r for r, _ in per_seed[0]]
            vals = np.array([[v for _, v in tr] for tr in per_seed])
            out[(algo, p0, p1)] = (rounds_axis, vals.mean(0), vals.std(0))
            if csv:
                for i, r in enumerate(rounds_axis):
                    print(f"fig3_quadratic,{algo},{p0},{p1},{r},"
                          f"{vals.mean(0)[i]:.5f},{vals.std(0)[i]:.5f}")
    # the paper's qualitative claim: FedPBC's final error under p0!=p1 is
    # close to the p0==p1 level; FedAvg's is far larger
    final = {k: v[1][-1] for k, v in out.items()}
    print(f"# fedpbc p!=p final {final[('fedpbc',0.9,0.1)]:.4f} vs "
          f"fedavg {final[('fedavg',0.9,0.1)]:.4f} "
          f"(uniform-p fedavg {final[('fedavg',0.5,0.5)]:.4f})")
    return final


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--paper-scale", action="store_true",
                    help="m=100, d=100, s=100, 2500 rounds, eta=1e-4")
    a = ap.parse_args()
    run(**(PAPER_SCALE if a.paper_scale else {}))

"""Round throughput: the multi-round engine vs per-round dispatch (port of
``benchmarks/throughput.py``).

Measures wall-clock for the reference's workload (m = 32 clients, the
synthetic 2-layer MLP, 200 rounds, bernoulli links, FedPBC) on two
execution paths sharing one round step (``make_round_step``) and one
``DataSource``:

- ``loop``: one Python call a round from the caller (``run_rounds_loop``
  with the shared step);
- ``scan``: the multi-round engine (``make_run_rounds``). In the
  reference that is one ``jax.lax.scan`` over all rounds. The port has no
  scan: its engine is a host loop over the same eager round, so the two
  paths do the same work and ``speedup`` is expected near 1 (measured, not
  asserted). The keys keep the reference's names (``scan_seconds``, ...)
  so the outputs compare; a graph replay of the round is ROADMAP item 12.

Both run from fresh states of one seed after a warm-up of each, so they
draw the same numbers through the same step: the two final losses must be
equal. With ``use_kernel`` the server update is one launch of the fused
aggregation a round. Prints a ``BENCH {...}`` JSON line and writes it to
``build/paper/throughput.json`` (or ``out_path``).
"""
from __future__ import annotations

import json
import os
import time

import torch

from repro_torch.configs import FederationConfig
from repro_torch.core import (
    GeneratorDraws,
    build_base_probs,
    init_fed_state,
    make_algorithm_spec,
    make_link_process,
    make_round_fn,
    make_round_step,
    make_run_rounds,
    run_rounds_loop,
)
from repro_torch.device import resolve_device
from repro_torch.experiments.sweep import seed_generators
from repro_torch.kernels.dispatch import resolve_use_kernel
from repro_torch.optim import paper_decay, sgd
from repro_torch.paper import OUT_DIR
from repro_torch.paper.common import backend_name, make_classification_task


def _setup(m, seed, device=None):
    dev = resolve_device(device)
    task = make_classification_task(data_seed=seed, num_clients=m,
                                    alpha=0.1, device=dev)
    fed = FederationConfig(algorithm="fedpbc", num_clients=m, local_steps=5)
    p, _, _ = build_base_probs(seed, m, 10)
    algo = make_algorithm_spec(("fedpbc",), fed)
    link = make_link_process(torch.as_tensor(p, device=dev)[None], fed)
    opt = sgd(paper_decay(0.1))
    source = task.source

    def init_states(seed):
        """``(state, ds_state, draws)`` fresh from the seed's generators."""
        draws = GeneratorDraws([seed_generators(seed, dev)], num_clients=m,
                               pick_spec=source.pick_spec)
        st = init_fed_state(draws.link_init(), draws.params(task.init_params),
                            fed, algo, link, opt)
        return st, source.init(), draws

    return fed, algo, link, opt, source, task, init_states


def _sync(st):
    if st.server.is_cuda:
        torch.cuda.synchronize(st.server.device)


def run(csv=True, *, rounds=200, m=32, seed=0, out_path=None, device=None,
        use_kernel=None):
    fed, algo, link, opt, source, task, init_states = _setup(m, seed, device)
    dev = resolve_device(device)
    uk = resolve_use_kernel(use_kernel)
    round_fn = make_round_fn(task.loss_fn, opt, algo, link, fed,
                             use_kernel=uk)
    # one step shared by warm-up and timed run (as the reference's one
    # jitted step)
    step = make_round_step(round_fn, source)
    run_rounds = make_run_rounds(task.loss_fn, opt, algo, link, fed, source,
                                 use_kernel=uk, device=dev)

    # warm up both paths on the measured shapes, then time fresh runs
    st, ds, draws = init_states(seed)
    run_rounds_loop(st, ds, draws, 2, step=step)
    st, ds, draws = init_states(seed)
    run_rounds(st, ds, draws, rounds)

    st, ds, draws = init_states(seed)
    _sync(st)
    t0 = time.perf_counter()
    st, ds, mets = run_rounds_loop(st, ds, draws, rounds, step=step)
    _sync(st)
    loop_s = time.perf_counter() - t0
    loop_loss = float(mets["loss"][0, -1])

    st, ds, draws = init_states(seed)
    _sync(st)
    t0 = time.perf_counter()
    st, ds, mets = run_rounds(st, ds, draws, rounds)
    _sync(st)
    scan_s = time.perf_counter() - t0
    scan_loss = float(mets["loss"][0, -1])
    if loop_loss != scan_loss:
        # RuntimeError, not assert: the check must survive `python -O`
        raise RuntimeError(
            f"the two paths' final losses differ: {loop_loss} vs "
            f"{scan_loss} (the same draws through the same step)")

    result = {
        "bench": "round_throughput",
        "m": m,
        "rounds": rounds,
        "local_steps": 5,
        "model": "mlp_32x64x10",
        "loop_seconds": round(loop_s, 4),
        "scan_seconds": round(scan_s, 4),
        "loop_rounds_per_s": round(rounds / loop_s, 2),
        "scan_rounds_per_s": round(rounds / scan_s, 2),
        "speedup": round(loop_s / scan_s, 2),
        "final_loss_loop": round(loop_loss, 6),
        "final_loss_scan": round(scan_loss, 6),
        "backend": backend_name(dev),
    }
    print("BENCH " + json.dumps(result), flush=True)
    if out_path is None:
        out_path = os.path.join(OUT_DIR, "throughput.json")
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(result, f, indent=2)
    return result


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=200)
    ap.add_argument("--clients", type=int, default=32)
    ap.add_argument("--device", default=None)
    ap.add_argument("--use-kernel", action="store_true")
    a = ap.parse_args()
    run(rounds=a.rounds, m=a.clients, device=a.device,
        use_kernel=a.use_kernel or None)

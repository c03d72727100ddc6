"""Batched experiment runner (trajectory axis) + the sweep CLI (port of
``repro.experiments.sweep``).

One (algorithm family, link scheme) grid cell is B = algos x points x seeds
trajectories. ``make_batched_run_rounds`` runs the whole pipeline

    init params -> init_fed_state -> K rounds -> periodic eval

over that one leading batch axis: every tensor carries ``[B]``, so a round
is one pass of batched kernels for all B trajectories (the reference's
``vmap``). What varies within a cell is data in a ``CellBatch``:

- ``gens``/``gen_index`` per-seed ``torch.Generator`` bundles (the
  reference's per-seed key bundles) and the trajectory -> bundle map;
- ``p_base``  per-trajectory Eq.-9 connection probabilities ``[B, m]``;
- ``hparams`` per-trajectory ``[B]`` tensors (``lr``, ``gamma``,
  ``period``) that the factories consume;
- ``data``    per-trajectory ``ds_state`` (the partition ``idx [B, m, pc]``);
- ``shared``  the dataset, one copy for every trajectory;
- ``algo_id`` per-trajectory algorithm index ``[B]`` into an
  ``AlgorithmSpec`` family table (None: no algorithm axis).

CLI::

    python -m repro_torch.experiments.sweep --device cuda \\
        --algos fedpbc,fedavg --schemes bernoulli_tv --seeds 0,1,2 \\
        --rounds 100 --clients 100 --lrs 0.05,0.1 --out build/sweeps

(``python -m repro_torch.experiments`` is the same CLI.)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.configs import FederationConfig
from repro_torch.core.algorithms import AlgorithmSpec, as_algorithm
from repro_torch.core.federated import (
    DEFAULT_METRIC_KEYS,
    GeneratorDraws,
    init_fed_state,
    make_round_fn,
    make_round_step,
    run_rounds_loop,
)
from repro_torch.device import resolve_device


def seed_generators(seed: int, device=None) -> Dict[str, torch.Generator]:
    """The per-seed generator bundle, seeded like the reference's key bundle
    (params=seed+1, state=seed+2, ds=seed+3, data=seed+4). Same seed, same
    streams; the numbers differ from ``jax.random``'s."""
    dev = torch.device("cpu" if device is None else device)
    out = {}
    for i, name in enumerate(("params", "state", "ds", "data"), start=1):
        g = torch.Generator(device=dev)
        g.manual_seed(seed + i)
        out[name] = g
    return out


@dataclass
class CellBatch:
    """Everything one (algorithm-family, scheme) cell consumes; tensors carry
    a leading ``[B]`` (B = algos x points x seeds) except ``shared``."""

    gens: List[Dict[str, torch.Generator]]   # one bundle per seed
    gen_index: List[int]                      # [B] trajectory -> bundle
    p_base: torch.Tensor                      # [B, m]
    hparams: Dict[str, torch.Tensor]          # [B] each (lr, gamma, period)
    data: Any                                 # per-trajectory ds_state
    shared: Any                               # the dataset, unbatched
    algo_id: Optional[torch.Tensor] = None    # [B] int64, or None (no axis)

    @property
    def batch_size(self) -> int:
        return self.p_base.shape[0]


def make_batched_run_rounds(loss_fn: Callable, algorithm,
                            fed_cfg: FederationConfig, *,
                            optimizer_factory: Callable,
                            link_factory: Callable,
                            source_factory: Callable,
                            init_params: Callable,
                            num_rounds: int,
                            eval_every: int = 0,
                            eval_fn: Optional[Callable] = None,
                            metric_keys=DEFAULT_METRIC_KEYS,
                            use_kernel: bool = False,
                            cohort_size: Optional[int] = None,
                            buffered: bool = False,
                            shard_mesh=None,
                            carry_out: bool = False,
                            device=None):
    """Build the B-trajectory runner for one grid cell.

    Args mirror the reference: ``optimizer_factory(hparams)``,
    ``link_factory(p_base [B, m], hparams)``, ``source_factory(shared)``,
    ``init_params(generator) -> [n]``; ``eval_fn(server [B, n], shared) ->
    [B]`` runs every ``eval_every`` rounds under the contract "always at
    least one eval, the last at round K" (``eval_rounds``). ``use_kernel``
    routes a fusable family's server aggregation through the fused kernel:
    one launch per round for the whole batch. ``device=None`` is the card.

    Returns ``run(batch, draws=None) -> (states, out)``: ``states`` the final
    ``FedState`` (leading ``[B]``), ``out["metrics"]`` each key ``[B, K,
    ...]``, ``out["evals"]`` ``[B, E]``. ``draws`` replaces the batch's
    ``GeneratorDraws`` (anything with its ``params``/``link_init``/call).
    """
    if cohort_size is not None or buffered:
        raise NotImplementedError(
            "cohort/buffered sweeps are not ported yet (ROADMAP Queue 1 "
            "item 3: cross-device scale)")
    if shard_mesh is not None:
        raise NotImplementedError(
            "meshes are not ported yet (ROADMAP Queue 1 item 6: "
            "multi-device batch split)")
    if carry_out:
        raise NotImplementedError(
            "carry_out segments are not ported yet (ROADMAP Queue 1 item 4: "
            "adaptive search)")
    dev = resolve_device(device)
    do_eval = eval_fn is not None and eval_every > 0
    # round spans between evals: the eval_rounds contract (>= 1 eval, the
    # last at num_rounds; num_rounds == 0 evals the initial model)
    spans = [num_rounds]
    if do_eval:
        at = eval_rounds(num_rounds, eval_every)
        spans = [b - a for a, b in zip([0] + at[:-1], at)]

    def run(batch: CellBatch, draws=None):
        if batch.p_base.device.type != dev.type:
            raise ValueError(f"batch is on {batch.p_base.device}, the runner "
                             f"on {dev}")
        algo_id = 0 if batch.algo_id is None else batch.algo_id
        algo = as_algorithm(algorithm, algo_id, use_kernel=use_kernel)
        optimizer = optimizer_factory(batch.hparams)
        link = link_factory(batch.p_base, batch.hparams)
        source = source_factory(batch.shared)
        if draws is None:
            draws = GeneratorDraws(batch.gens, batch.gen_index,
                                   num_clients=fed_cfg.num_clients,
                                   pick_spec=source.pick_spec)
        with torch.no_grad():
            server = draws.params(init_params)
            st = init_fed_state(draws.link_init(), server, fed_cfg, algo,
                                link, optimizer)
            ds = source.init(batch.data)
            step = make_round_step(
                make_round_fn(loss_fn, optimizer, algo, link, fed_cfg), source)
            parts, evals = [], []
            for span in spans:
                st, ds, mets = run_rounds_loop(st, ds, draws, span, step=step,
                                               metric_keys=metric_keys)
                parts.append(mets)
                if do_eval:
                    evals.append(eval_fn(st.server, batch.shared))
        out = {"metrics": {k: torch.cat([m[k] for m in parts], 1)
                           for k in metric_keys}}
        if do_eval:
            out["evals"] = torch.stack(evals, 1)
        return st, out

    return run


def eval_rounds(num_rounds: int, eval_every: int):
    """Round indices (1-based) at which the runner's evals fire: at least
    one, the last at ``num_rounds`` (``num_rounds == 0`` evals the initial
    model once); ``eval_every <= 0`` means one eval at the final round."""
    if eval_every <= 0:
        return [num_rounds]
    n_chunks, rem = divmod(num_rounds, eval_every)
    out = [eval_every * (i + 1) for i in range(n_chunks)]
    if rem or not out:
        out.append(num_rounds)
    return out


def _float_list(text: str):
    return tuple(float(v) for v in text.split(",")) if text else ()


def main(argv=None) -> None:
    import argparse
    import time

    # lazy: grid imports this module
    from repro_torch.experiments.grid import ALGOS, SCHEMES, SweepSpec, run_sweep
    from repro_torch.experiments.results import ResultsStore

    ap = argparse.ArgumentParser(
        description="Run a (algorithm x scheme x hyperparameter x seed) "
                    "sweep on the PyTorch port; every state-compatible "
                    "group of --algos, with every point of the "
                    "--lrs/--gammas/--alphas/--sigma0s/--deltas axes, runs "
                    "as one batch of trajectories per scheme. With --out "
                    "the rows are appended to a JSONL/npz results store.")
    ap.add_argument("--algos", default="fedpbc,fedavg",
                    help=f"comma list from {','.join(ALGOS)}")
    ap.add_argument("--schemes", default="bernoulli_ti",
                    help=f"comma list from {','.join(SCHEMES)}")
    ap.add_argument("--seeds", default="0,1,2", help="comma list of ints")
    ap.add_argument("--rounds", type=int, default=100)
    ap.add_argument("--eval-every", type=int, default=25)
    ap.add_argument("--clients", type=int, default=100)
    ap.add_argument("--local-steps", type=int, default=5)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--alpha", type=float, default=0.1)
    ap.add_argument("--gamma", type=float, default=0.5)
    ap.add_argument("--delta", type=float, default=0.02)
    ap.add_argument("--sigma0", type=float, default=10.0)
    ap.add_argument("--lrs", default="", help="comma list; hyperparameter "
                    "axis overriding --lr (one batch, no rebuild)")
    ap.add_argument("--gammas", default="", help="axis overriding --gamma")
    ap.add_argument("--alphas", default="", help="axis overriding --alpha")
    ap.add_argument("--sigma0s", default="", help="axis overriding --sigma0")
    ap.add_argument("--deltas", default="", help="axis overriding --delta")
    ap.add_argument("--out", default=None,
                    help="results-store directory (JSONL + npz) to append "
                    "the rows to (default: print only)")
    ap.add_argument("--suite", default="cli", help="suite tag on the records")
    ap.add_argument("--use-kernel", action="store_true",
                    help="server update through the fused Triton kernel")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without it)")
    args = ap.parse_args(argv)

    spec = SweepSpec(
        algorithms=tuple(args.algos.split(",")),
        schemes=tuple(args.schemes.split(",")),
        seeds=tuple(int(s) for s in args.seeds.split(",")),
        rounds=args.rounds, eval_every=args.eval_every,
        num_clients=args.clients, local_steps=args.local_steps,
        lr=args.lr, alpha=args.alpha, gamma=args.gamma, delta=args.delta,
        sigma0=args.sigma0,
        lrs=_float_list(args.lrs), gammas=_float_list(args.gammas),
        alphas=_float_list(args.alphas), sigma0s=_float_list(args.sigma0s),
        deltas=_float_list(args.deltas),
        use_kernel=args.use_kernel or None)
    store = ResultsStore(args.out) if args.out else None
    print("sweep,scheme,algo,strategy,hparams,seeds,test_acc_mean,"
          "test_acc_ci95,train_acc_mean", flush=True)
    t0 = time.perf_counter()
    for cell in run_sweep(spec, store=store, suite=args.suite,
                          device=args.device):
        s = cell.summary()
        hp = ";".join(f"{k}={v:g}" for k, v in sorted(cell.hparams.items()))
        print(f"sweep,{cell.scheme},{cell.algo},{cell.strategy},{hp},"
              f"{len(cell.seeds)},"
              f"{s['test_acc']['mean']:.4f},{s['test_acc']['ci95']:.4f},"
              f"{s['train_acc']['mean']:.4f}", flush=True)
    print(f"# {time.perf_counter() - t0:.3f} s", flush=True)
    if store is not None:
        print(f"# results appended to {store.path}", flush=True)


if __name__ == "__main__":
    main()

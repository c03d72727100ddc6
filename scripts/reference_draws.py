"""Run the PyTorch port on the JAX reference's own random draws.

The port draws other numbers than the reference (torch generators, a numpy
``p_base``), so its Table-1 accuracies match the reference only within the
seed spread. This script removes that difference, in two steps:

``dump`` (on the CPU, needs JAX and the reference package) writes, for seeds
0-2 of the Table-1 protocol, the reference's initial MLP parameters, its
Eq.-9 ``p_base``, and every round's link uniforms and batch indices, all
computed with ``jax.random`` from the reference's own per-seed keys, to one
``.npz`` (~9 MB compressed)::

    PYTHONPATH=src python scripts/reference_draws.py dump --out build/ref_draws.npz

``run`` (on the card, needs only torch and the port) runs the port's
batched Table-1 family cell (fedpbc / fedavg / fedavg_all / fedavg_known_p
on bernoulli_tv, 250 rounds, evals every 25, m = 100, ``use_kernel=True``)
on those draws and prints each trajectory's final test accuracy (the mean
of the last three evals, as ``CellResult.final_test``) as one JSON line::

    python3 scripts/reference_draws.py run --draws build/ref_draws.npz

``scripts/table1_reference_bars.py`` prints the reference's values for the
same trajectories.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

FAMILY = ("fedpbc", "fedavg", "fedavg_all", "fedavg_known_p")
SEEDS = (0, 1, 2)
ROUNDS, EVAL_EVERY, M = 250, 25, 100
LOCAL_STEPS, BATCH, PER_CLIENT = 5, 32, 64


def dump(out: str) -> None:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import numpy as np

    from repro.core.connectivity import build_base_probs
    from repro.experiments.sweep import seed_keys
    from repro.experiments.tasks import mlp_init

    def per_seed(keys):
        params = mlp_init(keys["params"])
        flat = np.concatenate([np.asarray(params[k]).ravel()
                               for k in ("w1", "b1", "w2", "b2")])
        # init_fed_state: (k_link, k_state) = split(state key); each round
        # splits the carried key, the second half drives the link
        k_link, key = jax.random.split(keys["state"])
        link_init = np.asarray(jax.random.uniform(k_link, (M,)))

        def step(key, _):
            key, k_round = jax.random.split(key)
            return key, jax.random.uniform(k_round, (M,))

        _, u = jax.lax.scan(step, key, None, length=ROUNDS)
        pick = jax.vmap(lambda t: jax.random.randint(
            jax.random.fold_in(keys["data"], t), (M, LOCAL_STEPS, BATCH), 0,
            PER_CLIENT))(np.arange(ROUNDS, dtype=np.int32))
        return flat, link_init, np.asarray(u), np.asarray(pick, np.int8)

    parts = [per_seed(seed_keys(s)) for s in SEEDS]
    p_base = np.stack([np.asarray(build_base_probs(
        jax.random.PRNGKey(s), M, 10, alpha=0.1, sigma0=10.0,
        delta=0.02)[0]) for s in SEEDS])
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    np.savez_compressed(out, seeds=np.asarray(SEEDS), p_base=p_base,
                        params=np.stack([p[0] for p in parts]),
                        link_init=np.stack([p[1] for p in parts]),
                        u=np.stack([p[2] for p in parts]),
                        pick=np.stack([p[3] for p in parts]))
    print(f"wrote {out}")


class ArrayDraws:
    """The port's drawer interface fed from arrays: trajectory ``b`` uses
    seed row ``index[b]``."""

    def __init__(self, data, index, device):
        import torch

        self.index = torch.as_tensor(index, device=device)
        t = {k: torch.as_tensor(data[k], device=device)
             for k in ("params", "link_init", "u", "pick")}
        self._t = t

    def params(self, init_params):
        return self._t["params"][self.index]

    def link_init(self):
        return self._t["link_init"][self.index]

    def __call__(self, t):
        from repro_torch.core.federated import RoundDraws

        return RoundDraws(self._t["u"][self.index, t],
                          self._t["pick"][self.index, t].long())


def run(path: str, device=None) -> None:
    import numpy as np
    import torch

    from repro_torch.experiments import grid

    data = np.load(path)
    spec = grid.SweepSpec(algorithms=FAMILY, schemes=("bernoulli_tv",),
                          seeds=SEEDS, rounds=ROUNDS, eval_every=EVAL_EVERY,
                          num_clients=M, use_kernel=True)
    task = grid.get_traced_task(spec, device)
    fed = spec.cell_config(FAMILY[0], "bernoulli_tv")
    batch = grid.make_cell_batch(spec, fed, task, algos=FAMILY, device=device)
    dev = batch.p_base.device
    batch.p_base = torch.as_tensor(data["p_base"], device=dev)[
        torch.as_tensor(batch.gen_index, device=dev)]
    draws = ArrayDraws(data, batch.gen_index, dev)
    _, out = grid.make_runner(spec, fed, task, device=device)(batch,
                                                              draws=draws)
    final = out["evals"][:, -3:].mean(1).cpu().numpy()
    S = len(SEEDS)
    print(json.dumps({
        "device": (torch.cuda.get_device_name(0) if dev.type == "cuda"
                   else "cpu"),
        "final_test_acc": {a: {"per_seed": final[i * S:(i + 1) * S].tolist(),
                               "mean": float(final[i * S:(i + 1) * S].mean())}
                           for i, a in enumerate(FAMILY)}}))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("dump")
    d.add_argument("--out", default="build/ref_draws.npz")
    r = sub.add_parser("run")
    r.add_argument("--draws", default="build/ref_draws.npz")
    r.add_argument("--device", default=None,
                   help="torch device (default: cuda; raises without it)")
    args = ap.parse_args(argv)
    if args.cmd == "dump":
        dump(args.out)
    else:
        run(args.draws, args.device)


if __name__ == "__main__":
    main()

"""Sweep throughput: the batched runner against its sequential and
per-value baselines, on four axes (port of
``benchmarks/sweep_throughput.py``).

1. **Seed axis**: one (fedpbc, bernoulli_ti) cell at m = 32 over S = 8
   seeds. ``sequential``: S per-seed runs through ``make_run_rounds`` with
   fresh closures each (data source, link, round function) on the
   engine's protocol (the shared ``data_seed=0`` dataset and partition,
   each seed's generator bundle, its Eq.-9 ``p_base`` from
   ``seed_base_probs``); ``vmapped``: ``run_cell``, all S seeds as one
   batch, cold and warm. The arms' evals must agree.
2. **Hyperparameter axis**: an lr x alpha grid x S seeds of the same cell.
   ``per-value``: one seed-axis runner (``make_vmap_run_rounds``) per point
   with the lr fixed in its optimizer and the constant task rebuilt per
   alpha; ``traced``: one runner over every (lr, alpha, seed) trajectory as
   one batch, run at the grid and then at entirely different values. The
   arms' evals must agree.
3. **Algorithm axis**: the fedpbc / fedavg / fedavg_all / fedavg_known_p
   family as one batch (the ``algo_id`` column picks each trajectory's
   rule) against one runner per algorithm; the arms' states and outputs
   must agree.
4. **Device axis**: one batched cell on one device against the same cell
   split over every visible card (``resolve_batch_mesh``, ``pad_batch``,
   ``shard_batch``, one worker process a card:
   ``repro_torch.experiments.shard``), which must agree bit for bit. With
   one device visible the entry records the reference's single-device
   note.

The reference's compile counts read XLA's jit caches (``_cache_entries``).
The eager port compiles nothing; under the same keys it reports the
runners each arm built: the traced ablation 1 for both grids against one
per point, the family 1 against 4 per algorithm. So the reference's ``>=
2`` speedup bars, which describe XLA compiles, are not carried over: the
speedups are measured and reported. The agreement checks are: bit for bit
where the port gives it, else within 1e-5 (``chip_smoke.py`` phase 3's
bar), raised as ``RuntimeError`` naming the arm and the parts over it;
a part that is not bit for bit is printed with its difference. On the CPU
every state and eval is bit for bit; at some sizes the per-round loss
metric of the family batch differs from the per-algorithm runs' by an ulp
(the cross entropy's log-softmax and means over another batch count),
while the parameters it trains stay equal.

The figure of merit is cells/s, a cell being one trajectory of ``rounds``
rounds. With ``use_kernel`` the family's server update is one launch of
the fused aggregation a round over the whole ``[B, m, n]`` batch (the
kernel's 3-D route). Prints a ``BENCH {...}`` JSON line and writes
``build/paper/sweep_throughput.json`` (or ``out_path``).
"""
from __future__ import annotations

import dataclasses
import json
import os

import torch

from repro_torch.core import (
    GeneratorDraws,
    init_fed_state,
    make_algorithm_spec,
    make_link_process,
    make_run_rounds,
)
from repro_torch.core.algorithms import algo_family
from repro_torch.device import resolve_device
from repro_torch.experiments import (
    SweepSpec,
    make_batched_run_rounds,
    make_classification_task,
    make_vmap_run_rounds,
    run_cell,
    seed_generators,
)
from repro_torch.experiments.grid import (
    get_task,
    get_traced_task,
    make_cell_batch,
    make_runner,
    point_base_probs,
    seed_base_probs,
)
from repro_torch.experiments.shard import (
    commit,
    pad_batch,
    resolve_batch_mesh,
    run_committed,
)
from repro_torch.kernels.dispatch import resolve_use_kernel
from repro_torch.optim import paper_decay, sgd
from repro_torch.paper import OUT_DIR
from repro_torch.paper.common import (
    backend_name,
    timed,
    tree_max_abs_diff,
    warm_timed,
)

AGREE_TOL = 1e-5
METRIC_KEYS = ("loss", "num_active")


def _agree(diffs: dict, what: str) -> float:
    """The largest of two arms' differences by part (``{"server": ...,
    "evals": ...}``); raises where one is beyond ``AGREE_TOL``
    (RuntimeError, not assert: the check must survive ``python -O``) and
    names the parts that are not bit for bit."""
    worst = max(diffs.values())
    if not worst <= AGREE_TOL:
        raise RuntimeError(f"{what} trajectories diverged: {diffs}")
    if worst:
        print(f"# sweep: {what} not bit for bit in "
              f"{ {k: v for k, v in diffs.items() if v} } (tol "
              f"{AGREE_TOL:g})", flush=True)
    return worst


def _sequential_seed_arm(spec: SweepSpec, lr: float, dev):
    """S per-seed runs on the engine's protocol (the shared dataset, each
    seed's generators and ``p_base``) with fresh closures a seed. Returns
    ``evals [S, E]``."""
    task = get_task(spec, dev)
    fed = spec.cell_config("fedpbc", "bernoulli_ti")
    p_base = seed_base_probs(spec)
    uk = resolve_use_kernel(spec.use_kernel)
    evals = []
    for i, seed in enumerate(spec.seeds):
        algo = make_algorithm_spec(("fedpbc",), fed)     # fresh closures
        opt = sgd(paper_decay(lr))
        link = make_link_process(torch.as_tensor(p_base[i:i + 1],
                                                 device=dev), fed)
        run_rounds = make_run_rounds(task.loss_fn, opt, algo, link, fed,
                                     task.source, use_kernel=uk, device=dev)
        draws = GeneratorDraws([seed_generators(seed, dev)],
                               num_clients=spec.num_clients,
                               pick_spec=task.source.pick_spec)
        st = init_fed_state(draws.link_init(),
                            draws.params(task.init_params), fed, algo,
                            link, opt)
        ds = task.source.init()
        seed_evals, t = [], 0
        while t < spec.rounds:
            chunk = min(spec.eval_every, spec.rounds - t)
            st, ds, _ = run_rounds(st, ds, draws, chunk)
            t += chunk
            seed_evals.append(task.eval_test(st.server)[0])
        evals.append(torch.stack(seed_evals))
    return torch.stack(evals)


def _per_value_arm(spec: SweepSpec, points, dev):
    """One seed-axis runner per hyperparameter point: the lr fixed in the
    optimizer and the constant task rebuilt per distinct alpha. Returns
    ``(evals [P, S, E], runners built)``."""
    fed = spec.cell_config("fedpbc", "bernoulli_ti")
    uk = resolve_use_kernel(spec.use_kernel)
    evals, tasks = [], {}
    for pt in points:
        if pt["alpha"] not in tasks:
            tasks[pt["alpha"]] = make_classification_task(
                data_seed=spec.data_seed, num_clients=spec.num_clients,
                dim=spec.dim, classes=spec.classes, hidden=spec.hidden,
                n_per_class=spec.n_per_class, n_train=spec.n_train,
                alpha=pt["alpha"], per_client=spec.per_client,
                local_steps=spec.local_steps, batch_size=spec.batch_size,
                device=dev)
        task = tasks[pt["alpha"]]
        runner = make_vmap_run_rounds(
            task.loss_fn, sgd(paper_decay(pt["lr"])),
            make_algorithm_spec(("fedpbc",), fed), fed, task.source,
            link_factory=lambda p: make_link_process(p, fed),
            init_params=task.init_params, num_rounds=spec.rounds,
            eval_every=spec.eval_every, eval_fn=task.eval_test,
            use_kernel=uk, device=dev)
        gens = [seed_generators(s, dev) for s in spec.seeds]
        _, out = runner(gens, point_base_probs(spec, pt))
        evals.append(out["evals"])
    return torch.stack(evals), len(points)


def _algo_axis_arm(spec: SweepSpec, dev):
    """The fedavg family two ways: one batch over the joint (algo x point x
    seed) axis through one runner, and one runner per algorithm. Returns
    the ``algo_axis`` BENCH sub-dict."""
    family = algo_family("fedavg")
    task = get_traced_task(spec, dev)
    fed = spec.cell_config(family[0], "bernoulli_ti")
    uk = resolve_use_kernel(spec.use_kernel)

    def _make_runner(algorithm, cfg):
        return make_batched_run_rounds(
            task.loss_fn, algorithm, cfg,
            optimizer_factory=lambda hp: sgd(paper_decay(hp["lr"])),
            link_factory=lambda p, hp: make_link_process(
                p, cfg, gamma=hp["gamma"], period=hp["period"]),
            source_factory=task.source_factory,
            init_params=task.init_params,
            num_rounds=spec.rounds, eval_every=spec.eval_every,
            eval_fn=task.eval_test, metric_keys=METRIC_KEYS,
            use_kernel=uk, device=dev)

    fam_runner = _make_runner(make_algorithm_spec(family, fed), fed)
    fam_batch = make_cell_batch(spec, fed, task, algos=family, device=dev)
    B = fam_batch.batch_size
    fam_cold_s, fam_out = timed(lambda: fam_runner(fam_batch), dev)
    fam_warm_s, _ = timed(lambda: fam_runner(fam_batch), dev)

    per_cold_s = per_warm_s = 0.0
    per_outs = []
    for algo in family:
        fed_a = spec.cell_config(algo, "bernoulli_ti")
        runner_a = _make_runner(make_algorithm_spec((algo,), fed_a), fed_a)
        batch_a = dataclasses.replace(
            make_cell_batch(spec, fed_a, task, device=dev), algo_id=None)
        cold, out_a = timed(lambda: runner_a(batch_a), dev)
        warm, _ = timed(lambda: runner_a(batch_a), dev)
        per_cold_s += cold
        per_warm_s += warm
        per_outs.append(out_a)

    def parts(st, out):
        return {"server": st.server, "clients": st.clients,
                "last_active": st.last_active, **out["metrics"],
                "evals": out["evals"]}

    got = parts(*fam_out)
    ref = [parts(*o) for o in per_outs]
    diff = _agree({k: tree_max_abs_diff(got[k], torch.cat([r[k] for r in ref]))
                   for k in got}, "family-batched and per-algorithm")
    return {
        "family": list(family),
        "n_algos": len(family),
        "n_points": len(spec.hparam_points()),
        "n_seeds": len(spec.seeds),
        "rounds": spec.rounds,
        "n_cells": B,
        "batched_seconds_cold": round(fam_cold_s, 4),
        "batched_seconds_warm": round(fam_warm_s, 4),
        "per_algo_seconds_cold": round(per_cold_s, 4),
        "per_algo_seconds_warm": round(per_warm_s, 4),
        "batched_cold_cells_per_s": round(B / fam_cold_s, 4),
        "batched_cells_per_s": round(B / fam_warm_s, 4),
        "per_algo_cold_cells_per_s": round(B / per_cold_s, 4),
        "per_algo_cells_per_s": round(B / per_warm_s, 4),
        # runners built: one for the whole family against one per algorithm
        "batched_compile_programs": 1,
        "per_algo_compile_programs": len(family),
        "trajectory_max_abs_diff": diff,
        "speedup_cold": round(per_cold_s / fam_cold_s, 2),
        "speedup_warm": round(per_warm_s / fam_warm_s, 2),
    }


def _device_scaling_arm(spec: SweepSpec, dev,
                        scaling_lrs=(0.03, 0.05, 0.1, 0.2)):
    """One device against the cell split over every visible card (B =
    len(scaling_lrs) x S trajectories, padded to the card count), warm.
    Returns the ``device_scaling`` BENCH sub-dict."""
    n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
    spec = dataclasses.replace(spec, lrs=tuple(scaling_lrs))
    task = get_traced_task(spec, dev)
    fed = spec.cell_config("fedpbc", "bernoulli_ti")
    runner = make_runner(spec, fed, task, metric_keys=METRIC_KEYS,
                         device=dev)
    batch = make_cell_batch(spec, fed, task, device=dev)
    B = batch.batch_size

    single_s, ref = warm_timed(lambda: runner(batch), dev)
    entry = {
        "n_devices": n_dev,
        "batch": B,
        "rounds": spec.rounds,
        "padded_batch": B + (-B) % n_dev,
        "single_device_seconds": round(single_s, 4),
        "single_device_cells_per_s": round(B / single_s, 4),
    }
    if n_dev < 2:
        entry["note"] = ("single device visible; rerun under XLA_FLAGS="
                         "--xla_force_host_platform_device_count=8 (CPU) or "
                         "on a multi-device backend for the sharded arm")
        return entry

    # pad and slice the batch (shard_batch) and send the slices to the
    # workers ONCE outside the timed region, as the sweep's batch cache does
    mesh = resolve_batch_mesh()
    padded, b_real = pad_batch(batch, mesh.shape["batch"])
    committed = commit(padded, mesh, ("device_scaling", id(batch)), b_real)
    sharded_s, sh = warm_timed(lambda: run_committed(
        runner, committed, mesh, period=fed.period, device=dev), dev)
    diff = tree_max_abs_diff(ref, sh)
    # a placement change must not change a single trajectory
    if diff != 0.0:
        raise RuntimeError(
            f"sharded and single-device trajectories diverged: {diff}")
    entry.update({
        "sharded_seconds": round(sharded_s, 4),
        "sharded_cells_per_s": round(B / sharded_s, 4),
        "speedup": round(single_s / sharded_s, 2),
        "trajectory_max_abs_diff": diff,
    })
    return entry


def run(csv=True, *, rounds=100, m=32, n_seeds=8, seed0=0, out_path=None,
        ablation_lrs=(0.03, 0.05, 0.1, 0.2), ablation_alphas=(0.1, 1.0),
        ablation_seeds=4, ablation_rounds=None, device=None,
        use_kernel=None):
    dev = resolve_device(device)
    seeds = tuple(range(seed0, seed0 + n_seeds))
    spec = SweepSpec(algorithms=("fedpbc",), schemes=("bernoulli_ti",),
                     seeds=seeds, rounds=rounds, eval_every=min(25, rounds),
                     num_clients=m, use_kernel=use_kernel)

    # --- seed axis: the batched runner, cold then warm
    vmap_cold_s, cell = timed(lambda: run_cell(
        spec, "fedpbc", "bernoulli_ti", mesh=None, device=dev), dev)
    vmap_warm_s, cell = timed(lambda: run_cell(
        spec, "fedpbc", "bernoulli_ti", mesh=None, device=dev), dev)

    # --- seed axis: the sequential baseline on the same protocol
    seq_s, seq_evals = timed(lambda: _sequential_seed_arm(spec, spec.lr,
                                                           dev), dev)
    traj_diff = _agree({"evals": tree_max_abs_diff(
        seq_evals.cpu(), torch.as_tensor(cell.test_acc))},
        "sequential and batched")

    # --- hyperparameter axis: lr x alpha grid, traced vs per-value
    ab_seeds = tuple(range(seed0, seed0 + ablation_seeds))
    ab_rounds = ablation_rounds or max(rounds // 3, 20)
    ab_spec = dataclasses.replace(
        spec, seeds=ab_seeds, rounds=ab_rounds,
        eval_every=min(25, ab_rounds), lrs=tuple(ablation_lrs),
        alphas=tuple(ablation_alphas))
    points = ab_spec.hparam_points()
    n_cells = len(points) * ablation_seeds
    ab_task = get_traced_task(ab_spec, dev)
    ab_fed = ab_spec.cell_config("fedpbc", "bernoulli_ti")

    traced_runner = make_runner(ab_spec, ab_fed, ab_task,
                                metric_keys=METRIC_KEYS, device=dev)

    def traced(s):
        return traced_runner(make_cell_batch(s, ab_fed, ab_task, device=dev))

    traced_cold_s, (_, ab_out) = timed(lambda: traced(ab_spec), dev)
    # the same runner at entirely different values of the same grid shape
    new_spec = dataclasses.replace(
        ab_spec, lrs=tuple(lr * 1.3 for lr in ablation_lrs),
        alphas=tuple(a * 3.0 for a in ablation_alphas))
    traced_new_values_s, _ = timed(lambda: traced(new_spec), dev)

    baseline_s, (baked_evals, baseline_runners) = timed(
        lambda: _per_value_arm(ab_spec, points, dev), dev)
    traced_evals = ab_out["evals"].reshape(baked_evals.shape)
    ab_diff = _agree({"evals": tree_max_abs_diff(baked_evals, traced_evals)},
                     "traced-lr and baked-lr")

    # --- algorithm axis: the fedavg family as one batch vs one per algo
    algo_axis = _algo_axis_arm(
        dataclasses.replace(spec, seeds=ab_seeds, rounds=ab_rounds,
                            eval_every=min(25, ab_rounds)), dev)

    # --- device axis: the same batch on one device vs split over cards
    device_scaling = _device_scaling_arm(
        dataclasses.replace(spec, seeds=ab_seeds, rounds=ab_rounds,
                            eval_every=min(25, ab_rounds)), dev,
        scaling_lrs=tuple(ablation_lrs))

    seq_cps = n_seeds / seq_s
    vmap_cps = n_seeds / vmap_warm_s
    result = {
        "bench": "sweep_throughput",
        "m": m,
        "rounds": rounds,
        "n_seeds": n_seeds,
        "local_steps": 5,
        "model": "mlp_32x64x10",
        "sequential_seconds": round(seq_s, 4),
        "vmapped_cold_seconds": round(vmap_cold_s, 4),
        "vmapped_warm_seconds": round(vmap_warm_s, 4),
        "sequential_cells_per_s": round(seq_cps, 4),
        "vmapped_cells_per_s": round(vmap_cps, 4),
        "vmapped_cold_cells_per_s": round(n_seeds / vmap_cold_s, 4),
        "speedup": round(vmap_cps / seq_cps, 2),
        "speedup_cold": round((n_seeds / vmap_cold_s) / seq_cps, 2),
        # both arms share one data protocol; their trajectories must agree
        "final_test_acc": round(float(cell.test_acc[:, -1].mean()), 4),
        "trajectory_max_abs_diff": traj_diff,
        "hparam_ablation": {
            "lrs": list(ablation_lrs),
            "alphas": list(ablation_alphas),
            "n_points": len(points),
            "n_seeds": ablation_seeds,
            "rounds": ab_rounds,
            "n_cells": n_cells,
            "traced_cold_seconds": round(traced_cold_s, 4),
            "traced_new_values_seconds": round(traced_new_values_s, 4),
            "per_value_recompile_seconds": round(baseline_s, 4),
            "traced_cells_per_s": round(n_cells / traced_new_values_s, 4),
            "traced_cold_cells_per_s": round(n_cells / traced_cold_s, 4),
            "per_value_cells_per_s": round(n_cells / baseline_s, 4),
            # runners built: one for both traced grids against one per
            # point (the reference counts jit cache entries here)
            "traced_compile_entries": 1,
            "per_value_compile_entries": baseline_runners,
            "trajectory_max_abs_diff": ab_diff,
            "speedup": round(baseline_s / traced_new_values_s, 2),
            "speedup_first_run": round(baseline_s / traced_cold_s, 2),
        },
        "algo_axis": algo_axis,
        "device_scaling": device_scaling,
        "backend": backend_name(dev),
    }
    print("BENCH " + json.dumps(result), flush=True)
    if out_path is None:
        out_path = os.path.join(OUT_DIR, "sweep_throughput.json")
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(result, f, indent=2)
    return result


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=100)
    ap.add_argument("--clients", type=int, default=32)
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--device", default=None)
    ap.add_argument("--use-kernel", action="store_true")
    a = ap.parse_args()
    run(rounds=a.rounds, m=a.clients, n_seeds=a.seeds, device=a.device,
        use_kernel=a.use_kernel or None)

"""LM-sweep throughput: the federated LM family on a 2-D ("batch",
"model") mesh against the same batch on one device, with its roofline
(port of ``benchmarks/lm_sweep.py``).

The workload: a smollm-class reduced transformer as the client model, the
fedpbc / fedavg / fedavg_all / fedavg_known_p family x swept lrs as one
batch through one runner (the lr and the algorithm are per-trajectory
columns), the (point x seed) trajectories split over ``"batch"`` and each
trajectory's clients over ``"model"``
(``repro_torch.experiments.shard.run_sharded_2d``: one worker process a
rank). Two arms, each timed warm on one device and then on the mesh:

- ``lm_family``: the family sweep, with the largest per-trajectory
  deviation of the mesh from one device (states and evals at 1e-6, the
  loss metric at 1e-5, the reference's gates; ``bitwise`` when both are
  0), and a ``roofline`` row: one round counted on the meta device
  (``launch.dryrun.count_step`` of the reduced model at the round's
  clients, batch and local steps, the flash kernels as their work) for
  each trajectory a card holds, where the reference reads its compiled
  program's ``cost_analysis()``, and the round's all-gathers over
  ``"model"`` (``launch.roofline.collective_stats``) where it parses the
  HLO's collectives; every term per round (``_tokens_per_round``).
- ``cohort``: the cross-device path at LM size (m = 10,000 clients, a C =
  256 cohort, stateless clients) on the same mesh.

The mesh: ``make_2d_mesh(4, 2)`` of the first 8 cards when 8 are visible,
as the reference; ``mesh`` (a ``launch.mesh.Mesh``) sets it, ``None``
forces one device. Without a mesh each arm records the reference's
single-device note. The device axis's workers share nothing but the card
count with the reference's forced host devices, so ``speedup`` is read
beside ``host_cores`` as there. Prints a ``BENCH {...}`` JSON line; the
full mode writes ``build/paper/lm_sweep.json`` (or ``out_path``),
``smoke`` runs a seconds-scale configuration and writes nothing.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

import torch

from repro_torch.core.algorithms import algo_family
from repro_torch.device import resolve_device
from repro_torch.experiments import SweepSpec
from repro_torch.experiments.grid import (
    get_traced_task,
    make_cell_batch,
    make_runner,
)
from repro_torch.experiments.shard import (
    AUTO,
    commit,
    pad_batch,
    run_committed,
)
from repro_torch.launch.mesh import make_2d_mesh
from repro_torch.launch.roofline import Roofline, collective_stats
from repro_torch.paper import OUT_DIR
from repro_torch.paper.common import (
    backend_name,
    tree_max_abs_diff,
    warm_timed,
)

METRIC_KEYS = ("loss", "num_active")


def _lm_config(spec: SweepSpec):
    """The task's model: ``reduced(get_config(lm_arch), lm_d_model,
    lm_layers)`` in fp32 (``tasks.make_traced_lm_task``)."""
    from repro_torch.configs import get_config, reduced

    return dataclasses.replace(reduced(get_config(spec.lm_arch),
                                       d_model=spec.lm_d_model,
                                       layers=spec.lm_layers),
                               dtype="float32")


def _tokens_per_round(spec: SweepSpec, batch_size_B: int) -> int:
    """Global training tokens one ROUND consumes: B trajectories x active
    clients x local steps x batch x seq (the reference's per-round
    convention, kept so that the rows compare)."""
    m_active = spec.cohort_size if spec.cohort_size else spec.num_clients
    return (batch_size_B * m_active * spec.local_steps
            * spec.batch_size * spec.lm_seq)


def _throughput_arm(spec: SweepSpec, algos, mesh, dev, *,
                    with_roofline=False):
    """Warm one-device vs 2-D-mesh execution of one family cell batch.
    Returns the arm's BENCH sub-dict (plus a roofline sub-dict when
    asked)."""
    task = get_traced_task(spec, dev)
    fed = spec.cell_config(algos[0], "bernoulli_ti")
    batch = make_cell_batch(spec, fed, task, algos=algos, device=dev)
    B = batch.batch_size
    total_rounds = B * spec.rounds

    plain = make_runner(spec, fed, task, metric_keys=METRIC_KEYS, device=dev)
    single_s, ref = warm_timed(lambda: plain(batch), dev)
    entry = {
        "algos": list(algos),
        "lrs": list(spec.lrs),
        "n_trajectories": B,
        "rounds": spec.rounds,
        "num_clients": spec.num_clients,
        "cohort_size": spec.cohort_size,
        "single_device_seconds": round(single_s, 4),
        "single_device_rounds_per_s": round(total_rounds / single_s, 4),
    }
    if mesh is None:
        entry["note"] = ("single device visible; rerun under XLA_FLAGS="
                         "--xla_force_host_platform_device_count=8 (CPU) or "
                         "on a multi-device backend for the 2-D arm")
        return entry

    r2d = make_runner(spec, fed, task, metric_keys=METRIC_KEYS, device=dev,
                      shard_mesh=mesh)
    # pad and slice the batch and send it to the workers ONCE outside the
    # timed region (the sweep's batch cache does the same)
    padded, b_real = pad_batch(batch, mesh.shape["batch"])
    committed = commit(padded, mesh, ("lm_sweep", id(batch)), b_real)
    sharded_s, out = warm_timed(lambda: run_committed(
        r2d, committed, mesh, period=fed.period, device=dev), dev)
    # the 2-D placement must not change the trajectories (the reference's
    # gates: states and evals at 1e-6, the loss telemetry at 1e-5)
    diff = tree_max_abs_diff((ref[0], ref[1]["evals"]),
                             (out[0], out[1]["evals"]))
    metrics_diff = tree_max_abs_diff(ref[1]["metrics"], out[1]["metrics"])
    if diff > 1e-6:
        raise RuntimeError(
            f"2-D-mesh and single-device trajectories diverged: {diff}")
    if metrics_diff > 1e-5:
        raise RuntimeError(
            f"2-D-mesh loss telemetry diverged beyond ulp scale: "
            f"{metrics_diff}")
    entry.update({
        "mesh": dict(mesh.shape),
        "padded_trajectories": padded.batch_size,
        "sharded_seconds": round(sharded_s, 4),
        "sharded_rounds_per_s": round(total_rounds / sharded_s, 4),
        "speedup": round(single_s / sharded_s, 2),
        "trajectory_max_abs_diff": diff,
        "metrics_max_abs_diff": metrics_diff,
        "bitwise": bool(diff == 0.0 and metrics_diff == 0.0),
    })
    if with_roofline:
        entry["roofline"] = _roofline(spec, task, mesh,
                                      batch_size_B=padded.batch_size)
    return entry


def _roofline(spec, task, mesh, *, batch_size_B):
    """One round of the 2-D program on the H100's roofline, per card: one
    trajectory's round counted on meta (``count_step``: the round's
    clients, each with its batch and local steps, the aggregation) times
    the trajectories a card's share holds (``batch_size_B / chips``: a
    batch index's trajectories, their clients split over ``"model"``), and
    the round's all-gathers of a rank (``collective_stats``: the local
    updates and the losses). ``useful_fraction`` is the model flops (6 N
    tokens of the round) over the counted flops of all cards."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.dryrun import count_step

    m_active = spec.cohort_size if spec.cohort_size else spec.num_clients
    shape = ShapeConfig("lm_sweep", spec.lm_seq, m_active * spec.batch_size,
                        "train")
    one = count_step(_lm_config(spec), shape, num_clients=m_active,
                     local_steps=spec.local_steps)
    chips = mesh.size
    per_card = batch_size_B / chips
    n_params = task.layout.size
    coll = collective_stats(mesh.shape["model"],
                            rows=batch_size_B // mesh.shape["batch"],
                            clients=m_active, group_bytes=[4 * n_params],
                            rounds=1)
    rf = Roofline(
        flops=one["flops"] * per_card,
        hbm_bytes=one["bytes"] * per_card,
        coll_bytes=float(coll.total_bytes),
        chips=chips,
        model_flops=6.0 * n_params * _tokens_per_round(spec, batch_size_B))
    row = rf.row()
    row["param_count"] = n_params
    row["coll_count"] = dict(coll.count_by_kind)
    return row


def run(csv=True, *, rounds=10, smoke=False, out_path=None, device=None,
        use_kernel=None, mesh=AUTO):
    dev = resolve_device(device)
    n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
    if mesh == AUTO:
        mesh = (make_2d_mesh(4, 2, [torch.device("cuda", i)
                                    for i in range(8)])
                if n_dev >= 8 else None)
    family = algo_family("fedavg")

    if smoke:
        rounds = 2
        lm = SweepSpec(algorithms=family, schemes=("bernoulli_ti",),
                       seeds=(0,), rounds=rounds, eval_every=rounds,
                       num_clients=4, local_steps=1, batch_size=1,
                       per_client=8, lrs=(0.1,), task="lm", lm_d_model=32,
                       lm_layers=1, lm_seq=16, classes=4, lm_n_seqs=64,
                       lm_n_test=16, use_kernel=use_kernel)
        cohort = dataclasses.replace(
            lm, algorithms=family[:2], num_clients=64, cohort_size=8,
            per_client=4)
    else:
        lm = SweepSpec(algorithms=family, schemes=("bernoulli_ti",),
                       seeds=(0,), rounds=rounds,
                       eval_every=max(rounds // 2, 1), num_clients=4,
                       local_steps=2, batch_size=2, per_client=16,
                       lrs=(0.05, 0.1), task="lm", lm_d_model=64,
                       lm_layers=2, lm_seq=32, classes=4, lm_n_seqs=256,
                       lm_n_test=64, use_kernel=use_kernel)
        cohort = dataclasses.replace(
            lm, algorithms=family[:2], lrs=(0.05, 0.1),
            rounds=max(rounds // 2, 2), eval_every=max(rounds // 2, 2),
            num_clients=10_000, cohort_size=256, per_client=4,
            local_steps=1, lm_n_seqs=512)

    lm_family = _throughput_arm(lm, family, mesh, dev, with_roofline=True)
    cohort_arm = _throughput_arm(cohort, tuple(cohort.algorithms), mesh, dev)

    result = {
        "bench": "lm_sweep",
        "smoke": smoke,
        "arch": lm.lm_arch,
        "d_model": lm.lm_d_model,
        "layers": lm.lm_layers,
        "seq_len": lm.lm_seq,
        "n_devices": n_dev,
        # read `speedup` against the host's cores: each rank is a process
        # feeding its card from them
        "host_cores": os.cpu_count(),
        "lm_family": lm_family,
        "cohort": cohort_arm,
        "backend": backend_name(dev),
    }
    print("BENCH " + json.dumps(result), flush=True)
    if not smoke:
        if out_path is None:
            out_path = os.path.join(OUT_DIR, "lm_sweep.json")
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(result, f, indent=2)
    return result


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--smoke", action="store_true",
                    help="seconds-scale config; no JSON file written")
    ap.add_argument("--device", default=None)
    ap.add_argument("--use-kernel", action="store_true")
    a = ap.parse_args()
    run(rounds=a.rounds, smoke=a.smoke, device=a.device,
        use_kernel=a.use_kernel or None)

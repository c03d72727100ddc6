"""The dry run's ``2x16x16`` training row (``launch/dryrun.py``,
``launch/steps.py``'s ``pod_silo`` placement) on the CPU at ``reduced()``
size and a short shape: one federated client a pod, its state placed over
``"pod"`` by the client axis of the specs, and the aggregation's traffic
across the pods at least one model's shard of bytes (it averages the two
clients' models). Exact checks (placements and counts, no arithmetic).

In a file of its own so that it runs beside ``test_torch_dryrun_mesh.py``:
about 20 s on one CPU core, DTensor's sharding propagation on a 3-D mesh.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ShapeConfig, get_config, reduced  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402


def test_2x16x16_round_holds_a_client_a_pod_and_aggregates_across():
    cfg = reduced(get_config("smollm-135m"))
    shape = ShapeConfig("train_4k", 64, 32, "train")
    c = dryrun.count_step_meshed(cfg, shape, multi_pod=True)
    assert c["num_clients"] == 2
    # clients [1, m, ...]: the client dim over "pod", the leaf over the rest
    assert c["client_placements"].startswith("(Shard(dim=1)")
    assert c["coll_bytes_by_axis"]["pod"] >= c["param_bytes"]
    assert set(c["coll_bytes_by_axis"]) <= {"pod", "data", "model"}
    assert c["act_spec"] == "P('data', 'model', None)"
    rf = dryrun.Roofline(c["flops"], c["bytes"],
                         sum(c["coll_bytes"].values()), 512)
    assert rf.t_collective > 0

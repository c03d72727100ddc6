"""The dry run on the production meshes (``launch/dryrun.py``'s meshed
rows, ``sharding/spmd.py``'s simulated group, ``launch/steps.py``'s
placements), on the CPU at ``reduced()`` sizes and short shapes.

What is held, and how exactly:
- on a ``(1, 1)`` ``("data", "model")`` mesh the meshed count's flops equal
  the one-card count's (exact: the same products at the same shapes), and
  it makes no collective;
- on ``16x16`` rank 0's ``param_bytes`` equal the specs' shard bytes
  (exact: the ceiling division GSPMD pads to), and flops times chips cover
  the one-card flops;
- the train row makes collectives (``2x16x16``'s pods:
  ``tests/test_torch_dryrun_pods.py``);
- each flag of ``main`` gives an ``ok`` row changed as the flag says;
- only the refusals ``spmd.RETRIED`` lists are retried, any other error
  fails the row;
- the group is gone after a row that raises;
- the rank-0 program (``run_rank0``) launches the flash shapes the count
  predicts.

About 40 s on one CPU core, most of it DTensor's sharding propagation.
"""
import json
import math

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch.configs import ShapeConfig, get_config, reduced  # noqa: E402
from repro_torch.launch import dryrun, steps  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    make_host_mesh,
    make_production_mesh,
)
from repro_torch.sharding import specs, spmd  # noqa: E402

SMOLLM = reduced(get_config("smollm-135m"))
# short shapes of each mode (the published ones at reduced() cost seconds
# a row more on 256 simulated ranks)
SHORT = {"train_4k": ShapeConfig("train_4k", 128, 32, "train"),
         "prefill_32k": ShapeConfig("prefill_32k", 256, 32, "prefill"),
         "decode_32k": ShapeConfig("decode_32k", 256, 32, "decode"),
         "long_500k": ShapeConfig("long_500k", 512, 1, "decode")}


@pytest.fixture
def short_shapes(monkeypatch):
    monkeypatch.setattr(dryrun, "INPUT_SHAPES", SHORT)
    monkeypatch.setattr(dryrun, "get_config",
                        lambda arch: reduced(get_config(arch)))


@pytest.mark.parametrize("mode", ["train_4k", "prefill_32k", "decode_32k"])
def test_host_mesh_count_equals_the_one_card_count(mode):
    """(1, 1): the same flops and flash launches, no collective (~2 s)."""
    shape = SHORT[mode]
    meshed = dryrun.count_step_meshed(SMOLLM, shape, mesh=make_host_mesh())
    card = dryrun.count_step(SMOLLM, shape)
    assert meshed["flops"] == card["flops"]
    assert meshed["flash_launches"] == card["flash_launches"]
    assert meshed["coll_bytes"] == {} and meshed["coll_count"] == {}


def test_16x16_param_bytes_are_the_shard_bytes_and_flops_cover():
    """Rank 0's params are its shards, each dim rounded up; its flops times
    256 are at least one card's (~3 s)."""
    mesh = make_production_mesh()
    params = steps.empty_params(SMOLLM)
    pspecs = specs.infer_pytree_specs(params, mesh)
    want = sum(math.prod(specs.shard_shape(v.shape, pspecs[k], mesh))
               * v.element_size() for k, v in params.items())
    for mode in ("prefill_32k", "decode_32k"):
        shape = SHORT[mode]
        c = dryrun.count_step_meshed(SMOLLM, shape)
        assert c["param_bytes"] == want, mode
        assert c["flops"] * mesh.size >= dryrun.count_step(
            SMOLLM, shape)["flops"], mode


def test_16x16_train_row_makes_collectives():
    """One client; the residual takes the training activation spec; the
    round makes collectives on the data and model axes only (~4 s)."""
    row = dryrun.lower_pair("smollm-135m", "train_4k", multi_pod=False,
                            cfg=SMOLLM, verbose=False)
    assert row["status"] == "ok" and row["t_collective_s"] > 0
    assert row["num_clients"] == 1
    assert row["act_spec"] == "P('data', 'model', None)"
    assert set(row["collective_bytes_by_axis"]) <= {"data", "model"}


def test_main_rows_and_flags(short_shapes, tmp_path, capsys):
    """The reference's flags: no mesh flag is 16x16, --both-meshes adds
    2x16x16; --no-seq-parallel, --act-spec dmodel, --tp2d, --dispatch and
    --no-analyze give ok rows changed as each says (~12 s)."""
    def rows(*argv):
        out = tmp_path / "rows.json"
        assert dryrun.main([*argv, "--out", str(out)]) == 0
        return json.loads(out.read_text())

    both = rows("--arch", "smollm-135m", "--shape", "decode_32k",
                "--both-meshes")
    assert [r["mesh"] for r in both] == ["16x16", "2x16x16"]
    assert all(r["status"] == "ok" for r in both)
    seq = rows("--arch", "smollm-135m", "--shape", "prefill_32k")[0]
    assert seq["act_spec"] == "P(('data',), 'model', None)"
    off = rows("--arch", "smollm-135m", "--shape", "prefill_32k",
               "--no-seq-parallel")[0]
    assert off["status"] == "ok" and off["act_spec"] is None
    dmodel = rows("--arch", "smollm-135m", "--shape", "prefill_32k",
                  "--act-spec", "dmodel")[0]
    assert dmodel["act_spec"] == "P(('data',), None, 'model')"
    plain, tp2d = both[0], rows("--arch", "smollm-135m", "--shape",
                                "decode_32k", "--tp2d")[0]
    assert (plain["tp2d"], tp2d["tp2d"]) == (False, True)
    assert tp2d["status"] == "ok"
    assert tp2d["param_bytes"] != plain["param_bytes"]
    einsum, scatter = (rows("--arch", "mixtral-8x22b", "--shape",
                            "prefill_32k", *extra)[0]
                       for extra in ((), ("--dispatch", "scatter")))
    assert (einsum["moe_dispatch"], scatter["moe_dispatch"]) == (
        "einsum", "scatter")
    assert scatter["status"] == "ok"
    assert scatter["hlo_flops"] != einsum["hlo_flops"]
    quiet = rows("--arch", "smollm-135m", "--shape", "prefill_32k",
                 "--no-analyze")[0]
    assert "no depth extrapolation" in quiet["analyze"]
    assert quiet["hlo_flops"] == seq["hlo_flops"]
    assert "DONE ok=1" in capsys.readouterr().out


def test_only_the_listed_refusals_are_retried(short_shapes, monkeypatch):
    """Reduced mixtral's decode scatters into its MoE buffer by DTensor
    indices, which DTensor refuses (``spmd.RETRIED``): the op is retried
    and the row counts it. Unlisted, or listed with another error, the
    refusal propagates and the row FAILs (~4 s)."""
    def row():
        return dryrun.lower_pair("mixtral-8x22b", "decode_32k",
                                 multi_pod=False, verbose=False)

    ok = row()
    assert ok["status"] == "ok"
    assert ok["replicated_ops"] == {"aten.scatter_add_.default": 2}
    assert set(ok["replicated_ops"]) <= set(spmd.RETRIED)
    monkeypatch.setitem(spmd.RETRIED, "aten.scatter_add_.default",
                        ((AssertionError, "another message"),))
    other = row()
    assert other["status"] == "FAIL"
    assert other["error"].startswith("AssertionError")
    monkeypatch.delitem(spmd.RETRIED, "aten.scatter_add_.default")
    unlisted = row()
    assert unlisted["status"] == "FAIL"
    assert unlisted["error"].startswith("AssertionError")
    assert not dist.is_initialized()


def test_the_group_is_gone_after_a_row_that_raises(monkeypatch):
    """A step that raises gives a FAIL row, and leaves no process group and
    no mesh on the hooks; a group already up is refused (~1 s)."""
    def broken(cfg):
        def step(*args):
            raise RuntimeError("broken step")
        return step

    monkeypatch.setattr(steps, "make_prefill_step", broken)
    row = dryrun.lower_pair("smollm-135m", "prefill_32k", multi_pod=False,
                            cfg=SMOLLM, verbose=False)
    assert row["status"] == "FAIL" and "broken step" in row["error"]
    assert not dist.is_initialized()
    assert specs.current_mesh() is None
    with spmd.simulated_mesh(make_host_mesh()):
        with pytest.raises(RuntimeError, match="already up"):
            with spmd.simulated_mesh(make_host_mesh()):
                pass
    assert not dist.is_initialized()


def test_rank0_program_launches_what_the_count_predicts():
    """``run_rank0`` on the CPU (the plain attention; the shapes recorded
    are those the card would launch) against the 16x16 count (~3 s)."""
    shape = SHORT["prefill_32k"]
    count = dryrun.count_step_meshed(SMOLLM, shape)
    run = dryrun.run_rank0(SMOLLM, shape, device="cpu",
                           measure=lambda fn: fn())
    assert run["launches"] == count["flash_launches"]["fwd"]
    assert run["flash_shapes"] == sorted(count["flash_shapes"])
    assert run["out_shape"] == [shape.global_batch, SMOLLM.vocab_size]
    assert run["out_local_shape"][0] == shape.global_batch // 16
    assert run["input_bytes"] == count["input_bytes"]
    # the first flash-shaped call, for the card to hold the kernel against
    # the plain version at
    call = run["attention"]
    b, t, h, d = call["shape"]
    assert (b * h, t, d, 0) == tuple(run["flash_shapes"][0])
    assert call["dtype"] == torch.bfloat16
    assert call["kw"]["kind"] == "full"


def test_view_placements():
    """Views keep the shards their factors line up with: a merge keeps the
    leading shard, nested shards of two axes stay nested, an inner or
    uneven shard is replicated first."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    v = spmd.view_placements
    assert v((1, 2, 128, 4096), (2, 128, 4096),
             (Shard(1), Shard(2), Replicate()), (2, 16, 16)) == (
        (Shard(1), Shard(2), Replicate()), (Shard(0), Shard(1), Replicate()))
    assert v((2, 128 * 4096, 256), (256, 4096, 4, 64),
             (Shard(0), Shard(1), Partial()), (2, 16, 16))[1] == (
        Shard(0), Shard(0), Partial())
    assert v((1, 32, 32768, 256), (1, 32 * 32768, 256),
             (Shard(1), Shard(2)), (16, 16)) == (
        (Shard(1), Replicate()), (Shard(1), Replicate()))
    assert v((576, 576), (576, 9, 64), (Shard(0), Shard(1)), (16, 16)) == (
        (Shard(0), Replicate()), (Shard(0), Replicate()))
    assert v((6, 4), (4, 6), (Shard(0), Replicate()), (2, 1)) == (
        (Replicate(), Replicate()), (Replicate(), Replicate()))


def test_index_copy_without_a_rule_keeps_the_other_shards():
    """Where DTensor has no rule for ``index_copy`` (the decode cache's
    write), only the mesh dims that shard the written dim are replicated;
    the write lands (~1 s)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch.mesh import Mesh

    mesh = Mesh(("data", "model"), (2, 2), ("cpu",) * 4)
    with spmd.simulated_mesh(mesh) as dm:
        cache = DTensor.from_local(torch.zeros(2, 4, 3), dm,
                                   (Shard(0), Shard(1)),
                                   shape=torch.Size((4, 8, 3)),
                                   stride=(24, 3, 1), run_check=False)
        new = DTensor.from_local(torch.ones(2, 1, 3), dm,
                                 (Shard(0), Replicate()),
                                 shape=torch.Size((4, 1, 3)),
                                 stride=(3, 3, 1), run_check=False)
        out = spmd._index_copy_along(torch.ops.aten.index_copy.default,
                                     cache, 1, torch.tensor([5]), new)
        assert out.placements == (Shard(0), Replicate())
        assert tuple(out.shape) == (4, 8, 3)
        local = out.to_local()
        assert tuple(local.shape) == (2, 8, 3)
        assert local[:, 5].eq(1).all() and local.sum() == 6

"""The port's checkpoints (``repro_torch.checkpointing``) on the CPU: the
reference's contracts (``tests/test_substrates.py::test_checkpoint_roundtrip``
and ``tests/test_run_rounds.py::test_checkpoint_roundtrip_mid_chunk``, the
latter with the port's engine, ``lm_source``, a toy loss and the drawer,
over fedpbc and a stateful rule, Bernoulli and Markov uplinks), and what
the port adds: bf16 and two parameter groups bit for bit, generators,
ints, ``None``, refusals of a template that differs, and atomic saves.

Every comparison is exact: a checkpoint stores the bits.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpointing import latest_step, restore, save  # noqa: E402
from repro_torch.configs import FederationConfig  # noqa: E402
from repro_torch.core import (  # noqa: E402
    GeneratorDraws,
    Groups,
    init_fed_state,
    make_algorithm_spec,
    make_link_process,
    make_run_rounds,
)
from repro_torch.data import lm_source  # noqa: E402
from repro_torch.experiments.sweep import seed_generators  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402

M, S = 4, 2


def _bits(t):
    """The tensor's bits as integers (so NaNs compare)."""
    if t.dtype == torch.bool:
        return t.view(torch.uint8)
    if t.is_floating_point():
        return t.view({2: torch.int16, 4: torch.int32,
                       8: torch.int64}[t.element_size()])
    return t


def _assert_trees_equal(a, b):
    if dataclasses.is_dataclass(a):
        assert type(a) is type(b)
        for f in dataclasses.fields(a):
            _assert_trees_equal(getattr(a, f.name), getattr(b, f.name))
    elif isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _assert_trees_equal(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_trees_equal(x, y)
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.device == b.device
        assert torch.equal(_bits(a), _bits(b)), (a, b)
    elif isinstance(a, torch.Generator):
        assert a.device == b.device
        assert torch.equal(a.get_state(), b.get_state())
    else:
        assert type(a) is type(b) and a == b


def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(5.0),
            "b": {"c": torch.ones((2, 3), dtype=torch.bfloat16)},
            "d": torch.tensor(7, dtype=torch.int32)}
    path = str(tmp_path / "ckpt")
    save(path, 3, tree)
    save(path, 10, tree)
    assert latest_step(path) == 10
    out = restore(path, 3, tree)
    np.testing.assert_allclose(out["a"].numpy(), np.arange(5.0))
    assert out["b"]["c"].shape == (2, 3)
    assert int(out["d"]) == 7
    assert sorted(os.listdir(path)) == ["ckpt_00000003.npz",
                                        "ckpt_00000010.npz"]
    assert latest_step(str(tmp_path / "missing")) is None


@dataclasses.dataclass(frozen=True)
class _Node:
    x: torch.Tensor
    n: int
    rest: object = None


def test_every_leaf_kind_comes_back_bit_for_bit(tmp_path):
    """bf16 (no numpy dtype: stored as its int16 bits) with values fp32
    would round and a NaN, ints, bools, ``None``, lists, tuples,
    ``Groups``, a frozen dataclass, bool and int64 tensors, a
    non-contiguous tensor and a generator part way along its stream; a
    leaf of another kind is refused."""
    g = torch.Generator().manual_seed(5)
    torch.rand(3, generator=g)
    bf = torch.tensor([1.0 + 2 ** -7, -3.5, float("nan"), 1e-30],
                      dtype=torch.bfloat16)
    tree = {"bf": bf, "ints": [3, -2 ** 40], "flag": True, "none": None,
            "groups": Groups((bf[:2], torch.tensor([1.0 + 2 ** -20]))),
            "node": _Node(torch.arange(6).reshape(2, 3).t(), 4,
                          (torch.tensor([True, False]), None)),
            "gen": g}
    save(str(tmp_path), 1, tree)
    template = {"bf": torch.zeros_like(bf), "ints": [0, 0], "flag": False,
                "none": None,
                "groups": Groups((torch.zeros(2, dtype=torch.bfloat16),
                                  torch.zeros(1))),
                "node": _Node(torch.zeros(3, 2, dtype=torch.int64), 0,
                              (torch.zeros(2, dtype=torch.bool), None)),
                "gen": torch.Generator()}
    out = restore(str(tmp_path), 1, template)
    _assert_trees_equal(out, tree)
    assert type(out["groups"]) is Groups
    # the restored generator draws what the saved one draws next
    assert torch.equal(torch.rand(4, generator=out["gen"]),
                       torch.rand(4, generator=g))
    with pytest.raises(TypeError, match="checkpoint leaf"):
        save(str(tmp_path), 2, {"lr": 0.1})


def test_two_parameter_groups_are_exact_where_bf16_would_round(tmp_path):
    """A bf16 buffer and an fp32 buffer (``Groups``) whose fp32 value bf16
    cannot hold: both come back with their dtypes and bits."""
    gen = torch.Generator().manual_seed(0)
    bf16 = torch.randn(2, 3, 40, generator=gen).to(torch.bfloat16)
    fp32 = torch.full((2, 3, 5), 1.0 + 2 ** -20)
    assert fp32.to(torch.bfloat16).float().ne(fp32).all()
    tree = (Groups((bf16, fp32)), {"step": torch.zeros(2, 3,
                                                       dtype=torch.int32)})
    save(str(tmp_path), 7, tree)
    out = restore(str(tmp_path), 7, (Groups((torch.empty_like(bf16),
                                             torch.empty_like(fp32))),
                                     {"step": torch.empty(2, 3,
                                                          dtype=torch.int32)}))
    _assert_trees_equal(out, tree)


@pytest.mark.parametrize("template, match", [
    ({"w": torch.zeros(3, 2)}, "shape"),
    ({"w": torch.zeros(2, 3, dtype=torch.int16)}, "dtype"),
    ({"w": torch.zeros(2, 3), "extra": torch.zeros(1)}, "structure"),
    ({"w": 0}, "structure"),
    ((torch.zeros(2, 3),), "structure"),
])
def test_restore_refuses_a_template_that_differs(tmp_path, template, match):
    """Shape, dtype (bf16 bits would otherwise come back as int16), the
    kind of a leaf and the structure are all checked."""
    save(str(tmp_path), 1, {"w": torch.zeros(2, 3, dtype=torch.bfloat16)
                            if match == "dtype" else torch.zeros(2, 3)})
    with pytest.raises(ValueError, match=match):
        restore(str(tmp_path), 1, template)


def test_a_save_that_fails_leaves_no_file(tmp_path, monkeypatch):
    """The npz is written under a temporary name and moved into place: a
    save cut short leaves neither a checkpoint nor its temporary file."""
    path = str(tmp_path)
    save(path, 2, {"w": torch.ones(3)})

    def broken(f, **arrays):
        f.write(b"PK\x03\x04 half a zip")
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez", broken)
    with pytest.raises(OSError, match="disk full"):
        save(path, 4, {"w": torch.ones(3)})
    assert os.listdir(path) == ["ckpt_00000002.npz"]
    assert latest_step(path) == 2


def _toy_loss(params, batch):
    """Embedding-free toy LM loss over the synthetic token stream, per
    client: ``params [B, m, 4]``, tokens ``[B, m, b, T]`` -> ``[B, m]``."""
    logits = batch["tokens"][..., None].float() * params[:, :, None, None]
    labels = torch.nn.functional.one_hot(batch["labels"] % 4, 4)
    return -(labels * torch.log_softmax(logits, -1)).sum(-1).mean((-2, -1))


@pytest.mark.parametrize("scheme", ["bernoulli", "markov"])
@pytest.mark.parametrize("algorithm", ["fedpbc", "mifa"])
def test_checkpoint_roundtrip_mid_chunk(tmp_path, algorithm, scheme):
    """save/restore of ``(FedState, ds_state, drawer)`` between chunks of
    rounds resumes the exact trajectory (``lm_source`` carries a nontrivial
    ``ds_state``; mifa carries per-client memory; Markov links a state)."""
    source = lm_source(num_clients=M, local_steps=S, batch=2, seq=8,
                       vocab=64)
    fed = FederationConfig(algorithm=algorithm, num_clients=M,
                           local_steps=S, scheme=scheme)
    algo = make_algorithm_spec((algorithm,), fed)
    link = make_link_process(torch.full((1, M), 0.6), fed)
    opt = sgd(0.05, momentum=0.9)
    run_rounds = make_run_rounds(_toy_loss, opt, algo, link, fed, source,
                                 device="cpu")

    def fresh():
        draws = GeneratorDraws([seed_generators(3)], num_clients=M,
                               pick_spec=source.pick_spec)
        server = draws.params(lambda g: 0.01 * torch.randn(4, generator=g))
        st = init_fed_state(draws.link_init(), server, fed, algo, link, opt)
        return st, source.init(draws.source_init(source.init_high)), draws

    # uninterrupted 4 + 4
    st_a, ds_a, draws_a = fresh()
    st_a, ds_a, mets_a = run_rounds(st_a, ds_a, draws_a, 8)

    # run 4, checkpoint, restore into a fresh template, run 4 more
    st_b, ds_b, draws_b = fresh()
    st_b, ds_b, _ = run_rounds(st_b, ds_b, draws_b, 4)
    save(str(tmp_path), 4, (st_b, ds_b, draws_b.state()))
    st0, ds0, draws0 = fresh()
    st_r, ds_r, drawn = restore(str(tmp_path), 4, (st0, ds0, draws0.state()))
    assert st_r.round == 4 and isinstance(st_r.round, int)
    draws_r = draws0.restored(drawn)
    assert draws_r.made == draws_b.made
    st_c, ds_c, mets_c = run_rounds(st_r, ds_r, draws_r, 4)

    _assert_trees_equal(st_a, st_c)
    _assert_trees_equal(ds_a, ds_c)
    _assert_trees_equal(draws_a.state(), draws_c_state := draws_r.state())
    assert draws_c_state["made"] == draws_a.made
    assert torch.equal(mets_a["loss"][:, 4:], mets_c["loss"])

"""The round over ``Leaves`` (a production mesh's round: ``launch/steps.py``
``make_fed_setup``, ``make_leaf_loss``; ``core/params.py`` ``Leaves`` and
``lead_view``) on real values, held bit for bit against the flat round
(``[1, m, n]`` buffers, the card's path) on the same state, batches and
link uniforms, for FedPBC, FedAvg, MIFA and FedPBC-M, with SGD with
momentum (``make_fed_setup``'s own round) and with Adam.

No mesh and no simulated group: the leaves are plain CPU tensors, so the
round's arithmetic runs on values. The 2x16x16 mesh is named only for its
client count (``num_clients_for``: 2, one a pod). Three rounds, the
uniforms chosen so that each client is once inactive (p = 0.8), so MIFA's
memory, the postponed broadcast and both optimizers' state are exercised.
Exact: the same products on the same operands, only held leaf by leaf.

About 10 s on one CPU core (one intra-op thread).
"""
import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import init_fed_state, make_round_fn  # noqa: E402
from repro_torch.core.params import Leaves  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models.model import (  # noqa: E402
    init_params,
    make_loss,
    param_layout,
)
from repro_torch.optim import adam  # noqa: E402

# u < 0.8 is an active uplink: client 1 off in round 0, client 0 in round 1
UNIFORMS = ([0.10, 0.95], [0.90, 0.20], [0.30, 0.40])
B, T = 2, 16


@pytest.fixture
def one_thread():
    """One intra-op thread: the products are small, and a pool of threads
    contending with other test processes costs ms a call."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(x, like):
    """``x`` (``Leaves`` or a tensor) as ``like``'s flat buffer: each leaf
    ``[*lead, *shape]`` as ``[*lead, size]``, concatenated."""
    if isinstance(x, Leaves):
        k = like.dim() - 1
        return torch.cat([leaf.reshape(tuple(leaf.shape[:k])
                                       + (math.prod(leaf.shape[k:]),))
                          for leaf in x], -1)
    return x


def _assert_same(leafy, flat, what):
    if dataclasses.is_dataclass(flat):
        for f in dataclasses.fields(flat):
            _assert_same(getattr(leafy, f.name), getattr(flat, f.name),
                         f"{what}.{f.name}")
    elif isinstance(flat, dict):
        assert set(leafy) == set(flat), what
        for k in flat:
            _assert_same(leafy[k], flat[k], f"{what}[{k}]")
    elif isinstance(flat, torch.Tensor):
        assert isinstance(leafy, Leaves) or not flat.dim() or (
            isinstance(leafy, torch.Tensor)), what       # kept leaf by leaf
        got = _flat(leafy, flat)
        assert got.dtype == flat.dtype and got.shape == flat.shape, what
        assert torch.equal(got, flat), what
    else:
        assert leafy == flat, what


@pytest.mark.parametrize("optimizer", ["sgd_momentum", "adam"])
@pytest.mark.parametrize("algorithm", ["fedpbc", "fedavg", "mifa",
                                       "fedpbc_m"])
def test_leaf_round_is_the_flat_round_bit_for_bit(monkeypatch, one_thread,
                                                  algorithm, optimizer):
    monkeypatch.setattr(steps, "DEVICE", "cpu")
    cfg = reduced(get_config("smollm-135m"))
    fed, algo, link, opt, leaf_round = steps.make_fed_setup(
        cfg, make_production_mesh(multi_pod=True), algorithm=algorithm)
    m = fed.num_clients
    assert m == 2 and fed.placement == "pod_silo"
    if optimizer == "adam":
        opt = adam(1e-3)
        leaf_round = make_round_fn(steps.make_leaf_loss(cfg), opt, algo,
                                   link, fed)
    flat_round = make_round_fn(make_loss(cfg, steps.BACKEND), opt, algo,
                               link, fed)

    flat = init_params(torch.Generator().manual_seed(0), cfg)[None]
    leaves = Leaves(v.clone() for v in
                    param_layout(cfg).views(flat).values())
    assert all(leaf.shape[0] == 1 for leaf in leaves)
    u0 = torch.tensor([[0.5, 0.5]])
    st_flat = init_fed_state(u0, flat, fed, algo, link, opt)
    st_leaf = init_fed_state(u0, leaves, fed, algo, link, opt)
    _assert_same(st_leaf, st_flat, "init")

    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for r, u in enumerate(UNIFORMS):
            toks = torch.randint(0, cfg.vocab_size, (1, m, fed.local_steps,
                                                     B, T), generator=gen)
            batches = {"tokens": toks, "labels": toks.roll(-1, -1)}
            u = torch.tensor([u])
            st_flat, met_flat = flat_round(st_flat, batches, u)
            st_leaf, met_leaf = leaf_round(st_leaf, batches, u)
            _assert_same(st_leaf, st_flat, f"round {r}")
            _assert_same(met_leaf, met_flat, f"round {r} metrics")
    assert not torch.equal(st_flat.server, flat)

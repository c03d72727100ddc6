"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX
reference (``repro.models.moe``) on the CPU, at ``reduced(mixtral-8x22b)``
(4 experts, d_model 256) in fp32.

First the four contracts of ``tests/test_moe.py`` on the port alone (the
two dispatches agree, a lower capacity factor drops more, the Switch aux
loss is near 1 for a random router, the capacity formula); then
``moe_apply`` against the reference's on the same weights (the
reference's ``moe_init``, carried across as numpy) and the same inputs
(numpy, seeded), for both dispatches, top-1 and top-2, and capacity
factors 0.5 and 1.25.

Tolerances, each with its reason:
- ``moe_apply`` output: fp32 atol = rtol = 1e-5 (the same products
  summed in another order; 2.4e-6 measured);
- aux: 1e-6 (one softmax mean and a count);
- the slots kept under the capacity: exact (integer counts).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402


def _cfg(dispatch="einsum", cf=1.25, experts=4, top_k=2, port=True):
    get, red = (get_config, reduced) if port else (jget_config, jreduced)
    base = dataclasses.replace(red(get("mixtral-8x22b")), dtype="float32")
    return dataclasses.replace(
        base, moe=dataclasses.replace(base.moe, dispatch=dispatch,
                                      capacity_factor=cf,
                                      num_experts=experts, top_k=top_k))


def _params(cfg, seed):
    return tmoe.moe_init(torch.Generator().manual_seed(seed), cfg)


def _x(shape, seed):
    return torch.from_numpy(
        np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


# ---- the reference's contracts (tests/test_moe.py) on the port ----


@pytest.mark.parametrize("cf", [0.5, 1.25, 4.0])
@pytest.mark.parametrize("topk", [1, 2])
def test_scatter_equals_einsum(cf, topk):
    cfg = _cfg(cf=cf, top_k=topk)
    p = _params(cfg, 0)
    x = _x((3, 40, cfg.d_model), 1)
    y1, a1 = tmoe.moe_apply(p, x, _cfg("einsum", cf, top_k=topk))
    y2, a2 = tmoe.moe_apply(p, x, _cfg("scatter", cf, top_k=topk))
    torch.testing.assert_close(y1, y2, rtol=1e-5, atol=1e-5)
    assert abs(float(a1) - float(a2)) <= 1e-6 * abs(float(a2))


def test_capacity_drop_monotone():
    """Lower capacity factor -> more dropped tokens -> smaller output
    norm."""
    cfg_lo, cfg_hi = _cfg(cf=0.25), _cfg(cf=8.0)
    p = _params(cfg_lo, 2)
    x = _x((2, 64, cfg_lo.d_model), 3)
    y_lo, _ = tmoe.moe_apply(p, x, cfg_lo)
    y_hi, _ = tmoe.moe_apply(p, x, cfg_hi)
    assert float(y_lo.norm()) < float(y_hi.norm())


def test_aux_loss_near_one_for_uniform_router():
    """Switch aux loss == 1 exactly under a perfectly balanced router."""
    cfg = _cfg()
    p = _params(cfg, 4)
    x = _x((1, 512, cfg.d_model), 5)
    _, aux = tmoe.moe_apply(p, x, cfg)
    assert 0.8 < float(aux) < 1.6  # near-uniform random router


def test_capacity_formula():
    cfg = _cfg(cf=1.25, experts=4, top_k=2)
    assert tmoe._capacity(cfg, 64) == int(1.25 * 2 * 64 / 4)


# ---- against the reference ----


def _ref_params(cfg, seed=0):
    p = jmoe.moe_init(jax.random.PRNGKey(seed), cfg)
    return p, {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


def test_moe_init_leaves_match_reference_shapes_and_dtypes():
    cfg = dataclasses.replace(_cfg(), dtype="bfloat16")
    jcfg = dataclasses.replace(_cfg(port=False), dtype="bfloat16")
    ref = jmoe.moe_init(jax.random.PRNGKey(0), jcfg)
    got = tmoe.moe_init(torch.Generator().manual_seed(0), cfg)
    assert sorted(got) == sorted(ref) == sorted(
        n for n, _ in tmoe.moe_leaves(cfg))
    for name, leaf in got.items():
        assert tuple(leaf.shape) == ref[name].shape
        want = torch.float32 if name == "router" else torch.bfloat16
        assert leaf.dtype == want and str(ref[name].dtype) == str(
            want).split(".")[-1]


@pytest.mark.parametrize("cf", [0.5, 1.25])
@pytest.mark.parametrize("topk", [1, 2])
@pytest.mark.parametrize("dispatch", ["einsum", "scatter"])
def test_moe_apply_matches_reference(dispatch, topk, cf):
    jcfg = _cfg(dispatch, cf, top_k=topk, port=False)
    cfg = _cfg(dispatch, cf, top_k=topk)
    jp, p = _ref_params(jcfg)
    x = _x((3, 40, cfg.d_model), 7)
    want, want_aux = jmoe.moe_apply(jp, jnp.asarray(x.numpy()), jcfg)
    got, aux = tmoe.moe_apply(p, x, cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert abs(float(aux) - float(want_aux)) <= 1e-6
    # the same (token, choice) slots dropped, row by row
    ref_keep = []
    for row in np.asarray(x.numpy()):
        idx, _, _ = jmoe._router(jp, jnp.asarray(row), jcfg)
        onehot = jax.nn.one_hot(idx, jcfg.moe.num_experts)
        pos = jnp.cumsum(onehot.reshape(-1, jcfg.moe.num_experts), 0
                         ).reshape(onehot.shape) - 1.0
        pos = jnp.sum(pos * onehot, -1)
        ref_keep.append(np.asarray(pos < jmoe._capacity(jcfg, row.shape[0])))
    idx, _, _ = tmoe._router(p, x, cfg)
    _, keep, _ = tmoe.slots(idx, cfg, x.shape[1])
    np.testing.assert_array_equal(keep.numpy(), np.stack(ref_keep))
    if cf == 0.5:
        assert not keep.all()     # the case drops some slots

"""The port's batched sweep (``repro_torch.experiments``) against the JAX
reference: one family cell of B = 4 algorithms x 2 seeds, batched in the
port, against 8 per-trajectory reference runs fed the same draws; plus the
``eval_rounds`` contract, ``SweepSpec`` validation and the later-slice
knobs.

Tolerances: final server params and per-round losses rtol/atol 1e-4 (six
rounds of fp32 local training whose matrix products and reductions run in
another order, never re-synced); test accuracy within one test example
(a 1e-6 parameter difference can flip an example on the decision boundary);
active counts exactly equal (same uniforms, same Eq.-9 float32 order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import FAMILY, SMALL, JaxKeyDraws, np_tree, tasks  # noqa: E402
from repro.core import connectivity as jconn  # noqa: E402
from repro.core import federated as jfed  # noqa: E402
from repro.experiments import grid as jgrid  # noqa: E402
from repro.experiments import sweep as jsweep  # noqa: E402
from repro.optim import paper_decay as jdecay, sgd as jsgd  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.experiments import grid as tgrid  # noqa: E402
from repro_torch.experiments import sweep as tsweep  # noqa: E402

ROUNDS, EVAL_EVERY, SEEDS = 6, 3, (0, 1)


def _spec(module, **kw):
    base = dict(algorithms=FAMILY, schemes=("bernoulli_tv",), seeds=SEEDS,
                rounds=ROUNDS, eval_every=EVAL_EVERY, data_seed=0,
                **{k: SMALL[k] for k in ("num_clients", "dim", "hidden",
                                         "per_client", "local_steps",
                                         "batch_size", "n_per_class",
                                         "n_train")})
    base.update(kw)
    return module.SweepSpec(**base)


def _reference_trajectories(scheme):
    """8 per-trajectory reference runs (algorithm-major, seed-minor, the
    batch layout), each through ``make_run_rounds`` with its own key
    bundle, ``p_base`` and static-shape program; evals every 3 rounds."""
    spec = _spec(jgrid)
    fed = spec.cell_config("fedpbc", scheme)
    jtask, _ = tasks()
    fam = jgrid.make_algorithm_spec(FAMILY, fed)
    idx = jnp.asarray(jtask.partition(spec.alpha))

    def one(keys, p_base, aid):
        link = jconn.make_link_process(p_base, fed, gamma=jnp.float32(0.5),
                                       period=jnp.float32(fed.period))
        opt = jsgd(jdecay(jnp.float32(spec.lr)))
        source = jtask.source_factory(jtask.shared)
        run = jfed.make_run_rounds(jtask.loss_fn, opt, fam, link, fed, source,
                                   algo_id=aid)
        st = jfed.init_fed_state(keys["state"],
                                 jtask.init_params(keys["params"]), fed, fam,
                                 link, opt)
        ds = source.init(keys["ds"], {"idx": idx})
        evals, mets = [], []
        for _ in range(ROUNDS // EVAL_EVERY):
            st, ds, m = run(st, ds, keys["data"], EVAL_EVERY)
            evals.append(jtask.eval_test(st.server, jtask.shared))
            mets.append(m)
        return st, jnp.stack(evals), jax.tree.map(
            lambda *a: jnp.concatenate(a), *mets)

    one = jax.jit(one)
    out = []
    for ai in range(len(FAMILY)):
        for s in SEEDS:
            p_base = jconn.build_base_probs(jax.random.PRNGKey(s),
                                            spec.num_clients, 10)[0]
            out.append((one(jsweep.seed_keys(s), p_base, jnp.int32(ai)),
                        np.asarray(p_base)))
    return fed, jtask, out


@pytest.mark.parametrize("use_kernel", [True, False])
def test_batched_family_cell_matches_per_trajectory_reference(use_kernel):
    scheme = "bernoulli_tv"
    fed, jtask, ref = _reference_trajectories(scheme)
    spec = _spec(tgrid, use_kernel=use_kernel)
    task = tgrid.get_traced_task(spec, "cpu")
    tfed = spec.cell_config("fedpbc", scheme)
    batch = tgrid.make_cell_batch(spec, tfed, task, algos=FAMILY,
                                  device="cpu")
    assert batch.batch_size == 8
    assert batch.gen_index == [0, 1] * 4
    assert batch.algo_id.tolist() == [0, 0, 1, 1, 2, 2, 3, 3]
    batch.p_base = torch.as_tensor(np.stack([p for _, p in ref]))
    draws = JaxKeyDraws([s for _ in FAMILY for s in SEEDS], fed, jtask,
                        task.layout, ROUNDS)
    runner = tgrid.make_runner(spec, tfed, task, device="cpu")
    states, out = runner(batch, draws=draws)
    assert out["evals"].shape == (8, 2)
    assert out["metrics"]["loss"].shape == (8, ROUNDS)
    for b, ((st, evals, mets), _) in enumerate(ref):
        np.testing.assert_allclose(
            states.server[b].numpy(),
            convert.params_from_jax(np_tree(st.server), task.layout).numpy(),
            rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(out["metrics"]["num_active"][b].numpy(),
                                      np.asarray(mets["num_active"]))
        np.testing.assert_allclose(out["metrics"]["loss"][b].numpy(),
                                   np.asarray(mets["loss"]), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(out["evals"][b].numpy(), np.asarray(evals),
                                   rtol=0,
                                   atol=1.0 / task.meta["n_test"] + 1e-6)


def test_run_sweep_rows_follow_spec_order_on_cpu():
    spec = _spec(tgrid, algorithms=("fedavg", "mifa", "fedpbc"),
                 schemes=("markov_hom", "cyclic"), rounds=4, eval_every=3,
                 lrs=(0.05, 0.1))
    cells = tgrid.run_sweep(spec, device="cpu")
    order = [(c.scheme, c.algo, c.hparams["lr"]) for c in cells]
    assert order == [(s, a, lr) for s in spec.schemes
                     for a in spec.algorithms for lr in spec.lrs]
    n = tasks()[1].layout.size
    for c in cells:
        assert c.test_acc.shape == (2, 2) and c.eval_rounds == [3, 4]
        assert c.loss.shape == (2, 4) and c.server.shape == (2, n)
        assert np.isfinite(c.server).all()
        assert set(c.summary()) == {"test_acc", "train_acc"}


@pytest.mark.parametrize("K,E", [(0, 3), (3, 3), (7, 3), (6, 3), (5, 0),
                                 (2, 5)])
def test_eval_rounds_contract_matches_reference_and_runner(K, E):
    assert tsweep.eval_rounds(K, E) == jsweep.eval_rounds(K, E)
    spec = _spec(tgrid, algorithms=("fedpbc",), seeds=(0,), rounds=K,
                 eval_every=E)
    cell = tgrid.run_cell(spec, "fedpbc", "bernoulli_ti", device="cpu")
    assert cell.eval_rounds == jsweep.eval_rounds(K, E)
    assert cell.test_acc.shape == (1, len(cell.eval_rounds))
    assert cell.loss.shape == (1, K)


@pytest.mark.parametrize("kw,match", [
    (dict(algorithms=()), "algorithms is empty"),
    (dict(schemes=()), "schemes is empty"),
    (dict(seeds=()), "seeds is empty"),
    (dict(seeds=(0, 0)), "seeds contains duplicates"),
    (dict(algorithms=("fedpbc", "fedpbc")), "algorithms contains duplicates"),
    (dict(algorithms=("fedpbc", "nope")), "unknown algorithms"),
    (dict(schemes=("wifi",)), "unknown schemes"),
    (dict(task="vision"), "task="),
    (dict(strategies=()), "strategies is empty"),
    (dict(cohort_size=0), "cohort_size=0"),
])
def test_sweep_spec_validation_matches_reference(kw, match):
    with pytest.raises(ValueError, match=match):
        tgrid.SweepSpec(**kw)
    if "strategies" not in kw:
        with pytest.raises(ValueError, match=match):
            jgrid.SweepSpec(**kw)


@pytest.mark.parametrize("kw", [dict(task="lm"), dict(cohort_size=4),
                                dict(strategies=("buffered",))])
def test_later_slice_spec_knobs_raise_not_implemented(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tgrid.SweepSpec(**kw)


def test_later_slice_entry_arguments_raise_not_implemented():
    """``store=`` works since the results store was ported
    (tests/test_torch_results.py); placement and the scale/search runner
    knobs still raise, naming their ROADMAP item."""
    spec = _spec(tgrid, algorithms=("fedpbc",), seeds=(0,), rounds=1)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tgrid.run_sweep(spec, devices=[object()], device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tgrid.run_sweep(spec, mesh=object(), device="cpu")
    for kw in (dict(carry_out=True), dict(cohort_size=2),
               dict(shard_mesh=object())):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tsweep.make_batched_run_rounds(
                None, None, None, optimizer_factory=None, link_factory=None,
                source_factory=None, init_params=None, num_rounds=1,
                device="cpu", **kw)


def test_seed_generators_are_reproducible_streams():
    a, b = tsweep.seed_generators(3), tsweep.seed_generators(3)
    assert set(a) == {"params", "state", "ds", "data"}
    for k in a:
        assert torch.equal(torch.rand(5, generator=a[k]),
                           torch.rand(5, generator=b[k]))
    c = tsweep.seed_generators(4)
    assert not torch.equal(torch.rand(5, generator=a["state"]),
                           torch.rand(5, generator=c["state"]))

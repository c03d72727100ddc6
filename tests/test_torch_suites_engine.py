"""The sweep leftovers the ported suites need, against the reference.

- ``make_vmap_run_rounds`` (the seed-axis runner) on the reference's
  draws (``_torch_parity.JaxKeyDraws``) follows the reference's runner
  within 1e-5 (server, per-round losses, evals), and with the port's own
  generators its per-seed trajectories equal the port's sequential
  ``make_run_rounds`` bit for bit (the reference's ``tests/test_sweep.py``
  contract).
- ``with_label_noise`` on the reference's flip uniforms gives the
  reference's labels exactly; from a generator it flips a share near
  ``frac``, each to the next class, and the noisy dataset rides an existing
  runner (``tests/test_traced_axes.py``'s contract).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from _torch_parity import JaxKeyDraws, fed_configs, np_tree  # noqa: E402
from repro.core import make_algorithm as jmake_algorithm  # noqa: E402
from repro.core import make_link_process as jlink  # noqa: E402
from repro.experiments import sweep as jsweep  # noqa: E402
from repro.experiments import tasks as jtasks  # noqa: E402
from repro.optim import paper_decay as jdecay  # noqa: E402
from repro.optim import sgd as jsgd  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import federated as tfed  # noqa: E402
from repro_torch.core.algorithms import make_algorithm_spec  # noqa: E402
from repro_torch.core.connectivity import make_link_process  # noqa: E402
from repro_torch.experiments import grid as tgrid  # noqa: E402
from repro_torch.experiments import seed_generators  # noqa: E402
from repro_torch.experiments import tasks as ttasks  # noqa: E402
from repro_torch.experiments.sweep import make_vmap_run_rounds  # noqa: E402
from repro_torch.optim import paper_decay, sgd  # noqa: E402

SEEDS = (0, 1)
K, EVERY = 5, 2
K_REF = 4   # two chunks of EVERY: the reference compiles one chunk length
# tests/test_sweep.py's protocol
TASK = dict(num_clients=8, dim=16, hidden=16, classes=10, n_per_class=60,
            n_train=480, per_client=24, local_steps=3, batch_size=4)
SPEC = tgrid.SweepSpec(seeds=SEEDS, **TASK)


def _port_runner(task, fed, use_kernel=False, rounds=K):
    return make_vmap_run_rounds(
        task.loss_fn, sgd(paper_decay(SPEC.lr)),
        make_algorithm_spec(("fedpbc",), fed), fed, task.source,
        link_factory=lambda p: make_link_process(p, fed),
        init_params=task.init_params, num_rounds=rounds, eval_every=EVERY,
        eval_fn=task.eval_test, use_kernel=use_kernel, device="cpu")


def test_vmap_runner_on_reference_draws_matches_reference():
    scheme = "bernoulli_tv"
    jtask = jtasks.make_classification_task(data_seed=0, alpha=SPEC.alpha,
                                            **TASK)
    ttask = ttasks.make_classification_task(data_seed=0, alpha=SPEC.alpha,
                                            device="cpu", **TASK)
    jfed, tfed_cfg = fed_configs(scheme, "fedpbc", TASK["num_clients"],
                                 TASK["local_steps"])
    jrun = jsweep.make_vmap_run_rounds(
        jtask.loss_fn, jsgd(jdecay(SPEC.lr)), jmake_algorithm(jfed), jfed,
        jtask.source, link_factory=lambda p: jlink(p, jfed),
        init_params=jtask.init_params, num_rounds=K_REF, eval_every=EVERY,
        eval_fn=jtask.eval_test)
    p_base = tgrid.seed_base_probs(SPEC)     # one p_base for both runners
    jstates, jout = jrun(jsweep.stack_seed_keys(SEEDS), p_base)
    draws = JaxKeyDraws(SEEDS, jfed, jtask, ttask.layout, K_REF)
    run = _port_runner(ttask, tfed_cfg, rounds=K_REF)
    states, out = run([seed_generators(s) for s in SEEDS], p_base,
                      draws=draws)
    tol = dict(atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        states.server.numpy(),
        convert.params_from_jax(np_tree(jstates.server),
                                ttask.layout).numpy(), **tol)
    np.testing.assert_allclose(out["metrics"]["loss"].numpy(),
                               np.asarray(jout["metrics"]["loss"]), **tol)
    np.testing.assert_allclose(out["evals"].numpy(),
                               np.asarray(jout["evals"]), **tol)
    np.testing.assert_array_equal(out["metrics"]["num_active"].numpy(),
                                  np.asarray(jout["metrics"]["num_active"]))
    assert run.init_batch is not None and run.scan_batch is not None


@pytest.mark.parametrize("use_kernel", [False, True])
def test_vmap_runner_equals_sequential_make_run_rounds(use_kernel):
    """Each seed of the seed-axis runner is bit for bit that seed's own
    ``make_run_rounds`` trajectory from its generators and ``p_base``,
    the evals at the runner's cadence; ``init_batch`` + ``scan_batch``
    chain to the same run."""
    task = ttasks.make_classification_task(data_seed=0, alpha=SPEC.alpha,
                                           device="cpu", **TASK)
    fed = SPEC.cell_config("fedpbc", "bernoulli_tv")
    p_base = tgrid.seed_base_probs(SPEC)
    run = _port_runner(task, fed, use_kernel)
    states, out = run([seed_generators(s) for s in SEEDS], p_base)
    for i, seed in enumerate(SEEDS):
        algo = make_algorithm_spec(("fedpbc",), fed)
        opt = sgd(paper_decay(SPEC.lr))
        link = make_link_process(torch.as_tensor(p_base[i:i + 1]), fed)
        rr = tfed.make_run_rounds(task.loss_fn, opt, algo, link, fed,
                                  task.source, use_kernel=use_kernel,
                                  device="cpu")
        draws = tfed.GeneratorDraws([seed_generators(seed)],
                                    num_clients=fed.num_clients,
                                    pick_spec=task.source.pick_spec)
        st = tfed.init_fed_state(draws.link_init(),
                                 draws.params(task.init_params), fed, algo,
                                 link, opt)
        ds, losses, evals, t = task.source.init(), [], [], 0
        while t < K:
            n = min(EVERY, K - t)
            st, ds, mets = rr(st, ds, draws, n)
            t += n
            losses.append(mets["loss"])
            evals.append(task.eval_test(st.server))
        assert torch.equal(states.server[i], st.server[0])
        assert torch.equal(states.clients[i], st.clients[0])
        assert torch.equal(out["metrics"]["loss"][i], torch.cat(losses, 1)[0])
        assert torch.equal(out["evals"][i], torch.cat(evals))
    batch = run.batch([seed_generators(s) for s in SEEDS], p_base)
    carry, out2 = run.scan_batch(run.init_batch(batch), batch)
    assert torch.equal(carry[0].server, states.server)
    assert torch.equal(out2["evals"], out["evals"])


def test_label_noise_matches_reference_on_its_uniforms():
    jtask = jtasks.make_traced_classification_task(data_seed=0, **TASK)
    ttask = ttasks.make_traced_classification_task(data_seed=0,
                                                   device="cpu", **TASK)
    key = jax.random.PRNGKey(7)
    want = jtasks.with_label_noise(jtask.shared, key, frac=0.5, classes=10)
    u = np.array(jax.random.uniform(key, jtask.shared["y"].shape))
    got = ttasks.with_label_noise(ttask.shared, frac=0.5, classes=10,
                                  uniforms=torch.as_tensor(u))
    np.testing.assert_array_equal(got["y"].numpy(), np.asarray(want["y"]))
    for k in ("x", "xt", "yt"):
        assert got[k] is ttask.shared[k]
    # classes defaults to the labels' max + 1, as the reference's
    dflt = ttasks.with_label_noise(ttask.shared, frac=0.5,
                                   uniforms=torch.as_tensor(u))
    np.testing.assert_array_equal(dflt["y"].numpy(), got["y"].numpy())


def test_label_noise_from_a_generator_rides_the_runner():
    spec = dataclasses.replace(SPEC, rounds=4, eval_every=2)
    task = tgrid.get_traced_task(spec, "cpu")
    fed = spec.cell_config("fedpbc", "bernoulli_tv")
    g = torch.Generator().manual_seed(7)
    noisy = ttasks.with_label_noise(task.shared, g, frac=0.5, classes=10)
    y, y2 = task.shared["y"], noisy["y"]
    assert y2.shape == y.shape and y2.dtype == y.dtype
    flipped = y2 != y
    assert 0.4 < flipped.float().mean().item() < 0.6
    assert torch.equal(y2[flipped], (y[flipped] + 1) % 10)
    runner = tgrid.make_runner(spec, fed, task, device="cpu")
    batch = tgrid.make_cell_batch(spec, fed, task, device="cpu")
    _, out = runner(batch)
    _, out2 = runner(dataclasses.replace(batch, shared=noisy))
    assert not torch.equal(out["metrics"]["loss"], out2["metrics"]["loss"])
    assert len(tgrid._TRACED_TASK_CACHE) >= 1


"""``extensions``' protocol, ``paper.common.run_training``, against the
reference's ``benchmarks.common.run_training`` on the same inputs.

Both runs get the port's Eq.-9 ``p_base`` of the seed (the reference's
``build_base_probs`` is patched to return it) and the reference's key
draws (``_torch_parity.JaxKeyDraws`` of ``seed_keys(seed)``, the key layout
``run_training`` uses: params ``seed + 1``, link state ``seed + 2``, data
``seed + 4``; the port's ``GeneratorDraws`` is patched to return them). What is left to agree is the protocol itself: the per-seed
dataset, the Dirichlet partition, the federation config of the scheme,
the optimizer, the algorithm (FedPBC-M's server momentum among them) and
the eval chunks (the last one short). The test-accuracy trajectory and the
final train accuracy must agree within 1e-5.
"""
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:        # the reference's benchmarks/ (no package)
    sys.path.insert(0, ROOT)

from _torch_parity import JaxKeyDraws, fed_configs  # noqa: E402
from benchmarks import common as jcommon  # noqa: E402
from repro.experiments import tasks as jtasks  # noqa: E402
from repro_torch.core import build_base_probs  # noqa: E402
from repro_torch.experiments.tasks import mlp_layout  # noqa: E402
from repro_torch.paper import common as tcommon  # noqa: E402

M, ROUNDS, EVERY, SEED = 10, 5, 2, 1


# both schemes and both algorithms of the suite, in two runs
@pytest.mark.parametrize("scheme,algo", [("bernoulli_tv", "fedpbc"),
                                         ("markov_nonhom", "fedpbc_m")])
def test_run_training_follows_the_reference_on_its_draws(
        scheme, algo, monkeypatch):
    p, nu, r = build_base_probs(SEED, M, 10, alpha=0.1, sigma0=10.0,
                                delta=0.02)
    monkeypatch.setattr(jcommon, "build_base_probs",
                        lambda *a, **k: (jnp.asarray(p), nu, r))
    want = jcommon.run_training(algo, scheme, rounds=ROUNDS, m=M, seed=SEED,
                                eval_every=EVERY)
    jtask = jtasks.make_classification_task(data_seed=SEED, num_clients=M)
    jfed, _ = fed_configs(scheme, algo, M, 5)
    draws = JaxKeyDraws((SEED,), jfed, jtask, mlp_layout(32, 10, 64), ROUNDS)
    monkeypatch.setattr(tcommon, "GeneratorDraws", lambda *a, **k: draws)
    got = tcommon.run_training(algo, scheme, rounds=ROUNDS, m=M, seed=SEED,
                               eval_every=EVERY, device="cpu")
    assert [t for t, _ in got[0]] == [t for t, _ in want[0]] == [2, 4, 5]
    np.testing.assert_allclose([a for _, a in got[0]],
                               [a for _, a in want[0]], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[1], want[1], atol=1e-5, rtol=0)

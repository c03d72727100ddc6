"""Adaptive search on the PyTorch port (``repro_torch.experiments.search``)
against its own contracts and the JAX reference.

- The contracts of ``tests/test_search.py`` on the port: k chained rung
  segments equal one uninterrupted run bit for bit (evals, losses, every
  final-state tensor); a re-packed survivor subset with duplicates
  continues exactly as unsliced, through the same runner object; the
  controller prunes and persists, refills, stops at a target; the
  sampler; ``SearchSpec``'s validation messages.
- A batch that mixes budget levels (``FedState.round`` a ``[B]`` tensor)
  continues every row bit for bit as that row's own unmixed run.
- Port against reference, both fed the reference's draws and Eq.-9
  ``p_base``: the segment runner over two segments (the round engine's
  parity contract: 1e-5 when re-synced every round, 1e-4 over 6 rounds
  un-synced; test accuracy within one test example); one round of a mixed-round batch for
  every scheme, the quartet and mifa (1e-5, re-synced); a whole
  ``run_search(refill=True)`` makes the reference's decisions (statuses,
  levels, waves, device rounds, wave log evals within 1e-5), with every
  kept/pruned eval gap wider than that tolerance so no tie can flip.
- ``sample_point`` draws the reference's points from the same seed, bit for
  bit; ``paper.asha.run(smoke=True)`` keeps its structural bars.

Shapes follow ``tests/test_search.py`` (m = 8, dim 16, hidden 16).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import (  # noqa: E402
    FAMILY,
    SMALL,
    JaxFamily,
    JaxKeyDraws,
    assert_state_close,
    np_tree,
)
from repro import experiments as jexp  # noqa: E402
from repro.experiments import grid as jgrid  # noqa: E402
from repro.experiments import search as jsearch  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import federated as tfed  # noqa: E402
from repro_torch.experiments import grid as tgrid  # noqa: E402
from repro_torch.experiments import search as tsearch  # noqa: E402
from repro_torch.experiments import sweep as tsweep  # noqa: E402
from repro_torch.experiments.plots import export_curves  # noqa: E402
from repro_torch.experiments.results import ResultsStore, cell_key  # noqa: E402

ALGO, SCHEME = "fedpbc", "bernoulli_ti"
SEEDS = (0, 1)
S = len(SEEDS)
# the reference test's SPEC
SPEC_KW = dict(algorithms=(ALGO,), schemes=(SCHEME,), seeds=SEEDS, rounds=6,
               eval_every=3, num_clients=8, dim=16, hidden=16, classes=10,
               n_per_class=60, n_train=480, per_client=24, batch_size=4,
               local_steps=2)
SPEC = tgrid.SweepSpec(**SPEC_KW)
METRICS = ("loss", "num_active")
# the parity harness's protocol (its draws are made at these shapes)
PARITY = dict(algorithms=(ALGO,), schemes=("bernoulli_tv",), seeds=SEEDS,
              rounds=6, eval_every=3, classes=10,
              **{k: SMALL[k] for k in ("num_clients", "dim", "hidden",
                                       "per_client", "local_steps",
                                       "batch_size", "n_per_class",
                                       "n_train")})


def _parts_equal(a, b):
    """Every tensor of two carry parts (dataclasses, dicts, tuples, ints)
    bitwise equal; returns how many tensors were compared."""
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
        return 1
    if dataclasses.is_dataclass(a):
        return sum(_parts_equal(getattr(a, f.name), getattr(b, f.name))
                   for f in dataclasses.fields(a))
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        return sum(_parts_equal(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        return sum(_parts_equal(x, y) for x, y in zip(a, b))
    assert a == b
    return 0


def _batch(spec, device="cpu"):
    task = tgrid.get_traced_task(spec, device)
    fed = spec.cell_config(ALGO, spec.schemes[0])
    return task, fed, tgrid.make_cell_batch(spec, fed, task, device=device)


def _batch_rows(batch, rows):
    r = torch.as_tensor(rows)
    return dataclasses.replace(
        batch, gen_index=[batch.gen_index[i] for i in rows],
        p_base=batch.p_base[r],
        hparams={k: v[r] for k, v in batch.hparams.items()},
        data={"idx": batch.data["idx"][r]}, algo_id=batch.algo_id[r])


# ---------------------------------------------------------------------------
# the contracts of tests/test_search.py, on the port
# ---------------------------------------------------------------------------


def test_segment_resume_bit_for_bit():
    """Two chained 3-round segments == one uninterrupted 6-round run:
    evals, loss trajectories AND every carried state tensor."""
    spec = dataclasses.replace(SPEC, lrs=(0.05, 0.1))
    task, fed, batch = _batch(spec)
    rseg = tgrid.segment_runner_for(spec, ALGO, SCHEME, segment_rounds=3,
                                    metric_keys=METRICS, device="cpu")
    assert rseg.carry_out
    carry = rseg.init(batch)
    evals, losses = [], []
    for _ in range(2):
        carry, out = rseg.step(carry, batch)
        evals.append(out["evals"])
        losses.append(out["metrics"]["loss"])
    full = tgrid.make_runner(spec, fed, task, metric_keys=METRICS,
                             device="cpu")
    st_full, out_full = full(batch)
    assert torch.equal(torch.cat(evals, 1), out_full["evals"])
    assert torch.equal(torch.cat(losses, 1), out_full["metrics"]["loss"])
    assert carry[0].round == st_full.round == 6
    assert _parts_equal(carry[0], st_full) >= 8
    # the batch gives the same run again: init draws from copies
    assert torch.equal(full(batch)[0].server, st_full.server)


def test_elastic_repack_continues_unsliced_on_one_runner():
    """A survivor subset with duplicates, gathered out of a finished
    segment's carry into a fresh full-width batch, continues each row
    exactly as the unsliced batch would, through the same runner object."""
    spec = dataclasses.replace(SPEC, lrs=(0.02, 0.05, 0.1, 0.2))
    _, _, batch = _batch(spec)
    built = tgrid.segment_runner_for.built
    rseg = tgrid.segment_runner_for(spec, ALGO, SCHEME, segment_rounds=3,
                                    metric_keys=("loss",), device="cpu")
    carry1, _ = rseg.step(rseg.init(batch), batch)
    order = [2, 1, 2, 2]
    rows = np.concatenate([np.arange(p * S, (p + 1) * S) for p in order])
    carry2, out2 = rseg.step(tsweep.gather_carry(carry1, rows),
                             _batch_rows(batch, rows))
    carry_ref, out_ref = rseg.step(carry1, batch)   # carry1 stays valid
    for p_new, p_old in enumerate(order):
        new, old = slice(p_new * S, (p_new + 1) * S), slice(p_old * S,
                                                            (p_old + 1) * S)
        assert torch.equal(out2["evals"][new], out_ref["evals"][old])
        assert torch.equal(out2["metrics"]["loss"][new],
                           out_ref["metrics"]["loss"][old])
        assert torch.equal(carry2[0].server[new], carry_ref[0].server[old])
        assert torch.equal(carry2[0].clients[new], carry_ref[0].clients[old])
    # the drawer keeps one bundle per (seed, draws made)
    assert len(carry2[2].bundles) == S
    again = tgrid.segment_runner_for(dataclasses.replace(
        SPEC, lrs=(0.3, 0.4)), ALGO, SCHEME, segment_rounds=3,
        metric_keys=("loss",), device="cpu")
    assert again is rseg
    assert tgrid.segment_runner_for.built - built <= 1


def test_mixed_level_batch_continues_each_row_as_its_unmixed_run():
    """Level-1 survivors beside fresh level-0 slots, with a [B] round:
    every row continues bit for bit as in its own unmixed batch."""
    spec = dataclasses.replace(SPEC, schemes=("cyclic_reset",),
                               lrs=(0.05, 0.1),
                               fed_overrides=(("cyclic_length", 4),))
    _, _, batch = _batch(spec)
    rseg = tgrid.segment_runner_for(spec, ALGO, "cyclic_reset",
                                    segment_rounds=3, metric_keys=METRICS,
                                    device="cpu")
    level1, _ = rseg.step(rseg.init(batch), batch)
    fresh = rseg.init(batch)
    mask = np.repeat([True, False], S)       # point 0 carried, point 1 new
    mixed = tsweep.select_carry(mask, level1, fresh)
    assert mixed[0].round.tolist() == [3, 3, 0, 0]
    carry_m, out_m = rseg.step(mixed, batch)
    carry_1, out_1 = rseg.step(level1, batch)
    carry_0, out_0 = rseg.step(fresh, batch)
    assert carry_m[0].round.tolist() == [6, 6, 3, 3]
    for rows, (carry_u, out_u) in ((slice(0, S), (carry_1, out_1)),
                                   (slice(S, 2 * S), (carry_0, out_0))):
        assert torch.equal(out_m["evals"][rows], out_u["evals"][rows])
        for k in METRICS:
            assert torch.equal(out_m["metrics"][k][rows],
                               out_u["metrics"][k][rows])
        st_m, st_u = carry_m[0], carry_u[0]
        for name in ("server", "clients", "last_active"):
            assert torch.equal(getattr(st_m, name)[rows],
                               getattr(st_u, name)[rows])
        assert torch.equal(st_m.link_state["offset"][rows],
                           st_u.link_state["offset"][rows])
        assert torch.equal(st_m.opt_state["step"][rows],
                           st_u.opt_state["step"][rows])


def test_run_search_prunes_and_persists(tmp_path):
    """A 4-candidate / eta=2 / 2-rung search prunes half the population at
    rung 1, spends fewer device rounds than the grid, persists every
    candidate with rung/budget provenance (distinct cell keys), and the
    mixed-length store exports."""
    search = tsearch.SearchSpec(base=SPEC, rung_rounds=3, eta=2,
                                num_candidates=4, batch_points=2,
                                space=(("lr", ("log", 0.02, 0.3)),),
                                search_seed=0)
    store = ResultsStore(str(tmp_path / "search"))
    built = tgrid.segment_runner_for.built
    out = tsearch.run_search(search, store=store, suite="t",
                             metric_keys=METRICS, device="cpu")
    assert sorted(c.status for c in out.candidates) == [
        "finished", "finished", "pruned", "pruned"]
    assert sorted(c.level * 3 for c in out.candidates) == [3, 3, 6, 6]
    assert out.total_device_rounds == 36 < 4 * S * SPEC.rounds
    assert out.waves == 2 and len(out.wave_log) == 2
    assert out.wave_log[-1]["device_rounds"] == 36
    assert out.best.status == "finished"
    assert out.best.last_eval == max(c.last_eval for c in out.candidates)
    assert out.compile_entries == {"init": None, "scan": None,
                                   "agg_kernel": 0}
    assert out.wave_batches == [[(0, 0), (0, 0)], [(1, 1)]]
    assert out.mixed_batches == 0
    assert tgrid.segment_runner_for.built - built <= 1

    rows = store.records(suite="t")
    assert len(rows) == 4
    assert len({cell_key(r) for r in rows}) == 4
    by_cid = {r["search"]["cid"]: r for r in rows}
    for c in out.candidates:
        r = by_cid[c.cid]
        assert r["search"]["budget_rounds"] == r["rounds"] == c.level * 3
        assert r["search"]["status"] == c.status
        assert r["search"]["rung_rounds"] == 3
        assert r["eval_rounds"] == [3 * (i + 1) for i in range(c.level)]
        arrs = store.load_arrays(r)
        assert arrs["test_acc"].shape == (S, c.level)
        assert arrs["loss"].shape == (S, c.level * 3)
        assert arrs["num_active"].dtype == np.int32
        assert r["summary"]["test_acc"]["n"] == S
    pruned = next(r for r in rows if r["search"]["status"] == "pruned")
    fin = next(r for r in rows if r["search"]["status"] == "finished")
    clone = dict(fin, hparams=pruned["hparams"], rounds=pruned["rounds"],
                 eval_every=pruned["eval_every"], spec=pruned["spec"])
    assert cell_key(clone) != cell_key(pruned)
    written = export_curves(store, str(tmp_path / "curves"), suite="t")
    assert len(written) == 8        # one acc + one loss CSV per candidate


def test_run_search_refill_fills_freed_slots():
    """refill=True tops partial batches up with fresh level-0 candidates,
    bounded by max_candidates; fresh candidates are ranked against their
    own budget level only."""
    search = tsearch.SearchSpec(
        base=SPEC, rung_rounds=3, eta=2, num_candidates=3, batch_points=2,
        refill=True, max_candidates=5,
        space=(("lr", ("choice", (0.02, 0.05, 0.1, 0.2))),), search_seed=1)
    out = tsearch.run_search(search, metric_keys=METRICS, device="cpu")
    assert 4 <= len(out.candidates) <= 5
    assert all(c.evals for c in out.candidates)
    assert {c.status for c in out.candidates} <= {"finished", "pruned"}
    assert any(c.status == "finished" for c in out.candidates)
    for c in out.candidates:
        assert 1 <= c.level <= search.max_level


def test_search_target_stops_early():
    search = tsearch.SearchSpec(base=SPEC, rung_rounds=3, eta=2,
                                num_candidates=2,
                                space=(("lr", ("log", 0.05, 0.2)),),
                                target=0.0)
    out = tsearch.run_search(search, metric_keys=METRICS, device="cpu")
    assert out.target_hit
    assert out.waves == 1
    assert all(c.status in ("stopped", "finished") for c in out.candidates)
    assert out.device_rounds_to(0.0) == out.total_device_rounds


def test_sample_point_respects_space_and_defaults():
    rng = np.random.default_rng(0)
    search = tsearch.SearchSpec(base=SPEC, rung_rounds=3,
                                space=(("lr", ("log", 0.01, 0.5)),
                                       ("gamma", ("choice", (0.25, 0.75)))))
    for _ in range(16):
        pt = tsearch.sample_point(rng, search)
        assert 0.01 <= pt["lr"] <= 0.5
        assert pt["gamma"] in (0.25, 0.75)
        assert pt["alpha"] == SPEC.alpha and pt["delta"] == SPEC.delta


def test_sample_point_draws_the_reference_points_bit_for_bit():
    space = (("lr", ("log", 0.01, 0.5)), ("gamma", ("uniform", 0.1, 0.9)),
             ("alpha", ("choice", (0.1, 0.3, 1.0))))
    jspec = jgrid.SweepSpec(**SPEC_KW)
    ours = tsearch.SearchSpec(base=SPEC, rung_rounds=3, space=space)
    theirs = jsearch.SearchSpec(base=jspec, rung_rounds=3, space=space)
    r1, r2 = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(32):
        assert tsearch.sample_point(r1, ours) == jsearch.sample_point(r2,
                                                                      theirs)


@pytest.mark.parametrize("kw,msg", [
    (dict(rung_rounds=4), "must divide"),
    (dict(rung_rounds=3, eta=1), "eta"),
    (dict(rung_rounds=3, space=(("bogus", ("log", 0.1, 1.0)),)),
     "not a hyperparameter"),
    (dict(rung_rounds=3, space=(("lr", ("geometric", 0.1, 1.0)),)), "kind"),
    (dict(rung_rounds=3, space=(("lr", ("log", 1.0, 0.1)),)), "lo < hi"),
    (dict(rung_rounds=3, refill=True), "refill"),
    (dict(rung_rounds=3, points=()), "points"),
    (dict(rung_rounds=3, num_candidates=4, max_candidates=2),
     "max_candidates"),
    (dict(rung_rounds=3, points=({"lr": 0.1, "bogus": 1.0},)), "unknown"),
])
def test_searchspec_validation_matches_reference(kw, msg):
    with pytest.raises(ValueError, match=msg) as ours:
        tsearch.SearchSpec(base=SPEC, **kw)
    with pytest.raises(ValueError) as theirs:
        jsearch.SearchSpec(base=jgrid.SweepSpec(**SPEC_KW), **kw)
    assert str(ours.value) == str(theirs.value)


def test_searchspec_rejects_multi_cell_base():
    with pytest.raises(ValueError, match="one"):
        tsearch.SearchSpec(base=dataclasses.replace(
            SPEC, algorithms=("fedpbc", "fedavg")), rung_rounds=3)
    with pytest.raises(ValueError, match="swept axes"):
        tsearch.SearchSpec(base=dataclasses.replace(SPEC, lrs=(0.1, 0.2)),
                           rung_rounds=3)


def test_experiments_package_exports_the_search_api():
    from repro_torch import experiments as texp

    for name in ("SearchSpec", "run_search", "sample_point",
                 "SearchOutcome"):
        assert getattr(texp, name) is getattr(tsearch, name)
        assert hasattr(jexp, name)


# ---------------------------------------------------------------------------
# port against reference, on the reference's draws
# ---------------------------------------------------------------------------


def _specs(**kw):
    return (jgrid.SweepSpec(**dict(PARITY, **kw)),
            tgrid.SweepSpec(**dict(PARITY, **kw)))


def _key_draws(jspec, tspec, num_rounds):
    """A drawer factory handing each row its seed's reference draws."""
    jtask = jgrid.get_traced_task(jspec)
    task = tgrid.get_traced_task(tspec, "cpu")
    fed = jspec.cell_config(ALGO, jspec.schemes[0])
    base = JaxKeyDraws(list(jspec.seeds), fed, jtask, task.layout,
                       num_rounds)
    pos = {s: i for i, s in enumerate(jspec.seeds)}
    return lambda seeds: base.take([pos[s] for s in seeds])


def _reference_p_base(spec, point):
    jspec = jgrid.SweepSpec(**dict(PARITY, seeds=tuple(spec.seeds)))
    return np.asarray(jgrid.point_base_probs(jspec, point))


def test_segment_runner_matches_reference_over_two_segments():
    jspec, tspec = _specs(lrs=(0.05, 0.1))
    scheme = "bernoulli_tv"
    jtask = jgrid.get_traced_task(jspec)
    jfed = jspec.cell_config(ALGO, scheme)
    jbatch = jgrid.make_cell_batch(jspec, jfed, jtask)
    jseg = jgrid.segment_runner_for(jspec, ALGO, scheme, segment_rounds=3,
                                    metric_keys=METRICS)
    task, _, batch = _batch(tspec)
    batch.p_base = torch.as_tensor(np.asarray(jbatch.p_base))
    rseg = tgrid.segment_runner_for(tspec, ALGO, scheme, segment_rounds=3,
                                    metric_keys=METRICS, device="cpu")
    seeds = [s for _ in tspec.lrs for s in tspec.seeds]
    draws = _key_draws(jspec, tspec, 6)(seeds)
    jcarry, carry = jseg.init(jbatch), rseg.init(batch, draws)
    for _ in range(2):
        jcarry, jout = jseg.step(jcarry, jbatch)
        carry, out = rseg.step(carry, batch)
        np.testing.assert_array_equal(out["metrics"]["num_active"].numpy(),
                                      np.asarray(jout["metrics"]
                                                 ["num_active"]))
        np.testing.assert_allclose(out["metrics"]["loss"].numpy(),
                                   np.asarray(jout["metrics"]["loss"]),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(out["evals"].numpy(),
                                   np.asarray(jout["evals"]), rtol=0,
                                   atol=1.0 / task.meta["n_test"] + 1e-6)
    assert_state_close(carry[0], np_tree(jcarry[0]), task.layout, atol=1e-4,
                       rtol=1e-4)
    # re-synced: one-round segments from the reference's carry, 1e-5
    jone = jgrid.segment_runner_for(jspec, ALGO, scheme, segment_rounds=1,
                                    metric_keys=METRICS)
    rone = tgrid.segment_runner_for(tspec, ALGO, scheme, segment_rounds=1,
                                    metric_keys=METRICS, device="cpu")
    jcarry = jone.init(jbatch)
    for _ in range(3):
        ps = convert.fed_state_from_jax(np_tree(jcarry[0]), task.layout,
                                        "bernoulli")
        (ps, _, _), out = rone.step((ps, batch.data, draws), batch)
        jcarry, jout = jone.step(jcarry, jbatch)
        np.testing.assert_allclose(out["metrics"]["loss"].numpy(),
                                   np.asarray(jout["metrics"]["loss"]),
                                   rtol=1e-5, atol=1e-5)
        assert_state_close(ps, np_tree(jcarry[0]), task.layout, atol=1e-5,
                           rtol=1e-5)


MIXED_T = np.array([0, 0, 3, 3, 0, 0, 3, 3])


@pytest.mark.parametrize("family", [FAMILY, ("mifa",)],
                         ids=["quartet", "mifa"])
@pytest.mark.parametrize("scheme", list(jgrid.SCHEMES))
def test_mixed_round_batch_matches_reference_vmapped_round(scheme, family):
    """One batch with trajectories at rounds [0, 0, 3, 3, ...] (a [B] round
    in the port), two rounds re-synced, against the reference's vmapped
    round at the same per-trajectory rounds."""
    ids = [0, 1, 2, 3, 0, 1, 2, 3] if family == FAMILY else [0] * 8
    fam = JaxFamily(scheme, seeds=tuple(range(8)), algo_ids=ids,
                    family=family)
    step, ds = fam.port_parts(use_kernel=False)
    st0 = fam.init()
    st = st0
    for _ in range(3):
        _, pick, _ = fam.draws(st)
        st, _ = fam.round(st, pick)
    later = jnp.asarray(MIXED_T == 3)
    st = jax.tree.map(lambda a, b: jnp.where(
        later.reshape((-1,) + (1,) * (a.ndim - 1)), a, b), st, st0)
    np.testing.assert_array_equal(np.asarray(st.round), MIXED_T)
    for _ in range(2):
        u, pick, off = fam.draws(st)
        ps = fam.port_state(st, off)
        assert isinstance(ps.round, torch.Tensor)
        ps, _, mets = step(ps, ds, tfed.RoundDraws(torch.as_tensor(u),
                                                  torch.as_tensor(pick)))
        st, jm = fam.round(st, pick)
        np.testing.assert_array_equal(mets["active"].numpy(),
                                      np.asarray(jm["active"]))
        np.testing.assert_array_equal(mets["staleness"].numpy(),
                                      np.asarray(jm["staleness"]))
        np.testing.assert_allclose(mets["loss"].numpy(),
                                   np.asarray(jm["loss"]), rtol=1e-5,
                                   atol=1e-5)
        assert_state_close(ps, np_tree(st), fam.layout, atol=1e-5, rtol=1e-5)
        if fam.tfed_cfg.scheme == "markov":
            np.testing.assert_array_equal(ps.link_state.numpy(),
                                          np.asarray(st.link_state))
        if "mifa" in family:
            np.testing.assert_allclose(
                ps.algo_state.mem.numpy(),
                convert.params_from_jax(np_tree(st.algo_state.mem),
                                        fam.layout).numpy().reshape(
                                            ps.algo_state.mem.shape),
                rtol=1e-5, atol=1e-5)


def test_run_search_with_refill_makes_the_reference_decisions():
    """The whole controller on both packages, the port fed the reference's
    draws and p_base: same statuses, levels, waves, device rounds and wave
    log, and at least one batch mixing budget levels."""
    kw = dict(schemes=(SCHEME,), rounds=9)
    jspec, tspec = _specs(**kw)
    space = (("lr", ("choice", (0.02, 0.05, 0.1, 0.2))),)
    common = dict(rung_rounds=3, eta=2, num_candidates=2, batch_points=2,
                  refill=True, max_candidates=5, space=space, search_seed=3)
    ref = jsearch.run_search(jsearch.SearchSpec(base=jspec, **common),
                             metric_keys=METRICS)
    out = tsearch.run_search(tsearch.SearchSpec(base=tspec, **common),
                             metric_keys=METRICS, device="cpu",
                             draws_factory=_key_draws(jspec, tspec, 9),
                             p_base_factory=_reference_p_base)
    assert out.mixed_batches >= 1
    assert [(c.cid, c.point, c.status, c.level, c.rung)
            for c in out.candidates] == [
        (c.cid, c.point, c.status, c.level, c.rung) for c in ref.candidates]
    assert out.waves == ref.waves
    assert out.total_device_rounds == ref.total_device_rounds
    assert [e["device_rounds"] for e in out.wave_log] == [
        e["device_rounds"] for e in ref.wave_log]
    tol = 1e-5
    np.testing.assert_allclose([e["best_eval"] for e in out.wave_log],
                               [e["best_eval"] for e in ref.wave_log],
                               rtol=0, atol=tol)
    for c, r in zip(out.candidates, ref.candidates):
        np.testing.assert_allclose(c.evals, r.evals, rtol=0, atol=tol)
    # no decision rests on a gap the tolerance could close: at each level,
    # evals that differ differ by more than it, and evals that tie (the
    # same point's trajectories, or the same count of test examples) tie
    # exactly in both packages, so both break them by cid
    for lv in range(1, tsearch.SearchSpec(base=tspec, **common).max_level
                    + 1):
        vals = np.unique([c.evals[lv - 1] for c in ref.candidates
                          if c.level >= lv])
        assert (np.diff(vals) > tol).all()
        by_val = {}
        for c, r in zip(out.candidates, ref.candidates):
            if r.level >= lv:
                by_val.setdefault(r.evals[lv - 1], set()).add(
                    c.evals[lv - 1])
        assert all(len(v) == 1 for v in by_val.values())


# ---------------------------------------------------------------------------
# the ASHA-vs-grid suite
# ---------------------------------------------------------------------------


def test_asha_smoke_keeps_its_structural_bars():
    from repro_torch.paper import asha

    res = asha.run(csv=False, smoke=True, device="cpu")
    assert res["bench"] == "asha_vs_grid" and res["smoke"]
    assert set(res) == {"bench", "smoke", "protocol", "baseline", "grid",
                        "asha", "speedup", "compile_entries",
                        "resume_max_abs_diff"}
    assert res["asha"]["device_rounds"] < res["grid"]["device_rounds"]
    assert res["resume_max_abs_diff"] == 0.0
    assert res["compile_entries"]["segment_runners"] <= 1
    assert res["compile_entries"]["agg_kernel"] == 0
    assert sum(res["asha"]["statuses"].values()) == res["asha"]["candidates"]

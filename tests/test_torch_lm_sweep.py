"""The port's LM sweep task (``SweepSpec(task="lm")``:
``experiments.tasks.make_traced_lm_task``, ``data.sources.traced_lm_source``
and the LM sources' ``sample_cohort``) against the JAX reference on the CPU,
at the sizes of ``tests/test_lm_sweep.py``'s ``LM`` spec (d_model 32, 1
layer, sequences of 16, m = 4; ``_torch_parity.LM_SMALL``).

Tolerances, each with its reason:
- the reduced config, the corpus bytes, the partition and every source's
  batches on the same picks: exact (the same numpy calls, the same
  gathers);
- the loss at ``[B, m, n]``: fp32 1e-5 (the same operations, products and
  reductions in another order);
- the evals: equal (next-token accuracy counts argmax hits; the logits
  differ by ~1e-6, far below any top-2 gap of these random models);
- one quartet round re-synced from the reference: 1e-5; three rounds
  without re-syncing: 1e-4 (the same, compounded); one LM cohort round
  (m = 8, C = 2): 1e-5.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import (  # noqa: E402
    FAMILY,
    LM_SMALL,
    LR,
    JaxFamily,
    assert_state_close,
    fed_configs,
    lm_tasks,
    np_tree,
    task_batches,
)
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.core import algorithms as jalg  # noqa: E402
from repro.core import connectivity as jconn  # noqa: E402
from repro.core import federated as jfed  # noqa: E402
from repro.data import sources as jsources  # noqa: E402
from repro.experiments import grid as jgrid  # noqa: E402
from repro.experiments import sweep as jsweep  # noqa: E402
from repro.experiments import tasks as jtasks  # noqa: E402
from repro.optim import paper_decay as jdecay, sgd as jsgd  # noqa: E402
from repro.scale import participation as jpart  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import algorithms as talg  # noqa: E402
from repro_torch.core import connectivity as tconn  # noqa: E402
from repro_torch.core import federated as tfed  # noqa: E402
from repro_torch.data import lm_source  # noqa: E402
from repro_torch.experiments import ResultsStore  # noqa: E402
from repro_torch.experiments import grid as tgrid  # noqa: E402
from repro_torch.experiments import sweep as tsweep  # noqa: E402
from repro_torch.experiments import tasks as ttasks  # noqa: E402
from repro_torch.optim import paper_decay as tdecay, sgd as tsgd  # noqa: E402
from repro_torch.scale.buffer import BufferState  # noqa: E402

ARCH = "smollm-135m"
METRIC_KEYS = ("loss", "num_active")
K_ROUNDS = 3


def _spec(module, **kw):
    """``tests/test_lm_sweep.py``'s ``LM`` spec in either package."""
    base = dict(algorithms=FAMILY, schemes=("bernoulli_ti",), seeds=(0, 1),
                rounds=3, eval_every=2, num_clients=4, local_steps=2,
                batch_size=1, per_client=8, lrs=(0.05, 0.1), task="lm",
                lm_d_model=32, lm_layers=1, lm_seq=16, classes=4,
                lm_n_seqs=64, lm_n_test=16)
    base.update(kw)
    return module.SweepSpec(**base)


@pytest.fixture(scope="module")
def lm():
    return lm_tasks()


def _server_params(jtask, ttask, lead):
    """The reference's initial params for ``prod(lead)`` keys, ``[*lead,
    ...]`` numpy leaves and the port's flat ``[*lead, n]``."""
    keys = jax.random.split(jax.random.PRNGKey(7), int(np.prod(lead)))
    tree = jax.tree.map(lambda x: np.asarray(x).reshape(lead + x.shape[1:]),
                        jax.vmap(jtask.init_params)(keys))
    return tree, convert.params_from_jax(tree, ttask.layout)


# ---------------------------------------------------------------------------
# config, corpus, partition, sources
# ---------------------------------------------------------------------------


def test_reduced_config_matches_reference_field_for_field():
    port = reduced(get_config(ARCH), d_model=32, layers=1)
    ref = jreduced(jget_config(ARCH), d_model=32, layers=1)
    for f in dataclasses.fields(port):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(a):
            assert dataclasses.asdict(a) == dataclasses.asdict(b), f.name
        else:
            assert a == b, f.name
    assert port.head_dim == 8 and port.attention.num_kv_heads == 2


def test_corpus_and_partition_match_reference_byte_for_byte(lm):
    jt, tt = lm
    for k in ("toks", "toks_t"):
        np.testing.assert_array_equal(tt.shared[k].numpy(),
                                      np.asarray(jt.shared[k]))
    for alpha in (0.1, 1.0):
        np.testing.assert_array_equal(tt.partition(alpha),
                                      jt.partition(alpha))
    assert tt.meta == jt.meta
    kw = dict(n=10, seq_len=7, vocab=512, classes=3)
    got = ttasks._styled_corpus(np.random.default_rng(3), **kw)
    want = jtasks._styled_corpus(np.random.default_rng(3), **kw)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_traced_lm_source_matches_reference_on_the_same_picks(lm):
    jt, tt = lm
    idx = jt.partition(0.1)
    m, pc = idx.shape
    s, b, B, C = LM_SMALL["local_steps"], LM_SMALL["batch_size"], 2, 2
    jsrc = jt.source_factory(jt.shared)
    tsrc = tt.source_factory(tt.shared)
    jds = jsrc.init(jax.random.PRNGKey(0), {"idx": jnp.asarray(idx)})
    tds = tsrc.init({"idx": torch.as_tensor(
        np.broadcast_to(idx, (B,) + idx.shape).copy())})
    keys = [jax.random.PRNGKey(10 + r) for r in range(B)]
    cohort = np.array([[3, 0], [1, 2]])

    def same(port, refs):
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(
                port[k].numpy(), np.stack([np.asarray(r[k]) for r in refs]))

    pick = np.stack([np.asarray(jax.random.randint(k, (m, s, b), 0, pc))
                     for k in keys])
    got, _ = tsrc.sample(tds, 0, torch.as_tensor(pick))
    same(got, [jsrc.sample(jds, 0, k)[0] for k in keys])
    assert got["tokens"].shape == (B, m, s, b, LM_SMALL["seq_len"])
    pick = np.stack([np.asarray(jax.random.randint(k, (C, s, b), 0, pc))
                     for k in keys])
    got, _ = tsrc.sample_cohort(tds, 0, torch.as_tensor(cohort),
                                torch.as_tensor(pick))
    same(got, [jsrc.sample_cohort(jds, 0, k, jnp.asarray(c))[0]
               for k, c in zip(keys, cohort)])


@pytest.mark.parametrize("client_shift", [True, False])
def test_lm_source_sample_cohort_matches_reference(client_shift):
    m, s, b, T, V, B = 6, 2, 2, 5, 64, 2
    kw = dict(num_clients=m, local_steps=s, batch=b, seq=T, vocab=V,
              client_shift=client_shift)
    jsrc, tsrc = jsources.lm_source(**kw), lm_source(**kw)
    init_keys = [jax.random.PRNGKey(r) for r in range(B)]
    keys = [jax.random.PRNGKey(20 + r) for r in range(B)]
    jds = [jsrc.init(k) for k in init_keys]
    tds = tsrc.init(torch.as_tensor(np.stack(
        [np.asarray(d["lo"]) for d in jds])) if client_shift else None)
    cohort = np.array([[5, 1, 2], [0, 4, 3]])
    pick = np.stack([np.asarray(jax.random.randint(k, (3, s, b, T), 0,
                                                   V // 2)) for k in keys])
    got, _ = tsrc.sample_cohort(tds, 0, torch.as_tensor(cohort),
                                torch.as_tensor(pick))
    refs = [jsrc.sample_cohort(d, 0, k, jnp.asarray(c))[0]
            for d, k, c in zip(jds, keys, cohort)]
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(
            got[k].numpy(), np.stack([np.asarray(r[k]) for r in refs]))


# ---------------------------------------------------------------------------
# the task's loss and evals
# ---------------------------------------------------------------------------


def test_loss_at_b_m_n_matches_reference_vmapped_loss(lm):
    jt, tt = lm
    B, m = 2, LM_SMALL["num_clients"]
    tree, flat = _server_params(jt, tt, (B, m))
    idx = jt.partition(0.1)
    pick = np.random.default_rng(0).integers(
        0, idx.shape[1], (B, m, 1, LM_SMALL["batch_size"]))
    batch = {k: v[:, :, 0] for k, v in task_batches(jt, idx, pick).items()}
    want = jax.vmap(jax.vmap(jt.loss_fn))(jax.tree.map(jnp.asarray, tree),
                                         batch)
    got = tt.loss_fn(flat, {k: torch.as_tensor(np.array(v))
                            for k, v in batch.items()})
    assert got.shape == (B, m)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_evals_match_reference_in_one_chunk_and_in_many(lm, monkeypatch):
    jt, tt = lm
    B = 3
    tree, flat = _server_params(jt, tt, (B,))
    params = jax.tree.map(jnp.asarray, tree)
    for name in ("eval_test", "eval_train"):
        want = np.asarray(jax.vmap(lambda p: getattr(jt, name)(
            p, jt.shared))(params))
        with torch.no_grad():
            got = getattr(tt, name)(flat, tt.shared)
        np.testing.assert_array_equal(got.numpy(), want)
        # 5 sequences a chunk: the eval walks ragged chunks
        monkeypatch.setattr(ttasks, "EVAL_LOGITS",
                            B * LM_SMALL["seq_len"] * 512 * 5)
        with torch.no_grad():
            np.testing.assert_array_equal(
                getattr(tt, name)(flat, tt.shared).numpy(), want)
        monkeypatch.undo()


# ---------------------------------------------------------------------------
# engine rounds
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def family():
    """The quartet, one member and seed per trajectory, on the LM task."""
    return JaxFamily("bernoulli_tv", seeds=(0, 1, 2, 3), algo_ids=(0, 1, 2, 3),
                     task="lm")


def test_quartet_round_resynced_every_round_matches_reference(family):
    step, ds = family.port_parts(use_kernel=True)
    st = family.init()
    for _ in range(K_ROUNDS):
        u, pick, off = family.draws(st)
        ps = family.port_state(st, off)
        ps, _, mets = step(ps, ds, tfed.RoundDraws(torch.as_tensor(u),
                                                  torch.as_tensor(pick)))
        st, jm = family.round(st, pick)
        np.testing.assert_array_equal(mets["active"].numpy(),
                                      np.asarray(jm["active"]))
        np.testing.assert_allclose(mets["loss"].numpy(),
                                   np.asarray(jm["loss"]), rtol=1e-5,
                                   atol=1e-5)
        assert_state_close(ps, np_tree(st), family.layout, atol=1e-5,
                           rtol=1e-5)


def test_quartet_three_rounds_without_resync_match_reference(family):
    step, ds = family.port_parts(use_kernel=False)
    st = family.init()
    ps = family.port_state(st)
    for _ in range(K_ROUNDS):
        u, pick, _ = family.draws(st)
        ps, ds, _ = step(ps, ds, tfed.RoundDraws(torch.as_tensor(u),
                                                 torch.as_tensor(pick)))
        st, _ = family.round(st, pick)
    assert_state_close(ps, np_tree(st), family.layout, atol=1e-4, rtol=1e-4)


def test_lm_cohort_round_matches_reference():
    """One cohort round (m = 8, C = 2, stateless clients, fedpbc and
    fedavg) from the reference's initial state, on the reference's
    cohort, link uniforms and picks."""
    m, C, seeds = 8, 2, (0, 1)
    jt, tt = lm_tasks(num_clients=m)
    meta = jt.meta
    s, b, pc = meta["local_steps"], meta["batch_size"], meta["per_client"]
    jcfg, tcfg = fed_configs("bernoulli_tv", "fedpbc", m, s)
    family = FAMILY[:2]
    jspec = jalg.make_algorithm_spec(family, jcfg)
    idx = jt.partition(0.1)
    keys = jsweep.stack_seed_keys(seeds)
    p_base = jnp.stack([jconn.build_base_probs(jax.random.PRNGKey(sd), m,
                                               10)[0] for sd in seeds])
    aid = jnp.arange(len(seeds), dtype=jnp.int32)
    lr = jnp.float32(LR)

    def link(p):
        return jconn.make_link_process(p, jcfg, gamma=jnp.float32(0.5),
                                       period=jnp.float32(6.0))

    def init_one(k, p):
        return jfed.init_fed_state(
            k["state"], jt.init_params(k["params"]), jcfg, jspec, link(p),
            jsgd(jdecay(lr)), stateless_clients=True, buffered=True)

    source = jt.source_factory(jt.shared)
    ds = {"idx": jnp.asarray(idx)}

    def round_one(st, data_key, p, a):
        rf = jfed.make_round_fn(jt.loss_fn, jsgd(jdecay(lr)), jspec, link(p),
                                jcfg, algo_id=a, cohort_size=C)
        st, _, mets = rf(st, ds, jax.random.fold_in(data_key, st.round),
                         source)
        return st, mets

    def draws_one(st, data_key):
        _, k_link, k_cohort = jax.random.split(st.key, 3)
        cohort = jpart.sample_cohort(k_cohort, m, C)
        u = jax.random.uniform(k_link, (m,))
        pick = jax.random.randint(jax.random.fold_in(data_key, st.round),
                                  (C, s, b), 0, pc)
        return u, cohort, pick

    st = jax.jit(jax.vmap(init_one))(keys, p_base)
    u, cohort, pick = (np.asarray(x) for x in jax.jit(jax.vmap(draws_one))(
        st, keys["data"]))
    st_np = np_tree(st)
    new, jm = jax.jit(jax.vmap(round_one))(st, keys["data"], p_base, aid)

    layout = tt.layout
    server = convert.params_from_jax(st_np.server, layout)
    tspec = talg.make_algorithm_spec(family, tcfg)
    buf = st_np.buffer
    ps = tfed.FedState(
        server=server, clients=server.new_empty((len(seeds), 0,
                                                 server.shape[1])),
        opt_state={}, algo_state=tspec.init(server, m), link_state=(),
        round=0, last_active=torch.tensor(st_np.last_active),
        buffer=BufferState(
            acc=convert.params_from_jax(buf.acc, layout),
            **{k: torch.tensor(np.asarray(getattr(buf, k))) for k in
               ("weight", "count", "since", "age_sum", "in_buffer",
                "commits")}))
    tp = torch.tensor(np.asarray(p_base))
    rf = tfed.make_round_fn(
        tt.loss_fn, tsgd(tdecay(torch.full((len(seeds),), LR))), tspec,
        tconn.make_link_process(tp, tcfg, gamma=torch.full((2,), 0.5),
                                period=torch.full((2,), 6.0)),
        tcfg, algo_id=torch.arange(len(seeds)), cohort_size=C)
    src = tt.source_factory(tt.shared)
    tds = src.init({"idx": torch.as_tensor(np.broadcast_to(
        idx, (len(seeds),) + idx.shape).copy())})
    ps, _, mets = tfed.make_round_step(rf, src)(
        ps, tds, tfed.RoundDraws(torch.tensor(u), torch.tensor(pick),
                                 torch.tensor(cohort).long()))
    new = np_tree(new)
    np.testing.assert_array_equal(mets["active"].numpy(),
                                  np.asarray(jm["active"]))
    np.testing.assert_allclose(mets["loss"].numpy(), np.asarray(jm["loss"]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        ps.server.numpy(),
        convert.params_from_jax(new.server, layout).numpy(), rtol=1e-5,
        atol=1e-5)
    np.testing.assert_allclose(
        ps.buffer.acc.numpy(),
        convert.params_from_jax(new.buffer.acc, layout).numpy(), rtol=1e-5,
        atol=1e-5)
    np.testing.assert_array_equal(ps.last_active.numpy(), new.last_active)


# ---------------------------------------------------------------------------
# the sweep and its CLI
# ---------------------------------------------------------------------------


def test_lm_sweep_runs_single_device():
    """``tests/test_lm_sweep.py::test_lm_sweep_runs_single_device`` on the
    port: rows in grid order, the algorithm axis live (members diverge),
    losses finite."""
    spec = _spec(tgrid, algorithms=("fedpbc", "fedavg"), seeds=(0,),
                 lrs=(0.1,))
    cells = tgrid.run_sweep(spec, metric_keys=METRIC_KEYS, device="cpu")
    assert [c.algo for c in cells] == ["fedpbc", "fedavg"]
    for c in cells:
        assert c.test_acc.shape == (1, 2)     # evals at rounds 2 and 3
        assert np.isfinite(c.loss).all()
    assert cells[0].loss.tobytes() != cells[1].loss.tobytes()


def test_lm_task_is_cached_by_its_knobs_and_keyed_like_the_reference():
    spec = _spec(tgrid)
    task = tgrid.get_traced_task(spec, device="cpu")
    assert task is tgrid.get_traced_task(spec, device="cpu")
    assert isinstance(task, ttasks.LMTask)
    wider = dataclasses.replace(spec, lm_d_model=64)
    assert tgrid.get_traced_task(wider, device="cpu") is not task
    assert tgrid._task_key(spec) == jgrid._task_key(_spec(jgrid))


def test_sweep_cli_runs_the_lm_task_one_row_per_cell(tmp_path, capsys):
    tsweep.main(["--device", "cpu", "--task", "lm", "--algos",
                 ",".join(FAMILY), "--seeds", "0", "--rounds", "2",
                 "--eval-every", "1", "--clients", "4", "--local-steps", "1",
                 "--lm-d-model", "32", "--lm-layers", "1", "--lm-seq", "16",
                 "--lrs", "0.05,0.1", "--out", str(tmp_path / "s"),
                 "--suite", "lm-cli"])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("sweep,bernoulli_ti")]
    rows = ResultsStore(str(tmp_path / "s")).records(suite="lm-cli")
    assert len(rows) == len(lines) == len(FAMILY) * 2
    assert {r["spec"]["task"] for r in rows} == {"lm"}
    assert {(r["spec"]["lm_d_model"], r["spec"]["lm_seq"])
            for r in rows} == {(32, 16)}

"""Cross-device scale in the PyTorch port (``repro_torch.scale`` and the
scale round engines) against the JAX reference (``repro.scale``).

The same inputs come from numpy seeds; the draws (link uniforms, cohorts,
batch indices) are computed with ``jax.random`` from the reference's own
keys and handed to the port. Tolerances: the buffer fold and the cohort
branches fp32 within 1e-6 (counts, clocks, commits and memberships exact);
the round engines within 1e-5 when re-synced from the reference every
round and within 1e-4 over 10 rounds un-synced (PR 11's contracts). The
ported contracts of ``tests/test_scale.py`` and ``tests/test_staleness.py``
follow, with the degenerate-buffered pin bit for bit against the port's own
synchronous engine.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from scipy import stats  # noqa: E402

from _torch_parity import (  # noqa: E402
    FAMILY,
    GAMMA,
    LR,
    PERIOD,
    SMALL,
    fed_configs,
    np_tree,
    tasks,
)
from repro.core import algorithms as jalg  # noqa: E402
from repro.core import connectivity as jconn  # noqa: E402
from repro.core import federated as jfed  # noqa: E402
from repro.experiments import ResultsStore as JStore  # noqa: E402
from repro.experiments import grid as jgrid  # noqa: E402
from repro.experiments import results as jres  # noqa: E402
from repro.experiments import sweep as jsweep  # noqa: E402
from repro.optim import paper_decay as jdecay, sgd as jsgd  # noqa: E402
from repro.scale import buffer as jbuf  # noqa: E402
from repro.scale import participation as jpart  # noqa: E402
from repro.scale import sparse_state as jsparse  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import FederationConfig  # noqa: E402
from repro_torch.core import algorithms as talg  # noqa: E402
from repro_torch.core import connectivity as tconn  # noqa: E402
from repro_torch.core import federated as tfed  # noqa: E402
from repro_torch.data import (  # noqa: E402
    classification_source,
    fixed_source,
    traced_classification_source,
)
from repro_torch.experiments import ResultsStore  # noqa: E402
from repro_torch.experiments import grid as tgrid  # noqa: E402
from repro_torch.experiments import results as tres  # noqa: E402
from repro_torch.experiments import sweep as tsweep  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.ref import OP_ALL, OP_KNOWN_P, OP_MEAN  # noqa: E402
from repro_torch.optim import paper_decay as tdecay, sgd as tsgd  # noqa: E402
from repro_torch.scale import (  # noqa: E402
    BUFFER_METRIC_KEYS,
    SYNC,
    BufferState,
    Strategy,
    buffered_aggregate,
    cohort_arrivals,
    cohort_branch,
    init_buffer_state,
    knobs_of,
    sample_cohort,
    scatter_mask,
    strategy_knob_columns,
)

BUFFERED = Strategy("buffered", buffer_size=4, deadline_rounds=3)
METRIC_KEYS = ("loss", "num_active") + BUFFER_METRIC_KEYS
# one strategy per trajectory of the engine parity tests: the sync knobs, a
# deadline, wait-for-full, and a discounted buffer
STRATS = (SYNC, Strategy("b", buffer_size=3, deadline_rounds=2),
          Strategy("w", wait_for_full=True, buffer_size=4),
          Strategy("d", buffer_size=5, deadline_rounds=3,
                   staleness_discount=0.25))
BASE = tgrid.SweepSpec(
    algorithms=("fedpbc",), seeds=(0, 1), num_clients=8, dim=16, hidden=16,
    classes=10, n_per_class=60, n_train=480, per_client=24, batch_size=4,
    local_steps=2, rounds=4, eval_every=2, lrs=(0.1,))


def _j(spec_t):
    """The reference's ``SweepSpec`` with the port spec's fields."""
    kw = {f.name: getattr(spec_t, f.name)
          for f in dataclasses.fields(spec_t)}
    kw["strategies"] = tuple(jbuf.Strategy(**dataclasses.asdict(s))
                             for s in spec_t.strategies)
    return jgrid.SweepSpec(**kw)


# ---------------------------------------------------------------------------
# the buffer fold against the reference
# ---------------------------------------------------------------------------

KNOB_SETS = {
    "sync": (SYNC,) * 4,
    "wait_for_full": (Strategy("w", wait_for_full=True, buffer_size=4),) * 4,
    "deadline": (Strategy("d", buffer_size=10, deadline_rounds=2),) * 4,
    "discount": (Strategy("s", buffer_size=5, deadline_rounds=3,
                          staleness_discount=0.3),) * 4,
    "per_trajectory": STRATS,
}


def _buffer_inputs(seed, B=4, M=6, m=9, n=5):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    buf = dict(acc=rng.normal(size=(B, n)).astype(f32),
               weight=rng.uniform(0.5, 3.0, size=B).astype(f32),
               count=np.asarray([0, 2, 3, 5], np.int32)[:B],
               since=np.asarray([0, 1, 2, 1], np.int32)[:B],
               age_sum=rng.uniform(0, 4, size=B).astype(f32),
               in_buffer=rng.random((B, m)) < 0.3,
               commits=rng.integers(0, 4, size=B).astype(np.int32))
    # trajectory 0 starts from an empty buffer (init or just committed)
    for k in ("acc", "weight", "count", "since", "age_sum", "in_buffer"):
        buf[k][0] = 0
    return dict(buf=buf, server=rng.normal(size=(B, n)).astype(f32),
                x=rng.normal(size=(B, M, n)).astype(f32),
                active=rng.random((B, M)) < 0.5,
                p=rng.uniform(0.05, 1.0, size=(B, M)).astype(f32),
                new_mask=rng.random((B, m)) < 0.4)


@pytest.mark.parametrize("knob_set", list(KNOB_SETS))
@pytest.mark.parametrize("op", [OP_MEAN, OP_ALL, OP_KNOWN_P, "per_trajectory"])
def test_buffered_aggregate_matches_reference(op, knob_set):
    d = _buffer_inputs(7)
    B, M = d["active"].shape
    strats = KNOB_SETS[knob_set]
    ops = [OP_MEAN, OP_ALL, OP_KNOWN_P, OP_MEAN] if op == "per_trajectory" \
        else [op] * B
    per_traj = op == "per_trajectory" or knob_set == "per_trajectory"
    t = {k: torch.as_tensor(v) for k, v in d["buf"].items()}
    buf = BufferState(**t)
    in_new = torch.as_tensor(d["new_mask"]) | t["in_buffer"]
    if per_traj:
        cols = strategy_knob_columns(strats, 1)
        knobs, t_op = cols, torch.as_tensor(ops, dtype=torch.int32)
    else:
        knobs, t_op = knobs_of(strats[0]), ops[0]
    nb, srv, commit, mets = buffered_aggregate(
        buf, torch.as_tensor(d["server"]), torch.as_tensor(d["x"]),
        torch.as_tensor(d["active"]), torch.as_tensor(d["p"]), knobs,
        op=t_op, m_total=M, in_buffer_new=in_new)
    for b in range(B):
        jb = jbuf.BufferState(
            acc={"w": jnp.asarray(d["buf"]["acc"][b])},
            **{k: jnp.asarray(d["buf"][k][b]) for k in
               ("weight", "count", "since", "age_sum", "in_buffer",
                "commits")})
        if per_traj:
            jknobs = {k: jnp.asarray(np.asarray(v)[b]) for k, v in
                      jbuf.strategy_knob_columns(
                          [jbuf.Strategy(**dataclasses.asdict(s))
                           for s in strats], 1).items()}
            j_op = jnp.int32(ops[b])
        else:
            jknobs = jbuf.knobs_of(jbuf.Strategy(
                **dataclasses.asdict(strats[b])))
            j_op = ops[b]
        jnb, jsrv, jcommit, jmets = jbuf.buffered_aggregate(
            jb, {"w": jnp.asarray(d["server"][b])},
            {"w": jnp.asarray(d["x"][b])}, jnp.asarray(d["active"][b]),
            jnp.asarray(d["p"][b]), jknobs, op=j_op, m_total=M,
            in_buffer_new=jnp.asarray(in_new[b].numpy()))
        assert bool(commit[b]) == bool(jcommit)
        close = dict(rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(srv[b].numpy(), np.asarray(jsrv["w"]),
                                   **close)
        np.testing.assert_allclose(nb.acc[b].numpy(), np.asarray(jnb.acc["w"]),
                                   **close)
        for k in ("weight", "age_sum"):
            np.testing.assert_allclose(getattr(nb, k)[b].item(),
                                       float(getattr(jnb, k)), **close)
        for k in ("count", "since", "commits"):
            assert getattr(nb, k)[b].item() == int(getattr(jnb, k)), k
        np.testing.assert_array_equal(nb.in_buffer[b].numpy(),
                                      np.asarray(jnb.in_buffer))
        for k in BUFFER_METRIC_KEYS:
            np.testing.assert_allclose(mets[k][b].item(), float(jmets[k]),
                                       **close)
    assert nb.count.dtype == torch.int32 and nb.in_buffer.dtype == torch.bool


# ---------------------------------------------------------------------------
# the sparse cohort branches against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algo", ["fedau", "mifa", "f3ast", "fedpbc_m"])
def test_cohort_branch_matches_reference_and_touches_cohort_rows_only(algo):
    B, m, C, n = 2, 20, 6, 7
    rng = np.random.default_rng(3)
    f32 = np.float32
    state = dict(gap=rng.integers(0, 6, (B, m)).astype(f32),
                 sum_gaps=rng.uniform(0, 9, (B, m)).astype(f32),
                 n_gaps=rng.integers(0, 4, (B, m)).astype(f32),
                 # distinct availability scores, so both argsorts agree
                 lam=rng.permutation(B * m).reshape(B, m).astype(f32)
                 / (B * m),
                 mem=rng.normal(size=(B, m, n)).astype(f32),
                 mom=rng.normal(size=(B, 1, n)).astype(f32))
    server = rng.normal(size=(B, n)).astype(f32)
    x = rng.normal(size=(B, C, n)).astype(f32)
    cohort = np.stack([rng.permutation(m)[:C] for _ in range(B)])
    c_active = rng.random((B, C)) < 0.6
    c_active[:, 0] = True
    c_p = rng.uniform(0.05, 1.0, (B, C)).astype(f32)
    tspec = talg.AlgorithmSpec((algo,), f3ast_cap=3)
    jspec = jalg.AlgorithmSpec((algo,), f3ast_cap=3)
    ts = talg.AlgoState(**{k: torch.as_tensor(v.copy())
                           for k, v in state.items()})
    ts_out, tsrv = tspec.aggregate_cohort(
        0, ts, torch.as_tensor(server), torch.as_tensor(x),
        torch.as_tensor(cohort), torch.as_tensor(c_active),
        torch.as_tensor(c_p), 3)
    branch = jsparse.cohort_branch(algo, jspec)
    close = dict(rtol=1e-6, atol=1e-6)
    for b in range(B):
        js = jalg.AlgoState(
            **{k: jnp.asarray(state[k][b]) for k in
               ("gap", "sum_gaps", "n_gaps", "lam")},
            mem={"w": jnp.asarray(state["mem"][b])},
            mom={"w": jnp.asarray(state["mom"][b])})
        js_out, jsrv = branch(js, {"w": jnp.asarray(server[b])},
                              {"w": jnp.asarray(x[b])},
                              jnp.asarray(cohort[b], jnp.int32),
                              jnp.asarray(c_active[b]), jnp.asarray(c_p[b]),
                              jnp.int32(3))
        np.testing.assert_allclose(tsrv[b].numpy(), np.asarray(jsrv["w"]),
                                   **close)
        for k in ("gap", "sum_gaps", "n_gaps", "lam"):
            np.testing.assert_allclose(getattr(ts_out, k)[b].numpy(),
                                       np.asarray(getattr(js_out, k)), **close)
        np.testing.assert_allclose(ts_out.mem[b].numpy(),
                                   np.asarray(js_out.mem["w"]), **close)
        np.testing.assert_allclose(ts_out.mom[b].numpy(),
                                   np.asarray(js_out.mom["w"]), **close)
        outside = np.setdiff1d(np.arange(m), cohort[b])
        for k in ("gap", "sum_gaps", "n_gaps", "lam", "mem"):
            np.testing.assert_array_equal(
                getattr(ts_out, k)[b].numpy()[outside], state[k][b][outside])


def test_cohort_aggregation_refuses_a_per_trajectory_family_id():
    spec = talg.AlgorithmSpec(FAMILY)
    with pytest.raises(ValueError, match="static algo_id"):
        spec.aggregate_cohort(torch.zeros(2, dtype=torch.long), None, None,
                              None, None, None, None, 0)
    with pytest.raises(ValueError, match="no sparse cohort branch"):
        cohort_branch("fedpbc", spec)


def test_participation_gathers_and_scatters_per_trajectory():
    cohort = torch.tensor([[3, 0, 5], [1, 4, 2]])
    active_m = torch.arange(12).reshape(2, 6) % 3 == 0
    p = torch.arange(12, dtype=torch.float32).reshape(2, 6)
    a, pc = cohort_arrivals(cohort, active_m, p)
    assert a.tolist() == [[True, True, False], [False, False, False]]
    assert pc.tolist() == [[3.0, 0.0, 5.0], [7.0, 10.0, 8.0]]
    mask = scatter_mask(cohort, torch.tensor([[True, False, True],
                                              [False, True, True]]), 6)
    assert mask.int().tolist() == [[0, 0, 0, 1, 0, 1], [0, 0, 1, 0, 1, 0]]
    for b in range(2):
        ref = jpart.scatter_mask(jnp.asarray(cohort[b].numpy()),
                                 jnp.asarray(mask[b][cohort[b]].numpy()), 6)
        np.testing.assert_array_equal(mask[b].numpy(), np.asarray(ref))


# ---------------------------------------------------------------------------
# the round engines against the reference
# ---------------------------------------------------------------------------

class JaxScale:
    """4 trajectories of the reference family (member b, seed b, strategy
    ``STRATS[b]`` as knob columns) through the reference's buffered dense
    round or its cohort round (``cohort_size``), jitted and vmapped, with
    each round's draws computed from the reference's own keys."""

    def __init__(self, cohort_size=None):
        self.C = cohort_size
        self.jfed_cfg, self.tfed_cfg = fed_configs("bernoulli_tv")
        self.jtask, self.ttask = tasks()
        self.layout = self.ttask.layout
        fed, task, C = self.jfed_cfg, self.jtask, cohort_size
        spec = jalg.make_algorithm_spec(FAMILY, fed)
        self.idx = self.jtask.partition(0.1)
        seeds = (0, 1, 2, 3)
        self.B = len(seeds)
        self.keys = jsweep.stack_seed_keys(seeds)
        self.p_base = jnp.stack([jconn.build_base_probs(
            jax.random.PRNGKey(s), SMALL["num_clients"], 10)[0]
            for s in seeds])
        self.algo_id = jnp.arange(4, dtype=jnp.int32)
        self.knobs = jbuf.strategy_knob_columns(
            [jbuf.Strategy(**dataclasses.asdict(s)) for s in STRATS], 1)
        self.hp = {k: jnp.full((self.B,), v, jnp.float32)
                   for k, v in (("lr", LR), ("gamma", GAMMA),
                                ("period", PERIOD))}

        def link(p, hp):
            return jconn.make_link_process(p, fed, gamma=hp["gamma"],
                                           period=hp["period"])

        def init_one(k, p, hp):
            opt = jsgd(jdecay(hp["lr"]))
            return jfed.init_fed_state(
                k["state"], task.init_params(k["params"]), fed, spec,
                link(p, hp), opt, stateless_clients=C is not None,
                buffered=True)

        source = task.source_factory(task.shared)
        ds = {"idx": jnp.asarray(self.idx)}

        def round_one(st, data_key, batches, p, hp, aid, kn):
            rf = jfed.make_round_fn(task.loss_fn, jsgd(jdecay(hp["lr"])),
                                    spec, link(p, hp), fed, algo_id=aid,
                                    strategy=kn, cohort_size=C)
            if C is None:
                return rf(st, batches)
            st, _, mets = rf(st, ds, jax.random.fold_in(data_key, st.round),
                             source)
            return st, mets

        m, s, b = (SMALL["num_clients"], SMALL["local_steps"],
                   SMALL["batch_size"])
        pc = SMALL["per_client"]

        def draws_one(st, data_key):
            if C is None:
                _, k_link = jax.random.split(st.key)
                cohort = jnp.arange(m)
            else:
                _, k_link, k_cohort = jax.random.split(st.key, 3)
                cohort = jpart.sample_cohort(k_cohort, m, C)
            u = jax.random.uniform(k_link, (m,))
            pick = jax.random.randint(jax.random.fold_in(data_key, st.round),
                                      (cohort.shape[0], s, b), 0, pc)
            return u, cohort, pick

        self._init = jax.jit(jax.vmap(init_one))
        self._round = jax.jit(jax.vmap(round_one))
        self._draws = jax.jit(jax.vmap(draws_one))

    def init(self):
        return self._init(self.keys, self.p_base, self.hp)

    def draws(self, st):
        u, cohort, pick = self._draws(st, self.keys["data"])
        return np.asarray(u), np.asarray(cohort), np.asarray(pick)

    def batches(self, pick):
        sel = self.idx[np.arange(self.idx.shape[0])[None, :, None, None],
                       pick]
        sh = self.jtask.shared
        return {"x": jnp.asarray(np.asarray(sh["x"])[sel]),
                "y": jnp.asarray(np.asarray(sh["y"])[sel])}

    def round(self, st, pick):
        batches = self.batches(pick) if self.C is None else {}
        return self._round(st, self.keys["data"], batches, self.p_base,
                           self.hp, self.algo_id, self.knobs)

    def port_step(self):
        p = torch.tensor(np.asarray(self.p_base))
        hp = {k: torch.tensor(np.asarray(v)) for k, v in self.hp.items()}
        link = tconn.make_link_process(p, self.tfed_cfg, gamma=hp["gamma"],
                                       period=hp["period"])
        spec = talg.make_algorithm_spec(FAMILY, self.tfed_cfg)
        knobs = {k: torch.tensor(np.asarray(v))
                 for k, v in self.knobs.items()}
        rf = tfed.make_round_fn(
            self.ttask.loss_fn, tsgd(tdecay(hp["lr"])), spec, link,
            self.tfed_cfg, algo_id=torch.arange(4), use_kernel=True,
            strategy=knobs, cohort_size=self.C)
        source = self.ttask.source_factory(self.ttask.shared)
        idx = torch.as_tensor(np.broadcast_to(
            self.idx, (self.B,) + self.idx.shape).copy())
        return tfed.make_round_step(rf, source), source.init({"idx": idx})

    def port_draws(self, u, cohort, pick):
        return tfed.RoundDraws(torch.tensor(u), torch.tensor(pick),
                               None if self.C is None
                               else torch.tensor(cohort).long())

    def port_state(self, st):
        st = np_tree(st)
        server = convert.params_from_jax(st.server, self.layout)
        B, n = server.shape
        if self.C is None:
            clients = convert.params_from_jax(st.clients, self.layout)
            opt = {"step": torch.tensor(st.opt_state["step"])}
        else:
            clients, opt = server.new_empty((B, 0, n)), {}
        b = st.buffer
        buf = BufferState(
            acc=convert.params_from_jax(b.acc, self.layout),
            **{k: torch.tensor(np.asarray(getattr(b, k))) for k in
               ("weight", "count", "since", "age_sum", "in_buffer",
                "commits")})
        spec = talg.make_algorithm_spec(FAMILY, self.tfed_cfg)
        return tfed.FedState(
            server=server, clients=clients, opt_state=opt,
            algo_state=spec.init(server, SMALL["num_clients"]),
            link_state=(), round=int(np.unique(st.round)[0]),
            last_active=torch.tensor(st.last_active), buffer=buf)

    def assert_close(self, ps, st, tol):
        st = np_tree(st)
        close = dict(rtol=tol, atol=tol)
        np.testing.assert_allclose(
            ps.server.numpy(),
            convert.params_from_jax(st.server, self.layout).numpy(), **close)
        if self.C is None:
            np.testing.assert_allclose(
                ps.clients.numpy(),
                convert.params_from_jax(st.clients, self.layout).numpy(),
                **close)
        else:
            assert ps.clients.numel() == 0 and ps.opt_state == {}
        np.testing.assert_allclose(
            ps.buffer.acc.numpy(),
            convert.params_from_jax(st.buffer.acc, self.layout).numpy(),
            **close)
        for k in ("weight", "age_sum"):
            np.testing.assert_allclose(getattr(ps.buffer, k).numpy(),
                                       getattr(st.buffer, k), **close)
        for k in ("count", "since", "commits", "in_buffer"):
            np.testing.assert_array_equal(getattr(ps.buffer, k).numpy(),
                                          getattr(st.buffer, k))
        np.testing.assert_array_equal(ps.last_active.numpy(), st.last_active)
        assert ps.round == int(np.unique(st.round)[0])


@pytest.fixture(scope="module", params=[None, 5], ids=["dense", "cohort"])
def scale_engine(request):
    return JaxScale(request.param)


def test_scale_round_resynced_every_round_matches_reference(scale_engine):
    eng = scale_engine
    step, ds = eng.port_step()
    st = eng.init()
    commits = 0
    for _ in range(6):
        u, cohort, pick = eng.draws(st)
        ps, _, mets = step(eng.port_state(st), ds,
                           eng.port_draws(u, cohort, pick))
        st, jm = eng.round(st, pick)
        for k in ("active", "commit", "num_active"):
            np.testing.assert_array_equal(mets[k].numpy(), np.asarray(jm[k]))
        for k in ("loss", "buffer_fill", "commit_staleness"):
            np.testing.assert_allclose(mets[k].numpy(), np.asarray(jm[k]),
                                       rtol=1e-5, atol=1e-5)
        eng.assert_close(ps, st, 1e-5)
        commits += int(mets["commit"][1:].sum())
    assert commits > 0      # the buffered trajectories committed


def test_scale_round_drift_over_ten_rounds_without_resync(scale_engine):
    eng = scale_engine
    step, ds = eng.port_step()
    st = eng.init()
    ps = eng.port_state(st)
    for _ in range(10):
        u, cohort, pick = eng.draws(st)
        ps, ds, _ = step(ps, ds, eng.port_draws(u, cohort, pick))
        st, _ = eng.round(st, pick)
    eng.assert_close(ps, st, 1e-4)


# ---------------------------------------------------------------------------
# the reference's contracts (tests/test_scale.py, tests/test_staleness.py)
# ---------------------------------------------------------------------------

def _quadratic(m, C=None, *, algo="fedpbc", p=0.5, strategy=None, seed=0,
               metric_keys=("loss", "num_active", "staleness")):
    """A tiny quadratic federated problem on the port's engine: one
    trajectory, ``n = 3``; returns ``(run, state, ds_state, draws)``."""
    fed = FederationConfig(algorithm=algo, num_clients=m, local_steps=2)
    spec = talg.make_algorithm_spec((algo,), fed)
    link = tconn.make_link_process(torch.full((1, m), p), fed)

    def loss(params, batch):
        return ((params - batch["u"].sum(-1, keepdim=True)) ** 2).sum(-1)

    opt = tsgd(0.05)
    source = fixed_source({"u": torch.zeros(m, fed.local_steps, 1)})
    scale = strategy is not None or C is not None
    run = tfed.make_run_rounds(
        loss, opt, spec, link, fed, source,
        metric_keys=metric_keys + (BUFFER_METRIC_KEYS if scale else ()),
        strategy=strategy, cohort_size=C, device="cpu")
    draws = tfed.GeneratorDraws([tsweep.seed_generators(seed)],
                                num_clients=m, cohort_size=C)
    st = tfed.init_fed_state(draws.link_init(), torch.ones(1, 3), fed, spec,
                             link, opt, stateless_clients=C is not None,
                             buffered=strategy is not None
                             or (C is not None and spec.fusable))
    return run, st, source.init(), draws


def test_cohort_round_memory_is_o_of_c():
    """At m = 50,000 the cohort engine holds NO [B, m, n] tensor: the client
    params are [B, 0, n], the optimizer state {}, and every FedState tensor
    is O(m) per-client bookkeeping or O(n) server/buffer state."""
    m, C, n = 50_000, 256, 3
    run, st, ds, draws = _quadratic(m, C)

    def leaves(s):
        out = [s.server, s.clients, s.last_active]
        out += list(dataclasses.asdict(s.algo_state).values())
        out += list(dataclasses.asdict(s.buffer).values())
        return out + list(s.opt_state.values())

    for s in (st,):
        assert s.clients.shape == (1, 0, n) and s.opt_state == {}
        assert all(t.numel() <= max(m, 64 * n) for t in leaves(s))
    st, ds, mets = run(st, ds, draws, 2)
    assert st.clients.shape == (1, 0, n) and st.opt_state == {}
    assert all(t.numel() <= max(m, 64 * n) for t in leaves(st))
    assert torch.isfinite(mets["loss"]).all()
    assert int(mets["num_active"].max()) <= C   # C-sized cohorts


def test_cohort_sampler_validates_and_is_unique():
    g = tsweep.seed_generators(0)["cohort"]
    cohort = sample_cohort(g, 100, 32)
    assert cohort.shape == (32,) and cohort.dtype == torch.int64
    assert len(set(cohort.tolist())) == 32
    assert cohort.min() >= 0 and cohort.max() < 100
    for size in (0, 101):
        with pytest.raises(ValueError, match="cohort"):
            sample_cohort(g, 100, size)


def test_cohort_inclusion_is_uniform():
    """Each client's inclusion count over 3,000 draws of C = 10 from m = 40
    against its expectation 750 (chi-square), and the first member's index
    against the uniform on [0, m) (KS)."""
    g = torch.Generator().manual_seed(11)
    m, C, N = 40, 10, 3000
    draws = torch.stack([sample_cohort(g, m, C) for _ in range(N)])
    counts = np.bincount(draws.flatten().numpy(), minlength=m)
    assert counts.sum() == N * C
    assert stats.chisquare(counts).pvalue > 1e-3
    first = draws[:, 0].numpy() + np.random.default_rng(0).random(N)
    assert stats.kstest(first / m, "uniform").pvalue > 1e-3


def test_sample_cohort_full_population_is_dense_sample():
    m, s, b, d, B = 6, 2, 3, 4, 2
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(40, d)), dtype=torch.float32)
    y = torch.as_tensor(rng.integers(0, 3, size=(40,)))
    idx = torch.as_tensor(rng.integers(0, 40, size=(m, 8)))
    pick = torch.as_tensor(rng.integers(0, 8, size=(B, m, s, b)))
    full = torch.arange(m).expand(B, m)
    srcs = [(classification_source(x, y, idx, local_steps=s, batch_size=b),
             ()),
            (traced_classification_source({"x": x, "y": y}, local_steps=s,
                                          batch_size=b, per_client=8),
             {"idx": idx.expand(B, m, 8)}),
            (fixed_source({"x": x[:m * s].reshape(m, s, d)}), ())]
    for src, ds in srcs:
        dense, _ = src.sample(ds, 3, pick)
        cohort, _ = src.sample_cohort(ds, 3, full, pick)
        for k in dense:
            assert torch.equal(dense[k].expand(cohort[k].shape), cohort[k])


@pytest.mark.parametrize("algo", ["fedau", "mifa", "f3ast", "fedpbc_m"])
def test_stateful_cohort_engine_runs_and_touches_cohort_rows_only(algo):
    m, C = 64, 8
    run, st, ds, draws = _quadratic(m, C, algo=algo)
    mem0 = st.algo_state.mem.clone()
    st1, ds, mets = run(st, ds, draws, 5)
    assert torch.isfinite(mets["loss"]).all()
    assert torch.isfinite(st1.server).all()
    # rows never sampled keep their initial state: 5 rounds x C = 8 touch
    # at most 40 of 64 rows
    assert int((st1.last_active >= 0).sum()) <= 5 * C
    if algo == "mifa":
        unchanged = (mem0 == st1.algo_state.mem).reshape(m, -1).all(-1)
        assert int(unchanged.sum()) >= m - 5 * C


def test_buffered_strategy_refused_for_stateful_rules():
    m = 8
    fed = FederationConfig(algorithm="fedau", num_clients=m, local_steps=2)
    spec = talg.make_algorithm_spec(("fedau",), fed)
    link = tconn.make_link_process(torch.full((1, m), 0.5), fed)
    with pytest.raises(ValueError, match="empty-state family"):
        tfed.make_run_rounds(lambda p, b: (p ** 2).sum(-1), tsgd(0.1), spec,
                             link, fed,
                             fixed_source({"u": torch.zeros(m, 2, 1)}),
                             strategy=BUFFERED, device="cpu")


def test_buffered_sweep_is_one_batch_and_records_strategy(tmp_path,
                                                          monkeypatch):
    spec = dataclasses.replace(BASE, strategies=(SYNC, BUFFERED),
                               schemes=("bernoulli_ti",))
    calls = []
    real = tgrid.make_batched_run_rounds

    def counting(*a, **kw):
        run = real(*a, **kw)

        def wrapped(batch, draws=None):
            calls.append(batch.batch_size)
            return run(batch, draws)

        return wrapped

    monkeypatch.setattr(tgrid, "make_batched_run_rounds", counting)
    store = ResultsStore(str(tmp_path / "port"))
    cells = tgrid.run_sweep(spec, store=store, suite="scale",
                            metric_keys=METRIC_KEYS, device="cpu")
    # both strategies ran as ONE batch of 2 x seeds trajectories
    assert calls == [2 * len(spec.seeds)]
    assert [c.strategy for c in cells] == ["sync", "buffered"]
    rows = store.records(suite="scale")
    assert [r["strategy"] for r in rows] == ["sync", "buffered"]
    # the strategy axis serializes as the reference's dataclasses.asdict
    sync_record = {"name": "sync", "wait_for_full": False, "buffer_size": 1,
                   "deadline_rounds": 1, "staleness_discount": 0.0}
    assert dataclasses.asdict(jbuf.SYNC) == sync_record
    assert rows[0]["spec"]["strategies"] == [
        sync_record, dataclasses.asdict(jbuf.Strategy(
            **dataclasses.asdict(BUFFERED)))]
    # buffered rows carry the commit trace: a real policy, neither no
    # commit nor the sync every-round commit
    sync_c, buf_c = cells
    commits = buf_c.commit.sum(axis=1)
    assert (commits >= 1).all() and (commits < spec.rounds).all()
    assert (sync_c.commit.sum(axis=1) == spec.rounds).all()
    summ = buf_c.summary()
    assert {"commits", "commit_staleness", "participation"} <= set(summ)
    # the same grid through the reference: the same cell keys, read back by
    # either package
    jstore = JStore(str(tmp_path / "ref"))
    jgrid.run_sweep(_j(spec), store=jstore, suite="scale",
                    metric_keys=METRIC_KEYS, mesh=None)
    jrows = jstore.records(suite="scale")
    assert [tres.cell_key(r) for r in rows] == \
        [jres.cell_key(r) for r in jrows]
    assert [set(r["summary"]) for r in rows] == \
        [set(r["summary"]) for r in jrows]
    port_read_by_ref = JStore(str(tmp_path / "port")).records()
    assert [r["strategy"] for r in port_read_by_ref] == ["sync", "buffered"]


def test_cohort_sweep_runs_at_scale_smoke():
    spec = dataclasses.replace(
        BASE, num_clients=10_000, cohort_size=64,
        strategies=(Strategy("buf", buffer_size=48, deadline_rounds=2),),
        schemes=("bernoulli_ti",), seeds=(0,), rounds=3, eval_every=3)
    (cell,) = tgrid.run_sweep(spec, metric_keys=METRIC_KEYS, device="cpu")
    assert cell.strategy == "buf"
    assert np.isfinite(cell.test_acc).all()
    assert int(cell.num_active.max()) <= 64
    assert 0.0 <= cell.summary()["participation"]["mean"] <= 1.0


def test_scale_rounds_launch_no_aggregation_kernel(monkeypatch):
    """use_kernel=True routes nothing of a scale round to the fused
    aggregation, as in the reference; the dense sync round does."""
    calls = []
    real = dispatch.fused_agg
    monkeypatch.setattr(dispatch, "fused_agg",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    spec = dataclasses.replace(BASE, use_kernel=True, rounds=2, seeds=(0,))
    for kw in (dict(cohort_size=4), dict(strategies=(SYNC, BUFFERED)),
               dict(cohort_size=4, strategies=(BUFFERED,))):
        tgrid.run_sweep(dataclasses.replace(spec, **kw), device="cpu")
    assert calls == []
    tgrid.run_sweep(spec, device="cpu")
    assert len(calls) == spec.rounds


@pytest.mark.parametrize("kw,match", [
    (dict(strategies=()), "SweepSpec.strategies is empty"),
    (dict(strategies=(SYNC, "buffered")), "SweepSpec.strategies entries"),
    (dict(strategies=(SYNC, Strategy("sync"))),
     "SweepSpec.strategies.*duplicate.*sync"),
    (dict(strategies=(Strategy("big", buffer_size=BASE.num_clients + 1),)),
     r"SweepSpec.strategies\['big'\].buffer_size"),
    (dict(cohort_size=4, strategies=(Strategy("big", buffer_size=6),)),
     r"SweepSpec.strategies\['big'\].buffer_size"),
    (dict(strategies=(Strategy("rush", deadline_rounds=0),)),
     r"SweepSpec.strategies\['rush'\].deadline"),
    (dict(strategies=(Strategy("hot", staleness_discount=1.5),)),
     r"SweepSpec.strategies\['hot'\].staleness"),
    (dict(cohort_size=0), "SweepSpec.cohort_size"),
    (dict(cohort_size=BASE.num_clients + 1), "SweepSpec.cohort_size"),
    (dict(algorithms=("fedau",), strategies=(SYNC, BUFFERED)),
     "buffered entries"),
])
def test_sweep_spec_strategy_axis_validation_names_offending_field(kw, match):
    with pytest.raises(ValueError, match=match):
        dataclasses.replace(BASE, **kw)
    jkw = dict(kw)
    if "strategies" in kw:
        jkw["strategies"] = tuple(
            jbuf.Strategy(**dataclasses.asdict(s))
            if isinstance(s, Strategy) else s for s in kw["strategies"])
    with pytest.raises(ValueError, match=match):
        dataclasses.replace(_j(BASE), **jkw)
    # valid axes still construct
    dataclasses.replace(BASE, strategies=(SYNC, BUFFERED), cohort_size=4)


def test_knob_normalization_and_columns():
    assert knobs_of(None) == knobs_of(SYNC)
    assert SYNC.is_sync and not BUFFERED.is_sync
    assert Strategy("w", wait_for_full=True, buffer_size=1).is_sync is False
    with pytest.raises(ValueError, match="missing"):
        knobs_of({"buffer_size": 4})
    cols = strategy_knob_columns((SYNC, BUFFERED), block=3)
    ref = jbuf.strategy_knob_columns(
        (jbuf.SYNC, jbuf.Strategy(**dataclasses.asdict(BUFFERED))), block=3)
    assert set(cols) == set(ref) == {"wait_for_full", "buffer_size",
                                     "deadline_rounds", "staleness_discount"}
    assert cols["buffer_size"].tolist() == [1, 1, 1, 4, 4, 4]
    for k in cols:
        np.testing.assert_array_equal(cols[k].numpy(), np.asarray(ref[k]))
        assert cols[k].numpy().dtype == np.asarray(ref[k]).dtype


def _fold(buf, server, active, knobs):
    m = active.shape[-1]
    x_star = torch.ones(1, m, 2)
    return buffered_aggregate(buf, server, x_star, active,
                              torch.full((1, m), 0.5), knobs, op=OP_MEAN,
                              m_total=m, in_buffer_new=buf.in_buffer | active)


def test_wait_for_full_commits_only_when_full():
    m = 4
    server = torch.zeros(1, 2)
    knobs = knobs_of(Strategy("w", wait_for_full=True, buffer_size=3,
                              deadline_rounds=1))
    buf = init_buffer_state(server, m)
    two = torch.tensor([[True, True, False, False]])
    buf, srv, commit, mets = _fold(buf, server, two, knobs)
    assert not bool(commit)                      # 2 < 3: deadline ignored
    assert float(mets["buffer_fill"]) == 2.0
    assert torch.equal(srv, server)
    buf, srv, commit, mets = _fold(buf, server, two, knobs)
    assert bool(commit)                          # 4 >= 3: fills, commits
    assert int(buf.count) == 0 and not bool(buf.in_buffer.any())
    # the committed mean of four all-ones contributions is exactly ones
    assert torch.equal(srv, torch.ones(1, 2))
    # the first two contributions waited one round, the new two zero
    assert float(mets["commit_staleness"]) == pytest.approx(0.5)


def test_deadline_forces_commit_on_empty_rounds():
    m = 4
    server = torch.zeros(1, 2)
    # buffer_size 4 never fills with one arrival a round; the deadline acts
    knobs = knobs_of(Strategy("d", buffer_size=4, deadline_rounds=2))
    buf = init_buffer_state(server, m)
    one = torch.tensor([[True, False, False, False]])
    buf, _, commit, _ = _fold(buf, server, one, knobs)
    assert not bool(commit)                      # 1 < 4 and 1 < deadline 2
    buf, srv, commit, _ = _fold(buf, server, one, knobs)
    assert bool(commit)                          # deadline reached
    assert torch.equal(srv, torch.ones(1, 2))
    assert int(buf.commits) == 1


def test_staleness_discount_downweights_without_bias():
    m = 2
    server = torch.zeros(1, 1)
    knobs = knobs_of(Strategy("s", buffer_size=2, deadline_rounds=10,
                              staleness_discount=0.5))
    buf = init_buffer_state(server, m)
    first = torch.tensor([[True, False]])
    second = torch.tensor([[False, True]])
    p = torch.full((1, m), 0.5)
    buf, _, commit, _ = buffered_aggregate(
        buf, server, torch.full((1, m, 1), 4.0), first, p, knobs, op=OP_MEAN,
        m_total=m, in_buffer_new=buf.in_buffer | first)
    assert not bool(commit)
    buf, srv, commit, _ = buffered_aggregate(
        buf, server, torch.full((1, m, 1), 1.0), second, p, knobs,
        op=OP_MEAN, m_total=m, in_buffer_new=buf.in_buffer | second)
    assert bool(commit)
    # discounted mean (0.5 * 4 + 1) / (0.5 + 1) = 2: between the stale (4)
    # and fresh (1) values, closer to fresh; down-weighted, not biased
    assert float(srv[0, 0]) == pytest.approx(2.0)


def test_buffered_staleness_bounded_by_deadline():
    """Each buffered contribution waits at most deadline - 1 rounds before
    its commit, so the per-commit mean staleness is bounded by the
    deadline, and commits come at the deadline's cadence (a buffer of 6
    rarely fills from ~2 arrivals a round at p = 0.5)."""
    m, p, rounds, deadline = 16, 0.5, 240, 4
    strat = Strategy("buf", buffer_size=6, deadline_rounds=deadline)
    run, st, ds, draws = _quadratic(m, p=p, strategy=strat,
                                    metric_keys=("staleness",))
    st, _, mets = run(st, ds, draws, rounds)
    commit = mets["commit"].numpy()
    stale = mets["commit_staleness"].numpy()
    n_commits = commit.sum()
    assert n_commits >= rounds / deadline
    mean_stale = (stale * commit).sum() / n_commits
    assert 0.0 < mean_stale <= deadline + 1.0 / p
    assert stale.max() <= deadline
    assert int(st.buffer.commits) == n_commits


@pytest.mark.parametrize("p,strat", [
    (1.0, Strategy("deg_full", wait_for_full=True, buffer_size=8)),
    (0.5, Strategy("deg_deadline", deadline_rounds=1)),
], ids=["wait_for_full", "deadline"])
def test_degenerate_buffered_equals_sync_bit_for_bit(p, strat):
    """The pin: a buffered configuration that commits every round IS the
    port's synchronous engine — same server, clients, staleness and
    metrics, bitwise. Two degenerate routes: wait_for_full with a buffer
    the (all-active) round always fills, and deadline_rounds=1 under
    partial activity."""
    m, rounds = 8, 12
    keys = ("loss", "num_active", "staleness")
    run, st, ds, draws = _quadratic(m, p=p)
    st_ref, _, mets_ref = run(st, ds, draws, rounds)
    run, st, ds, draws = _quadratic(m, p=p, strategy=strat)
    st_buf, _, mets_buf = run(st, ds, draws, rounds)
    for a, b in ((st_ref.server, st_buf.server),
                 (st_ref.clients, st_buf.clients),
                 (st_ref.last_active, st_buf.last_active),
                 (st_ref.opt_state["step"], st_buf.opt_state["step"])):
        assert torch.equal(a, b)
    for k in keys:
        assert torch.equal(mets_ref[k], mets_buf[k]), k
    # the degenerate policy committed every round with an empty buffer
    assert int(st_buf.buffer.commits) == rounds
    assert float(st_buf.buffer.weight) == 0.0


def test_degenerate_buffered_family_equals_sync_bit_for_bit():
    """The pin over the whole fusable family at once: per-trajectory
    members and SYNC knob columns through the dense buffered round equal
    the synchronous family round bitwise, on the MLP task."""
    eng = JaxScale()
    p = torch.tensor(np.asarray(eng.p_base))
    hp = {k: torch.tensor(np.asarray(v)) for k, v in eng.hp.items()}
    link = tconn.make_link_process(p, eng.tfed_cfg, gamma=hp["gamma"],
                                   period=hp["period"])
    spec = talg.make_algorithm_spec(FAMILY, eng.tfed_cfg)
    opt = tsgd(tdecay(hp["lr"]))
    source = eng.ttask.source_factory(eng.ttask.shared)
    idx = torch.as_tensor(np.broadcast_to(
        eng.idx, (eng.B,) + eng.idx.shape).copy())
    knobs = strategy_knob_columns((SYNC,) * eng.B, 1)
    out = []
    for strategy in (None, knobs):
        gens = [tsweep.seed_generators(s) for s in range(eng.B)]
        draws = tfed.GeneratorDraws(gens, num_clients=SMALL["num_clients"],
                                    pick_spec=source.pick_spec)
        server = draws.params(eng.ttask.init_params)
        st = tfed.init_fed_state(draws.link_init(), server, eng.tfed_cfg,
                                 spec, link, opt,
                                 buffered=strategy is not None)
        rf = tfed.make_round_fn(eng.ttask.loss_fn, opt, spec, link,
                                eng.tfed_cfg, algo_id=torch.arange(4),
                                strategy=strategy)
        out.append(tfed.run_rounds_loop(st, source.init({"idx": idx}), draws,
                                        5, round_fn=rf, source=source))
    (ref, _, mref), (buf, _, mbuf) = out
    assert torch.equal(ref.server, buf.server)
    assert torch.equal(ref.clients, buf.clients)
    for k in mref:
        assert torch.equal(mref[k], mbuf[k]), k


def test_generator_draws_add_the_cohort_stream_only():
    """The cohort stream is a fifth generator: the link uniforms of a
    cohort-mode drawer are the dense drawer's, and ``pick`` has C rows."""
    m, C, spec = 12, 5, (2, 3, 7)
    dense = tfed.GeneratorDraws([tsweep.seed_generators(s) for s in (0, 1)],
                                num_clients=m, pick_spec=spec)
    coh = tfed.GeneratorDraws([tsweep.seed_generators(s) for s in (0, 1)],
                              num_clients=m, pick_spec=spec, cohort_size=C)
    assert torch.equal(dense.link_init(), coh.link_init())
    for t in range(3):
        a, b = dense(t), coh(t)
        assert torch.equal(a.u, b.u) and a.cohort is None
        assert b.cohort.shape == (2, C) and b.pick.shape == (2, C, 2, 3)
        assert all(len(set(row.tolist())) == C for row in b.cohort)


def test_sweep_cli_runs_a_buffered_cohort_cell_on_cpu(tmp_path, capsys):
    out = tmp_path / "store"
    tsweep.main(["--device", "cpu", "--algos", "fedpbc", "--schemes",
                 "bernoulli_ti", "--seeds", "0", "--rounds", "2",
                 "--eval-every", "2", "--clients", "10000", "--cohort", "256",
                 "--buffer-size", "128", "--deadline-rounds", "3",
                 "--out", str(out), "--suite", "ci-scale-smoke"])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("sweep,bernoulli_ti")]
    assert [ln.split(",")[3] for ln in lines] == ["sync", "buffered"]
    rows = ResultsStore(str(out)).records()
    assert [r["strategy"] for r in rows] == ["sync", "buffered"]
    assert all(r["spec"]["cohort_size"] == 256 for r in rows)
    assert rows[1]["spec"]["strategies"][1]["buffer_size"] == 128

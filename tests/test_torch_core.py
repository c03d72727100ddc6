"""The port's modules (``repro_torch.core``, ``optim``, ``data``) against the
JAX reference, module by module and round by round, at the small protocol
of ``_torch_parity.SMALL``.

Tolerances, each with its reason:
- link masks exactly equal, ``p_t`` within 1 ulp: both sides compute Eq. 9
  in the same float32 order; ``sin`` may differ by 1 ulp between libraries
  (with per-trajectory gamma up to 0.9 the Eq.-9 sum cancels, so there the
  bound is the float32 spacing at 1.0, absolute);
- data bytes, partitions and optimizer steps exactly equal (or 1 ulp for
  the schedule's divide/sqrt): the same numpy / IEEE float32 operations;
- aggregation branches rtol/atol 1e-6: fp32 sums over m = 8 clients in
  another order;
- one engine round re-synced from the reference rtol/atol 1e-5: fp32
  matrix products and reductions of local training in another order;
- 10 rounds without re-syncing rtol/atol 1e-4: the same, compounded.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import (  # noqa: E402
    FAMILY,
    SMALL,
    JaxFamily,
    assert_state_close,
    fed_configs,
    np_tree,
    tasks,
)
from repro.core import algorithms as jalg  # noqa: E402
from repro.core import connectivity as jconn  # noqa: E402
from repro.data import dirichlet_partition as j_partition  # noqa: E402
from repro.data import make_classification_data as j_data  # noqa: E402
from repro.optim import adam as jadam, paper_decay as jdecay, sgd as jsgd  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import algorithms as talg  # noqa: E402
from repro_torch.core import connectivity as tconn  # noqa: E402
from repro_torch.core import federated as tfed  # noqa: E402
from repro_torch.core.params import ParamLayout  # noqa: E402
from repro_torch.data import dirichlet_partition as t_partition  # noqa: E402
from repro_torch.data import make_classification_data as t_data  # noqa: E402
from repro_torch.data import sources as tsources  # noqa: E402
from repro_torch.experiments import tasks as ttasks  # noqa: E402
from repro_torch.optim import adam as tadam, paper_decay as tdecay, sgd as tsgd  # noqa: E402

SCHEME_VARIANTS = ["bernoulli_ti", "bernoulli_tv", "markov_hom",
                   "markov_nonhom", "cyclic", "cyclic_reset"]


# ---------------------------------------------------------------------------
# link processes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scheme", SCHEME_VARIANTS)
@pytest.mark.parametrize("traced_knobs", [False, True])
def test_link_process_matches_reference_given_same_uniforms(scheme,
                                                            traced_knobs):
    jcfg, tcfg = fed_configs(scheme)
    m, T, B = 12, 14, 3
    p_np = np.stack([np.asarray(jconn.build_base_probs(
        jax.random.PRNGKey(s), m, 10)[0]) for s in range(B)])
    gam = np.asarray([0.5, 0.3, 0.9], np.float32)
    per = np.asarray([40.0, 6.0, 9.0], np.float32)
    t_kw = (dict(gamma=torch.as_tensor(gam), period=torch.as_tensor(per))
            if traced_knobs else {})
    tlink = tconn.make_link_process(torch.as_tensor(p_np), tcfg, **t_kw)

    def jlink(b):
        kw = (dict(gamma=jnp.float32(gam[b]), period=jnp.float32(per[b]))
              if traced_knobs else {})
        return jconn.make_link_process(jnp.asarray(p_np[b]), jcfg, **kw)

    keys = [jax.random.PRNGKey(100 + b) for b in range(B)]
    jst = [jlink(b).init(keys[b]) for b in range(B)]
    u0 = np.stack([np.asarray(jax.random.uniform(keys[b], (m,)))
                   for b in range(B)])
    tst = tlink.init(torch.as_tensor(u0))
    for t in range(T):
        us, act, pts = [], [], []
        for b in range(B):
            k = jax.random.fold_in(keys[b], t + 1)
            u = np.asarray(jax.random.uniform(k, (m,)))
            if jcfg.scheme == "cyclic" and jcfg.cyclic_reset \
                    and t % jcfg.cyclic_length == 0:
                kc = jax.random.fold_in(jst[b]["key"],
                                        t // jcfg.cyclic_length)
                u = np.asarray(jax.random.uniform(kc, (m,)))
            a, p_t, jst[b] = jlink(b).sample(jst[b], jnp.int32(t), k)
            us.append(u)
            act.append(np.asarray(a))
            pts.append(np.asarray(p_t))
        a_t, p_t, tst = tlink.sample(tst, t, torch.as_tensor(np.stack(us)))
        np.testing.assert_array_equal(a_t.numpy(), np.stack(act))
        if traced_knobs:
            # per-trajectory gamma up to 0.9 and short periods: sin's 1-ulp
            # difference, scaled by gamma, plus the rounding of the Eq.-9
            # sum reach 2 ulp where (1 - gamma) + gamma * sin cancels; bound
            # it absolutely by the float32 spacing at 1.0 (p_t <= 1)
            np.testing.assert_allclose(p_t.numpy(), np.stack(pts), rtol=0,
                                       atol=2.0 ** -23)
        else:
            np.testing.assert_array_max_ulp(p_t.numpy(), np.stack(pts),
                                            maxulp=1)


def test_p_of_t_matches_reference_eq9():
    p = np.asarray(jconn.build_base_probs(jax.random.PRNGKey(0), 20, 10)[0])
    for t in (0, 1, 7, 39, 250):
        ref = np.asarray(jconn.p_of_t(jnp.asarray(p), jnp.int32(t),
                                      gamma=0.5, period=40))
        got = tconn.p_of_t(torch.as_tensor(p.copy())[None], t, gamma=0.5,
                           period=40)[0].numpy()
        np.testing.assert_array_max_ulp(got, ref, maxulp=1)


def test_build_base_probs_shape_and_clip():
    p, nu, r = tconn.build_base_probs(3, 50, 10, alpha=0.1, delta=0.02)
    assert p.shape == (50,) and p.dtype == np.float32
    assert nu.shape == (50, 10) and r.shape == (10,)
    assert p.min() >= 0.02 and p.max() <= 1.0
    np.testing.assert_array_equal(p, tconn.build_base_probs(3, 50, 10)[0])


# ---------------------------------------------------------------------------
# optimizers and schedules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["sgd", "sgd_momentum", "adam"])
def test_optimizer_steps_match_reference(kind):
    rng = np.random.default_rng(0)
    B, m, n = 2, 3, 10
    p0 = rng.normal(size=(B, m, n)).astype(np.float32)
    grads = rng.normal(size=(6, B, m, n)).astype(np.float32)
    eta0 = np.asarray([0.1, 0.05], np.float32)
    if kind == "adam":
        jo = [jadam(jdecay(jnp.float32(e))) for e in eta0]
        to = tadam(tdecay(torch.as_tensor(eta0)))
    else:
        mom = 0.9 if kind == "sgd_momentum" else 0.0
        jo = [jsgd(jdecay(jnp.float32(e)), momentum=mom) for e in eta0]
        to = tsgd(tdecay(torch.as_tensor(eta0)), momentum=mom)
    jp = [jnp.asarray(p0[b]) for b in range(B)]
    js = [jax.vmap(jo[b].init)(jp[b]) for b in range(B)]
    tp = torch.as_tensor(p0)
    ts = to.init(tp)
    for g in grads:
        for b in range(B):
            jp[b], js[b] = jax.vmap(jo[b].update)(jp[b], js[b],
                                                  jnp.asarray(g[b]))
        tp, ts = to.update(tp, ts, torch.as_tensor(g))
        np.testing.assert_array_max_ulp(
            tp.numpy(), np.stack([np.asarray(x) for x in jp]), maxulp=2)
        np.testing.assert_array_equal(
            ts["step"].numpy(), np.stack([np.asarray(s["step"]) for s in js]))


def test_paper_decay_matches_reference():
    steps = np.arange(0, 400, 7, dtype=np.int32)
    ref = np.asarray(jdecay(0.1)(jnp.asarray(steps)))
    got = tdecay(0.1)(torch.as_tensor(steps)).numpy()
    np.testing.assert_array_max_ulp(got, ref, maxulp=1)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def test_dataset_bytes_and_partition_match_reference():
    kw = dict(num_classes=10, dim=16, n_per_class=60, sep=3.0)
    xj, yj = j_data(5, **kw)
    xt, yt = t_data(5, **kw)
    assert xj.tobytes() == xt.tobytes() and yj.tobytes() == yt.tobytes()
    ij, nuj = j_partition(np.random.default_rng(5), yj, 8, 0.1, 16)
    it, nut = t_partition(np.random.default_rng(5), yt, 8, 0.1, 16)
    np.testing.assert_array_equal(ij, it)
    np.testing.assert_array_equal(nuj, nut)


def test_traced_task_data_and_batches_match_reference():
    jt, tt = tasks()
    for k in ("x", "y", "xt", "yt"):
        np.testing.assert_array_equal(np.asarray(jt.shared[k]),
                                      tt.shared[k].numpy())
    for alpha in (0.1, 1.0):
        np.testing.assert_array_equal(jt.partition(alpha), tt.partition(alpha))
    # the same index draw gives the same batches
    idx = jt.partition(0.1)
    key = jax.random.PRNGKey(3)
    jb, _ = jt.source_factory(jt.shared).sample({"idx": jnp.asarray(idx)}, 0,
                                                 key)
    m, s, b = SMALL["num_clients"], SMALL["local_steps"], SMALL["batch_size"]
    pick = np.asarray(jax.random.randint(key, (m, s, b), 0,
                                         SMALL["per_client"]))
    src = tt.source_factory(tt.shared)
    tb, _ = src.sample(src.init({"idx": torch.as_tensor(idx)[None]}), 0,
                       torch.as_tensor(pick)[None])
    np.testing.assert_array_equal(tb["x"][0].numpy(), np.asarray(jb["x"]))
    np.testing.assert_array_equal(tb["y"][0].numpy(), np.asarray(jb["y"]))
    # the constant-capturing source draws the same rows
    csrc = tsources.classification_source(tt.shared["x"], tt.shared["y"],
                                          torch.as_tensor(idx),
                                          local_steps=s, batch_size=b)
    cb, _ = csrc.sample(csrc.init(), 0, torch.as_tensor(pick)[None])
    assert torch.equal(cb["x"], tb["x"])
    assert src.pick_spec == (s, b, SMALL["per_client"])


def test_mlp_loss_and_accuracy_match_reference():
    jt, tt = tasks()
    params = jt.init_params(jax.random.PRNGKey(0))
    flat = convert.params_from_jax(np_tree(params), tt.layout)
    assert flat.shape == (tt.layout.size,)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(5, 16)).astype(np.float32)
    y = rng.integers(0, 10, size=5)
    ref = float(jt.loss_fn(params, {"x": jnp.asarray(x), "y": jnp.asarray(y)}))
    got = float(tt.loss_fn(flat[None, None], {"x": torch.as_tensor(x)[None, None],
                                              "y": torch.as_tensor(y)[None, None]}))
    assert abs(got - ref) <= 1e-6 * max(1.0, abs(ref))
    acc_j = float(jt.eval_test(params, jt.shared))
    acc_t = float(tt.eval_test(flat[None], tt.shared)[0])
    assert abs(acc_j - acc_t) <= 1.0 / tt.meta["n_test"] + 1e-7


def test_param_layout_views_share_the_buffer():
    lay = ttasks.mlp_layout(4, 3, 5)
    assert lay.size == 4 * 5 + 5 + 5 * 3 + 3
    flat = torch.zeros(2, 7, lay.size)
    v = lay.views(flat)
    assert v["w1"].shape == (2, 7, 4, 5) and v["b2"].shape == (2, 7, 3)
    v["w2"][1, 2, 0, 0] = 1.0
    assert float(flat.sum()) == 1.0           # views, not copies
    tree = {k: t.numpy() for k, t in v.items()}
    assert torch.equal(lay.flatten(tree, lead=(2, 7)), flat)


# ---------------------------------------------------------------------------
# aggregation branches
# ---------------------------------------------------------------------------

ALL_ALGOS = ["fedpbc", "fedpbc_m", "fedavg", "fedavg_all", "fedau", "mifa",
             "fedavg_known_p", "f3ast"]
_LAYOUT = ParamLayout((("a", (3, 4)), ("b", (5,))))


def _agg_inputs(rng, m, rounds):
    xs = rng.normal(size=(rounds, m, _LAYOUT.size)).astype(np.float32)
    active = rng.uniform(size=(rounds, m)) < 0.5
    active[1] = False                     # a zero-active round
    p_t = rng.uniform(0.0, 1.0, size=(rounds, m)).astype(np.float32)
    return xs, active, p_t


def _tree(flat):
    out = {}
    for name, shape, a, b in _LAYOUT.spans():
        out[name] = jnp.asarray(flat[..., a:b].reshape(flat.shape[:-1] + shape))
    return out


@pytest.mark.parametrize("name", ALL_ALGOS)
def test_each_branch_matches_reference(name):
    """Each of the 8 rules, statically dispatched, chained over 4 rounds
    (round 1 has no active client) on identical inputs."""
    rng = np.random.default_rng(ALL_ALGOS.index(name))
    m = 12
    xs, active, p_t = _agg_inputs(rng, m, 4)
    server0 = rng.normal(size=(_LAYOUT.size,)).astype(np.float32)
    jspec = jalg.AlgorithmSpec((name,), f3ast_cap=3)
    tspec = talg.AlgorithmSpec((name,), f3ast_cap=3)
    js, jserver = jspec.init(_tree(server0), m), _tree(server0)
    jclients = _tree(np.broadcast_to(server0, (m, _LAYOUT.size)).copy())
    tserver = torch.as_tensor(server0)[None]
    ts = tspec.init(tserver, m)
    tclients = tserver[:, None].expand(1, m, -1).clone()
    for r in range(4):
        before = tserver.clone()
        js, jserver, jclients = jspec.aggregate(
            0, js, jserver, jclients, _tree(xs[r]), jnp.asarray(active[r]),
            jnp.asarray(p_t[r]), jnp.int32(r))
        ts, tserver, tclients = tspec.aggregate(
            0, ts, tserver, tclients, torch.as_tensor(xs[r])[None],
            torch.as_tensor(active[r])[None], torch.as_tensor(p_t[r])[None], r)
        np.testing.assert_allclose(
            tserver[0].numpy(),
            convert.params_from_jax(np_tree(jserver), _LAYOUT).numpy(),
            rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(
            tclients[0].numpy(),
            convert.params_from_jax(np_tree(jclients), _LAYOUT).numpy(),
            rtol=1e-6, atol=1e-6)
        for f in ("gap", "sum_gaps", "n_gaps", "lam"):
            np.testing.assert_allclose(getattr(ts, f)[0].numpy(),
                                       np.asarray(getattr(js, f)),
                                       rtol=1e-6, atol=1e-6)
        if r == 1 and name in ("fedpbc", "fedavg", "f3ast"):
            # zero-active round keeps the server params
            assert torch.equal(tserver, before)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_family_with_per_trajectory_algo_id_matches_members(use_kernel):
    """A [B] algo_id over the family (branch select, or the fused kernel's
    plain version on CPU) equals each member run statically in JAX; the
    trajectories include a zero-active one."""
    rng = np.random.default_rng(9)
    m, B = 10, 8
    xs = rng.normal(size=(B, m, _LAYOUT.size)).astype(np.float32)
    active = rng.uniform(size=(B, m)) < 0.5
    active[3] = False
    p_t = rng.uniform(0.0, 1.0, size=(B, m)).astype(np.float32)
    server = rng.normal(size=(B, _LAYOUT.size)).astype(np.float32)
    clients = rng.normal(size=(B, m, _LAYOUT.size)).astype(np.float32)
    aid = np.arange(B) % 4
    tspec = talg.AlgorithmSpec(FAMILY)
    ts = tspec.init(torch.as_tensor(server), m)
    algo = tspec.bind(torch.as_tensor(aid), use_kernel=use_kernel)
    _, t_server, t_clients = algo.aggregate(
        ts, torch.as_tensor(server), torch.as_tensor(clients),
        torch.as_tensor(xs), torch.as_tensor(active), torch.as_tensor(p_t), 0)
    starts = algo.client_start(ts, torch.as_tensor(server),
                               torch.as_tensor(clients))
    jspec = jalg.AlgorithmSpec(FAMILY)
    for b in range(B):
        js = jspec.init(_tree(server[b]), m)
        _, jsv, jcl = jspec.aggregate(
            int(aid[b]), js, _tree(server[b]), _tree(clients[b]),
            _tree(xs[b]), jnp.asarray(active[b]), jnp.asarray(p_t[b]),
            jnp.int32(0))
        np.testing.assert_allclose(
            t_server[b].numpy(),
            convert.params_from_jax(np_tree(jsv), _LAYOUT).numpy(),
            rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(
            t_clients[b].numpy(),
            convert.params_from_jax(np_tree(jcl), _LAYOUT).numpy(),
            rtol=1e-6, atol=1e-6)
        jst = jspec.client_start(int(aid[b]), js, _tree(server[b]),
                                 _tree(clients[b]))
        np.testing.assert_array_equal(
            starts[b].numpy(),
            convert.params_from_jax(np_tree(jst), _LAYOUT).numpy())


def test_family_tables_match_reference():
    for name in ALL_ALGOS:
        assert talg.algo_family(name) == jalg.algo_family(name)
        assert talg.state_signature(name) == jalg.state_signature(name)
    assert talg.AlgorithmSpec(FAMILY).fusable
    assert not talg.AlgorithmSpec(("mifa",)).fusable
    with pytest.raises(ValueError):
        talg.AlgorithmSpec(("fedpbc", "nope"))


# ---------------------------------------------------------------------------
# the round engine against the jitted reference round
# ---------------------------------------------------------------------------

K_ROUNDS = 10


@pytest.fixture(scope="module", params=["bernoulli_tv", "markov_nonhom",
                                        "cyclic_reset"])
def family(request):
    """4 trajectories, one per family member, each with its own seed."""
    return JaxFamily(request.param, seeds=(0, 1, 2, 3), algo_ids=(0, 1, 2, 3))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_round_fn_resynced_every_round_matches_reference(family, use_kernel):
    step, ds = family.port_parts(use_kernel)
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
                                   np.asarray(jm["loss"]), rtol=1e-5, atol=1e-5)
        assert_state_close(ps, np_tree(st), family.layout, atol=1e-5,
                           rtol=1e-5)
        if family.tfed_cfg.scheme == "markov":
            np.testing.assert_array_equal(ps.link_state.numpy(),
                                          np.asarray(st.link_state))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_round_fn_drift_over_ten_rounds_without_resync(family, use_kernel):
    step, ds = family.port_parts(use_kernel)
    st = family.init()
    u, pick, off = family.draws(st)
    ps = family.port_state(st, off)
    for _ in range(K_ROUNDS):
        u, pick, _ = family.draws(st)
        ps, ds, _ = step(ps, ds, tfed.RoundDraws(torch.as_tensor(u),
                                                 torch.as_tensor(pick)))
        st, _ = family.round(st, pick)
    assert_state_close(ps, np_tree(st), family.layout, atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# Fig. 3 quadratic counterexample (the examples/quickstart.py setup)
# ---------------------------------------------------------------------------


def test_fig3_quadratic_fedpbc_beats_fedavg():
    from repro_torch.configs import FederationConfig
    from repro_torch.experiments.sweep import seed_generators

    M, D, S, ROUNDS, ETA = 20, 16, 10, 400, 2e-3
    rng = np.random.default_rng(0)
    u = (np.arange(M) / M)[:, None] + 0.1 * rng.normal(size=(M, D))
    u = torch.as_tensor(u, dtype=torch.float32)
    x_star = u.mean(0)
    p = torch.where(torch.arange(M) < M // 2, 0.9, 0.1)[None]

    def loss(params, batch):
        return 0.5 * ((params - batch["u"]) ** 2).sum(-1)

    def run(algorithm):
        fed = FederationConfig(algorithm=algorithm, num_clients=M,
                               local_steps=S)
        algo = talg.make_algorithm(fed)
        link = tconn.make_link_process(p, fed)
        opt = tsgd(ETA)
        source = tsources.fixed_source({"u": u[:, None].expand(M, S, D)})
        run_rounds = tfed.make_run_rounds(loss, opt, algo, link, fed, source,
                                          device="cpu")
        draws = tfed.GeneratorDraws([seed_generators(0)], num_clients=M)
        state = tfed.init_fed_state(draws.link_init(), torch.zeros(1, D), fed,
                                    algo, link, opt)
        state, _, mets = run_rounds(state, source.init(), draws, ROUNDS)
        assert mets["loss"].shape == (1, ROUNDS)
        return float(torch.linalg.norm(state.server[0] - x_star))

    err_avg, err_pbc = run("fedavg"), run("fedpbc")
    assert err_pbc < 0.5 * err_avg, (err_pbc, err_avg)


# ---------------------------------------------------------------------------
# entry points default to the card
# ---------------------------------------------------------------------------


def test_entry_points_raise_without_cuda(monkeypatch):
    from repro_torch.experiments import grid, sweep

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = grid.SweepSpec(algorithms=("fedpbc",), rounds=1, num_clients=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        grid.run_sweep(spec)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        grid.run_cell_batch(spec, "fedpbc", "bernoulli_ti")
    fed = fed_configs("bernoulli_ti")[1]
    link = tconn.make_link_process(torch.full((1, 4), 0.5), fed)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfed.make_run_rounds(lambda p, b: p.sum(-1), tsgd(0.1),
                             talg.fedpbc(), link, fed,
                             tsources.fixed_source({}))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sweep.main(["--algos", "fedpbc", "--rounds", "1", "--clients", "4"])


def test_constant_task_matches_traced_task_at_one_alpha():
    """``make_classification_task`` captures the partition at one alpha;
    with the same pick it serves the traced task's batches and evals."""
    kw = {k: SMALL[k] for k in ("num_clients", "dim", "hidden", "per_client",
                                "local_steps", "batch_size", "n_per_class",
                                "n_train")}
    const = ttasks.make_classification_task(data_seed=0, alpha=0.1,
                                            device="cpu", **kw)
    _, traced = tasks()
    m, s, b = SMALL["num_clients"], SMALL["local_steps"], SMALL["batch_size"]
    pick = torch.randint(0, SMALL["per_client"], (1, m, s, b),
                         generator=torch.Generator().manual_seed(0))
    cb, _ = const.source.sample(const.source.init(), 0, pick)
    src = traced.source_factory(traced.shared)
    idx = torch.as_tensor(traced.partition(0.1))[None]
    tb, _ = src.sample(src.init({"idx": idx}), 0, pick)
    assert torch.equal(cb["x"], tb["x"]) and torch.equal(cb["y"], tb["y"])
    server = traced.init_params(torch.Generator().manual_seed(1))[None]
    assert torch.equal(const.eval_test(server),
                       traced.eval_test(server, traced.shared))

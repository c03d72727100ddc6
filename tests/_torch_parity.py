"""Shared harness of the PyTorch-port parity tests (``test_torch_*.py``).

The JAX reference runs jitted on the CPU; its draws (link uniforms, batch
indices, initial parameters, Eq.-9 ``p_base``) are computed from its own
keys with ``jax.random`` and handed to the port, so both packages see the
same numbers. Everything crosses as numpy.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.base import FederationConfig as JFed
from repro.core import algorithms as jalg
from repro.core import connectivity as jconn
from repro.core import federated as jfed
from repro.experiments import grid as jgrid
from repro.experiments import sweep as jsweep
from repro.experiments import tasks as jtasks
from repro.optim import paper_decay as jdecay
from repro.optim import sgd as jsgd

from _torch_draws import TensorDraws
from repro_torch import convert
from repro_torch.configs import FederationConfig as TFed
from repro_torch.core import algorithms as talg
from repro_torch.core import connectivity as tconn
from repro_torch.core import federated as tfed
from repro_torch.experiments import tasks as ttasks
from repro_torch.optim import paper_decay as tdecay
from repro_torch.optim import sgd as tsgd

FAMILY = ("fedpbc", "fedavg", "fedavg_all", "fedavg_known_p")
# the small protocol every parity test runs at
SMALL = dict(num_clients=8, dim=16, hidden=16, local_steps=2, batch_size=4,
             per_client=16, n_per_class=60, n_train=400)
# the LM task's, tests/test_lm_sweep.py's LM spec (head dim 8)
LM_SMALL = dict(num_clients=4, d_model=32, layers=1, seq_len=16, classes=4,
                n_seqs=64, n_test=16, per_client=8, local_steps=2,
                batch_size=1)
LR, GAMMA, PERIOD, CYCLE = 0.1, 0.5, 6.0, 4


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def fed_configs(scheme: str, algorithm="fedpbc",
                num_clients=SMALL["num_clients"],
                local_steps=SMALL["local_steps"]):
    """Matching reference / port configs for a ``SCHEMES`` entry, with a
    short cyclic period so resets happen within a few rounds."""
    kw = dict(algorithm=algorithm, num_clients=num_clients,
              local_steps=local_steps, cyclic_length=CYCLE,
              **jgrid.SCHEMES[scheme])
    return JFed(**kw), TFed(**kw)


def tasks(device="cpu"):
    kw = {k: SMALL[k] for k in ("num_clients", "dim", "hidden", "per_client",
                                "local_steps", "batch_size", "n_per_class",
                                "n_train")}
    return (jtasks.make_traced_classification_task(data_seed=0, **kw),
            ttasks.make_traced_classification_task(data_seed=0, device=device,
                                                   **kw))


def lm_tasks(device="cpu", **kw):
    """The reference's and the port's LM task at ``LM_SMALL`` (``kw``
    overrides it)."""
    kw = dict(LM_SMALL, **kw)
    return (jtasks.make_traced_lm_task(data_seed=0, **kw),
            ttasks.make_traced_lm_task(data_seed=0, device=device, **kw))


def task_batches(jtask, idx, pick):
    """The reference task's batches for ``pick [B, m, s, b]`` into the
    client shards ``idx [m, pc]`` (numpy gather of its ``shared``)."""
    sel = idx[np.arange(idx.shape[0])[None, :, None, None], pick]
    sh = jtask.shared
    if "toks" in sh:
        seqs = np.asarray(sh["toks"])[sel]
        return {"tokens": jnp.asarray(seqs[..., :-1]),
                "labels": jnp.asarray(seqs[..., 1:])}
    return {"x": jnp.asarray(np.asarray(sh["x"])[sel]),
            "y": jnp.asarray(np.asarray(sh["y"])[sel])}


class JaxFamily:
    """B trajectories of the reference family (member ``algo_id[b]``, seed
    ``seeds[b]``; ``family`` the quartet by default) as one jitted, vmapped
    round, plus the round's draws computed from the reference's own keys
    (each trajectory's at its own round). ``task``: ``"classification"``
    (the MLP task at ``SMALL``) or ``"lm"`` (the LM task at
    ``LM_SMALL``)."""

    def __init__(self, scheme: str, seeds, algo_ids, alpha=0.1,
                 family=FAMILY, task="classification"):
        self.scheme = scheme
        self.family = family
        self.jtask, self.ttask = tasks() if task == "classification" \
            else lm_tasks()
        meta = self.jtask.meta
        m, s, b = (meta["num_clients"], meta["local_steps"],
                   meta["batch_size"])
        pc = meta["per_client"]
        self.jfed_cfg, self.tfed_cfg = fed_configs(scheme, family[0], m, s)
        self.spec = jalg.make_algorithm_spec(family, self.jfed_cfg)
        self.idx = self.jtask.partition(alpha)
        B = len(seeds)
        self.B = B
        self.keys = jsweep.stack_seed_keys(seeds)
        self.p_base = jnp.stack([jconn.build_base_probs(
            jax.random.PRNGKey(s), m, 10)[0] for s in seeds])
        self.algo_id = jnp.asarray(algo_ids, jnp.int32)
        self.hp = {k: jnp.full((B,), v, jnp.float32)
                   for k, v in (("lr", LR), ("gamma", GAMMA),
                                ("period", PERIOD))}
        fed, spec, task = self.jfed_cfg, self.spec, self.jtask

        def link(p, hp):
            return jconn.make_link_process(p, fed, gamma=hp["gamma"],
                                           period=hp["period"])

        def init_one(k, p, hp):
            opt = jsgd(jdecay(hp["lr"]))
            return jfed.init_fed_state(k["state"], task.init_params(k["params"]),
                                       fed, spec, link(p, hp), opt)

        def round_one(st, batches, p, hp, aid):
            rf = jfed.make_round_fn(task.loss_fn, jsgd(jdecay(hp["lr"])), spec,
                                    link(p, hp), fed, algo_id=aid)
            return rf(st, batches)

        reset = fed.scheme == "cyclic" and fed.cyclic_reset

        def draws_one(st, data_key):
            _, k_link = jax.random.split(st.key)
            u = jax.random.uniform(k_link, (m,))
            if reset:
                kc = jax.random.fold_in(st.link_state["key"],
                                        st.round // fed.cyclic_length)
                u_cyc = jax.random.uniform(kc, (m,))
                u = jnp.where(st.round % fed.cyclic_length == 0, u_cyc, u)
            else:
                u_cyc = u
            pick = jax.random.randint(jax.random.fold_in(data_key, st.round),
                                      (m, s, b), 0, pc)
            return u, u_cyc, pick

        self._init = jax.jit(jax.vmap(init_one))
        self._round = jax.jit(jax.vmap(round_one))
        self._draws = jax.jit(jax.vmap(draws_one))
        self.layout = self.ttask.layout

    def init(self):
        return self._init(self.keys, self.p_base, self.hp)

    def draws(self, st):
        """``(u, pick, cycle_offsets)`` for the round ``st`` is about to run
        (numpy); ``cycle_offsets`` are the current cycle's reset offsets."""
        u, u_cyc, pick = self._draws(st, self.keys["data"])
        off = u_cyc * (1.0 - self.p_base) * self.jfed_cfg.cyclic_length
        return np.asarray(u), np.asarray(pick), np.asarray(off)

    def batches(self, pick):
        return task_batches(self.jtask, self.idx, pick)

    def round(self, st, pick):
        return self._round(st, self.batches(pick), self.p_base, self.hp,
                           self.algo_id)

    # -- the port's counterparts --------------------------------------------

    def port_parts(self, use_kernel: bool, device="cpu"):
        """The port's round step and its source state for this family."""
        p = torch.as_tensor(np.asarray(self.p_base), device=device)
        hp = {k: torch.as_tensor(np.asarray(v), device=device)
              for k, v in self.hp.items()}
        link = tconn.make_link_process(p, self.tfed_cfg, gamma=hp["gamma"],
                                       period=hp["period"])
        spec = talg.make_algorithm_spec(self.family, self.tfed_cfg)
        aid = torch.as_tensor(np.asarray(self.algo_id), dtype=torch.long,
                              device=device)
        rf = tfed.make_round_fn(self.ttask.loss_fn, tsgd(tdecay(hp["lr"])),
                                spec, link, self.tfed_cfg, algo_id=aid,
                                use_kernel=use_kernel)
        source = self.ttask.source_factory(self.ttask.shared)
        idx = torch.as_tensor(np.broadcast_to(self.idx, (self.B,)
                                              + self.idx.shape).copy(),
                              device=device)
        return tfed.make_round_step(rf, source), source.init({"idx": idx})

    def port_state(self, st, cycle_offsets=None, device="cpu"):
        """The reference state re-synced into the port's ``FedState``."""
        ps = convert.fed_state_from_jax(np_tree(st), self.layout,
                                        self.tfed_cfg.scheme, device)
        if self.tfed_cfg.scheme == "cyclic" and self.tfed_cfg.cyclic_reset:
            ps.link_state = {"offset": torch.as_tensor(cycle_offsets,
                                                       device=device)}
        return ps


def assert_state_close(port, ref_np, layout, *, atol, rtol):
    """Port ``FedState`` vs a numpy reference ``FedState`` (leading [B])."""
    np.testing.assert_allclose(
        port.server.numpy(),
        convert.params_from_jax(ref_np.server, layout).numpy(),
        atol=atol, rtol=rtol)
    np.testing.assert_allclose(
        port.clients.numpy(),
        convert.params_from_jax(ref_np.clients, layout).numpy(),
        atol=atol, rtol=rtol)
    np.testing.assert_array_equal(port.opt_state["step"].numpy(),
                                  ref_np.opt_state["step"])
    np.testing.assert_array_equal(port.last_active.numpy(),
                                  ref_np.last_active)
    if isinstance(port.round, torch.Tensor):    # trajectories' own rounds
        np.testing.assert_array_equal(port.round.numpy(), ref_np.round)
    else:
        assert port.round == int(np.unique(ref_np.round)[0])


class JaxKeyDraws(TensorDraws):
    """The port's drawer interface (``params`` / ``link_init`` / call, and
    the re-packing ``copy`` / ``take`` / ``select`` / ``concat``) fed from
    the reference's per-seed keys: trajectory ``b`` with seed ``seeds[b]``
    gets the initial model, link uniforms and batch indices the
    reference's own per-trajectory run draws. The call takes the round as
    an int or as a ``[B]`` tensor (row ``b`` gets round ``t[b]``'s draws,
    as the reference's vmapped round folds each trajectory's own round
    into its key); the draws are a function of (seed, round), so re-packed
    rows need no state. Its ``take``/``select``/``concat`` give plain
    ``TensorDraws``, which pickle without JAX (a sharded run sends each
    rank its rows)."""

    def __init__(self, seeds, jfed_cfg, jtask, layout, num_rounds):
        meta = jtask.meta
        m, s, b = (meta["num_clients"], meta["local_steps"],
                   meta["batch_size"])
        pc = meta["per_client"]
        L = jfed_cfg.cyclic_length
        reset = jfed_cfg.scheme == "cyclic" and jfed_cfg.cyclic_reset
        keys = [jsweep.seed_keys(sd) for sd in seeds]
        params = convert.params_from_jax(
            np_tree(jax.vmap(jtask.init_params)(
                jnp.stack([k["params"] for k in keys]))), layout)
        init_u, us, picks = [], [], []
        for k in keys:
            k_link, key = jax.random.split(k["state"])
            init_u.append(np.asarray(jax.random.uniform(k_link, (m,))))
            traj_u, traj_pick = [], []
            for t in range(num_rounds):
                key, k_round = jax.random.split(key)
                u = jax.random.uniform(k_round, (m,))
                if reset and t % L == 0:
                    u = jax.random.uniform(jax.random.fold_in(k_link, t // L),
                                           (m,))
                pick = jax.random.randint(jax.random.fold_in(k["data"], t),
                                          (m, s, b), 0, pc)
                traj_u.append(np.asarray(u))
                traj_pick.append(np.asarray(pick))
            us.append(np.stack(traj_u))
            picks.append(np.stack(traj_pick))
        super().__init__(params, torch.as_tensor(np.stack(init_u)),
                         torch.as_tensor(np.stack(us)),       # [B, R, m]
                         torch.as_tensor(np.stack(picks)))    # [B, R, m, s, b]


def lm_round_draws(vocab, seed, rounds, m, s, batch, seq):
    """The reference launcher's own LM draws for ``rounds`` rounds, as the
    port's ``RoundDraws`` ``[1, ...]``: link uniforms from its state key
    (``init_fed_state``'s split of ``PRNGKey(seed + 2)``), token draws from
    ``fold_in(PRNGKey(seed + 4), round)``; and the source offsets ``lo``
    of ``PRNGKey(seed + 3)``."""
    half = vocab // 2
    _, key = jax.random.split(jax.random.PRNGKey(seed + 2))
    data_key = jax.random.PRNGKey(seed + 4)
    lo = np.array(jax.random.randint(jax.random.PRNGKey(seed + 3), (m,), 0,
                                     half))
    draws = []
    for t in range(rounds):
        key, k_link = jax.random.split(key)
        u = np.array(jax.random.uniform(k_link, (m,)))
        pick = np.array(jax.random.randint(
            jax.random.fold_in(data_key, t), (m, s, batch, seq), 0, half))
        draws.append(tfed.RoundDraws(torch.as_tensor(u)[None],
                                     torch.as_tensor(pick)[None]))
    return lo, draws

"""RLlib's learners: the port against the JAX package, update by update,
on the CPU.

Every case starts both packages from the JAX package's initialised
params, carried over by ``convert.rl_params_from_jax``, and feeds both
the same batch; where the update samples on the learner (SAC, CQL), the
JAX package's own draws are passed to the port as its noise.  The
batched V-trace loss, its aux and every gradient leaf are held at rtol
1e-5 / atol 1e-6; ``TorchLearner`` against ``JaxLearner`` after 4 epochs
of minibatches, and one update of DQN (double-Q, PER weights), BC,
MARWIL, SAC, CQL and IQL, at 1e-5.  Then the twins of the JAX package's
RLModule tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ray_tpu.rllib as jrl
import ray_tpu.rllib.dqn as jdqn
import ray_tpu.rllib.impala as jimpala
import ray_tpu.rllib.iql as jiql
import ray_tpu.rllib.ppo as jppo
import ray_tpu.rllib.sac as jsac
import ray_tpu_torch.rllib as trl
import ray_tpu_torch.rllib.dqn as tdqn
import ray_tpu_torch.rllib.impala as timpala
import ray_tpu_torch.rllib.ppo as tppo
import ray_tpu_torch.rllib.sac as tsac
from ray_tpu_torch.convert import rl_params_from_jax
from ray_tpu_torch.rllib.algorithm import Adam, to_numpy, tree_paths
from torch_rllib_common import one_intra_op_thread  # noqa: F401

TOL = 1e-5


def _np(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def _assert_tree_close(got, want, rtol=TOL, atol=TOL, what=""):
    got = dict(tree_paths(to_numpy(got)))
    want = dict(tree_paths(_np(want)))
    assert sorted(got) == sorted(want), (sorted(got), sorted(want))
    for path in want:
        np.testing.assert_allclose(got[path], want[path], rtol=rtol,
                                   atol=atol, err_msg=f"{what} {path}")


# ------------------------------------------------- weights across packages
def test_rl_params_from_jax_flat_nested_and_bare():
    flat = jppo._init_policy(jax.random.PRNGKey(0), 4, 2, 8)
    got = rl_params_from_jax(flat, "cpu")
    assert sorted(got) == ["b1", "bp", "bv", "w1", "wp", "wv"]
    assert all(t.dtype == torch.float32 and t.device.type == "cpu"
               for t in got.values())
    np.testing.assert_array_equal(got["w1"].numpy(), np.asarray(flat["w1"]))
    multi = jrl.MultiRLModule({
        "a": jrl.RLModuleSpec(jrl.DiscretePolicyModule).build(4, 2),
        "b": jrl.RLModuleSpec(jiql.IQLModule, {"hidden": 8}).build(3, 1),
    }).init_state(jax.random.PRNGKey(1))
    nested = rl_params_from_jax(multi, "cpu")
    assert sorted(nested["b"]) == ["pi", "q1", "q2", "v"]
    np.testing.assert_array_equal(nested["b"]["v"]["w2"].numpy(),
                                  np.asarray(multi["b"]["v"]["w2"]))
    # f64 leaves come over as f32; a bare array as a 0-d tensor.
    assert rl_params_from_jax({"w0": np.ones((2, 2))}, "cpu")["w0"].dtype \
        == torch.float32
    alpha = rl_params_from_jax(np.asarray(np.log(0.1), np.float32), "cpu")
    assert alpha.shape == () and abs(float(alpha) - np.log(0.1)) < 1e-7


def test_rl_params_from_jax_needs_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rl_params_from_jax({"w0": np.ones(2)})


def test_adam_is_optax_adam():
    params = {"a": jnp.asarray(np.linspace(-1, 1, 6, dtype=np.float32)),
              "b": {"c": jnp.asarray(np.ones((2, 3), np.float32))}}
    tx = optax.adam(3e-3)
    st = tx.init(params)
    port = rl_params_from_jax(_np(params), "cpu")
    ptx = Adam(3e-3)
    pst = ptx.init(port)
    rng = np.random.default_rng(0)
    for _ in range(5):
        g = jax.tree.map(lambda x: jnp.asarray(
            rng.normal(size=x.shape).astype(np.float32)), params)
        upd, st = tx.update(g, st, params)
        params = optax.apply_updates(params, upd)
        port, pst = ptx.step(port, rl_params_from_jax(_np(g), "cpu"), pst)
    _assert_tree_close(port, params, rtol=1e-6, atol=1e-7)


# --------------------------------------------------------------- V-trace
def _trajectories(n, t, obs_size=4, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.normal(size=(n, t, obs_size)).astype(np.float32),
        "actions": rng.integers(0, 2, (n, t)).astype(np.int32),
        "rewards": rng.normal(1.0, 0.5, (n, t)).astype(np.float32),
        "dones": (rng.random((n, t)) < 0.1).astype(np.float32),
        # Off-policy: a behaviour policy other than the current one.
        "logp_old": np.log(rng.uniform(0.2, 0.8, (n, t))).astype(np.float32),
        "last_value": rng.normal(size=n).astype(np.float32),
    }


@pytest.mark.parametrize("appo", [False, True])
def test_vtrace_loss_aux_and_grads_match_jax(appo):
    kw = dict(gamma=0.99, rho_bar=1.0, c_bar=0.9, use_appo_clip=appo)
    jparams = jppo._init_policy(jax.random.PRNGKey(0), 4, 2, 32)
    # A policy far enough from uniform that the ratios spread and clip.
    jparams["wp"] = jparams["wp"] * 100.0
    batch = _trajectories(8, 16)
    jloss_fn = jimpala.make_vtrace_loss(**kw)

    def jmean(p):
        losses, aux = jax.vmap(lambda b: jloss_fn(p, b))(
            {k: jnp.asarray(v) for k, v in batch.items()})
        return jnp.mean(losses), jax.tree.map(jnp.mean, aux)

    (jl, jaux), jgrads = jax.value_and_grad(jmean, has_aux=True)(jparams)
    tloss_fn = timpala.make_vtrace_loss(**kw)
    tparams = {k: v.requires_grad_(True) for k, v in
               rl_params_from_jax(_np(jparams), "cpu").items()}
    tl, taux = tloss_fn(tparams, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    tgrads = dict(zip(tparams, torch.autograd.grad(tl, list(
        tparams.values()))))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5,
                               atol=1e-6)
    for got, want in zip(taux, jaux):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5,
                                   atol=1e-6)
    for k in jgrads:
        np.testing.assert_allclose(tgrads[k].numpy(), np.asarray(jgrads[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_vtrace_single_trajectory_is_n_of_one():
    jparams = jppo._init_policy(jax.random.PRNGKey(2), 4, 2, 32)
    one = {k: v[0] for k, v in _trajectories(1, 12, seed=3).items()}
    jl, _ = jimpala.make_vtrace_loss(gamma=0.9)(
        jparams, {k: jnp.asarray(v) for k, v in one.items()})
    tb = timpala.trajectory_batch(
        {**one, "last_value": float(one["last_value"])}, "cpu")
    assert tb["obs"].shape == (1, 12, 4) and tb["last_value"].shape == (1,)
    tl, _ = timpala.make_vtrace_loss(gamma=0.9)(
        rl_params_from_jax(_np(jparams), "cpu"), tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------- PPO learner
def test_torch_learner_matches_jax_learner_after_4_epochs():
    cfg = dict(minibatch_size=64, num_sgd_epochs=4, seed=5)
    jl = jppo.JaxLearner(jppo.PPOConfig(**cfg), 4, 2)
    tl = tppo.TorchLearner(tppo.PPOConfig(device="cpu", **cfg), 4, 2)
    tl.params = rl_params_from_jax(jl.get_params(), "cpu")
    tl.opt_state = tl.tx.init(tl.params)
    rng = np.random.default_rng(1)
    n = 256
    batch = {
        "obs": rng.normal(size=(n, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, n).astype(np.int32),
        "logp_old": np.log(rng.uniform(0.3, 0.7, n)).astype(np.float32),
        "advantages": rng.normal(size=n).astype(np.float32),
        "returns": rng.normal(1.0, 1.0, n).astype(np.float32),
    }
    jstats = jl.update_minibatches(batch)
    tstats = tl.update_minibatches(batch)
    assert sorted(jstats) == sorted(tstats)
    for k in jstats:
        np.testing.assert_allclose(tstats[k], jstats[k], rtol=TOL, atol=TOL)
    _assert_tree_close(tl.params, jl.get_params(), what="ppo")
    assert isinstance(tl.get_params()["w1"], np.ndarray)


# ------------------------------------------------------------- DQN update
def _no_runners(monkeypatch):
    for mod in (jdqn, tdqn):
        monkeypatch.setattr(mod, "FaultTolerantActorManager",
                            lambda *a, **k: None)


@pytest.mark.parametrize("prioritized", [False, True])
def test_dqn_td_update_matches_jax(monkeypatch, prioritized):
    _no_runners(monkeypatch)
    ja = jrl.DQNConfig().debugging(seed=2).build()
    tc = trl.DQNConfig().debugging(seed=2)
    tc.device = "cpu"
    ta = tc.build()
    params = _np(ja.params)
    target = jax.tree.map(lambda x: x * 0.5, params)  # a target that lags
    rng = np.random.default_rng(4)
    b = 64
    batch = {
        "obs": rng.normal(size=(b, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, b).astype(np.int64),
        "rewards": rng.normal(size=b).astype(np.float32),
        "next_obs": rng.normal(size=(b, 4)).astype(np.float32),
        "dones": (rng.random(b) < 0.2).astype(np.float32),
    }
    w = (rng.uniform(0.2, 1.0, b) if prioritized else np.ones(b)).astype(
        np.float32)
    jp, jst, jloss, jtd = ja._td_update(
        params, target, ja.tx.init(params),
        {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(w))
    tp = rl_params_from_jax(params, "cpu")
    tp, _, tloss, ttd = ta._td_update(
        tp, rl_params_from_jax(target, "cpu"), ta.tx.init(tp),
        {k: torch.from_numpy(v) for k, v in batch.items()},
        torch.from_numpy(w))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=TOL)
    np.testing.assert_allclose(ttd.numpy(), np.asarray(jtd), rtol=TOL,
                               atol=TOL)
    _assert_tree_close(tp, jp, what="dqn")


# ------------------------------------------------------------- BC / MARWIL
@pytest.mark.parametrize("cls", ["BCConfig", "MARWILConfig"])
def test_bc_and_marwil_update_matches_jax(cls):
    rng = np.random.default_rng(0)
    data = {"obs": rng.normal(size=(256, 4)).astype(np.float32),
            "actions": rng.integers(0, 3, 256).astype(np.int64),
            "advantages": rng.normal(0, 0.5, 256).astype(np.float32)}
    ja = getattr(jrl, cls)().offline(data).build()
    ta = getattr(trl, cls)().offline(data).training(device="cpu").build()
    assert ta.config.beta == ja.config.beta
    params = _np(ja.params)
    batch = {k: v[:128] for k, v in ja.data.items()}
    jp, _, jloss = ja._update(params, ja.tx.init(params),
                              {k: jnp.asarray(v) for k, v in batch.items()})
    tp = rl_params_from_jax(params, "cpu")
    tp, _, tloss = ta._update(tp, ta.tx.init(tp),
                              {k: torch.from_numpy(v)
                               for k, v in batch.items()})
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=TOL)
    _assert_tree_close(tp, jp, what=cls)


# ------------------------------------------------------- SAC, CQL and IQL
def _transitions(b, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.normal(size=(b, 3)).astype(np.float32),
        "actions": rng.uniform(-0.99, 0.99, (b, 1)).astype(np.float32),
        "rewards": rng.normal(-2.0, 1.0, b).astype(np.float32),
        "next_obs": rng.normal(size=(b, 3)).astype(np.float32),
        "dones": rng.random(b) < 0.1,
    }


def _sac_noise(key, b, a):
    """The draws the JAX update makes from ``key``, for the port."""
    k1, k2, k3 = jax.random.split(key, 3)
    return k3, {"next": torch.from_numpy(np.array(
                    jax.random.normal(k1, (b, a)))),
                "actor": torch.from_numpy(np.array(
                    jax.random.normal(k2, (b, a))))}


def test_sac_update_matches_jax():
    b, hidden = 64, 16
    jmod = jrl.RLModuleSpec(jrl.SACModule, {"hidden": hidden}).build(3, 1)
    tmod = trl.RLModuleSpec(trl.SACModule, {"hidden": hidden}).build(3, 1)
    params = _np(jmod.init_state(jax.random.PRNGKey(0)))
    target = jax.tree.map(lambda x: x * 0.9, params)
    log_alpha = np.asarray(np.log(0.1), np.float32)
    tx = optax.adam(3e-3)
    jupdate = jsac.make_sac_update(jmod, tx, tx, 0.99, 0.01, -1.0)
    batch = _transitions(b)
    key = jax.random.PRNGKey(7)
    jout = jupdate(params, target, jnp.asarray(log_alpha), tx.init(params),
                   tx.init(jnp.asarray(log_alpha)),
                   {k: jnp.asarray(v) for k, v in batch.items()}, key)
    _, noise = _sac_noise(key, b, 1)
    ptx = Adam(3e-3)
    tp = rl_params_from_jax(params, "cpu")
    ta = rl_params_from_jax(log_alpha, "cpu")
    tupdate = tsac.make_sac_update(tmod, ptx, ptx, 0.99, 0.01, -1.0)
    tout = tupdate(tp, rl_params_from_jax(target, "cpu"), ta, ptx.init(tp),
                   ptx.init(ta), {k: torch.from_numpy(v)
                                  for k, v in batch.items()},
                   None, noise)
    for what, i in (("params", 0), ("target", 1), ("log_alpha", 2)):
        _assert_tree_close(tout[i], jout[i], what=what)
    assert sorted(tout[5]) == sorted(jout[5])
    for k in jout[5]:
        np.testing.assert_allclose(float(tout[5][k]), float(jout[5][k]),
                                   rtol=TOL, atol=1e-6, err_msg=k)


def _offline(algo_cfg, data, **hp):
    return algo_cfg.offline(data).training(**hp).build()


def test_cql_update_matches_jax():
    b, n_rand = 64, 4
    data = _transitions(512, seed=1)
    hp = dict(batch_size=b, hidden=16, cql_n_actions=n_rand,
              learn_steps_per_iter=1, seed=3)
    ja = _offline(jrl.CQLConfig(), data, **hp)
    ta = _offline(trl.CQLConfig(), data, device="cpu", **hp)
    params, target = _np(ja.params), _np(ja.target_params)
    la = np.asarray(ja.log_alpha)
    batch = _transitions(b, seed=2)
    batches = {k: jnp.asarray(v[None], jnp.float32 if k != "dones" else None)
               for k, v in batch.items()}
    base = jax.random.PRNGKey(11)
    jout = ja._update_many(params, target, jnp.asarray(la),
                           ja.tx.init(params), ja.alpha_tx.init(la),
                           batches, base)
    (key,) = jax.random.split(base, 1)
    k3, noise = _sac_noise(key, b, 1)
    krand, kpi = jax.random.split(k3)
    noise["extra"] = {
        "rand_a": torch.from_numpy(np.array(jax.random.uniform(
            krand, (n_rand, b, 1), minval=-1.0, maxval=1.0))),
        "pi_eps": torch.from_numpy(np.array(
            jax.random.normal(kpi, (b, 1))))}
    ta.params = rl_params_from_jax(params, "cpu")
    ta.target_params = rl_params_from_jax(target, "cpu")
    ta.log_alpha = rl_params_from_jax(la, "cpu")
    ta.opt_state = ta.tx.init(ta.params)
    ta.alpha_opt_state = ta.alpha_tx.init(ta.log_alpha)
    stats = ta.update_many({k: torch.from_numpy(np.array(v))
                            for k, v in batches.items()}, noises=[noise])
    _assert_tree_close(ta.params, jout[0], what="params")
    _assert_tree_close(ta.target_params, jout[1], what="target")
    _assert_tree_close(ta.log_alpha, jout[2], what="log_alpha")
    assert float(stats["extra_critic_loss"]) != 0.0
    for k in jout[5]:
        np.testing.assert_allclose(float(stats[k]), float(jout[5][k]),
                                   rtol=TOL, atol=1e-6, err_msg=k)


def test_iql_update_matches_jax():
    b = 64
    data = _transitions(512, seed=1)
    hp = dict(batch_size=b, hidden=16, learn_steps_per_iter=1, seed=3)
    ja = _offline(jrl.IQLConfig(), data, **hp)
    ta = _offline(trl.IQLConfig(), data, device="cpu", **hp)
    params, target = _np(ja.params), _np(ja.target_params)
    batch = _transitions(b, seed=2)
    batches = {k: jnp.asarray(v[None], jnp.float32 if k != "dones" else None)
               for k, v in batch.items()}
    jout = ja._update_many(params, target, ja.tx.init(params), batches,
                           jax.random.PRNGKey(0))
    tp = rl_params_from_jax(params, "cpu")
    tout = ta._update(tp, rl_params_from_jax(target, "cpu"), ta.tx.init(tp),
                      {k: torch.from_numpy(v) for k, v in batch.items()})
    _assert_tree_close(tout[0], jout[0], what="params")
    _assert_tree_close(tout[1], jout[1], what="target")
    for k in jout[3]:
        np.testing.assert_allclose(float(tout[3][k]), float(jout[3][k]),
                                   rtol=TOL, atol=1e-6, err_msg=k)


# ----------------------------------------------------------- the RLModules
def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def test_discrete_module_forwards():
    mod = trl.RLModuleSpec(trl.DiscretePolicyModule, {"hidden": 16}).build(
        4, 2)
    params = mod.init_state(_gen(0))
    batch = {"obs": np.zeros((3, 4), np.float32)}
    inf = mod.forward_inference(params, batch)
    assert inf["actions"].shape == (3,)
    exp = mod.forward_exploration(params, batch, _gen(1))
    assert exp["action_logp"].shape == (3,)
    tr = mod.forward_train(params, batch)
    assert tr["logits"].shape == (3, 2) and tr["vf_preds"].shape == (3,)
    # The same weights give the JAX module's outputs.
    jmod = jrl.RLModuleSpec(jrl.DiscretePolicyModule, {"hidden": 16}).build(
        4, 2)
    jp = jmod.init_state(jax.random.PRNGKey(0))
    obs = np.random.default_rng(0).normal(size=(5, 4)).astype(np.float32)
    want = jmod.forward_train(jp, {"obs": obs})
    got = mod.forward_train(rl_params_from_jax(_np(jp), "cpu"),
                            {"obs": obs})
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), rtol=1e-6,
                                   atol=1e-6)


def test_categorical_draws_follow_the_probabilities():
    logits = torch.log(torch.tensor([[0.7, 0.2, 0.1]])).expand(20000, 3)
    draws = trl.rl_module.categorical(_gen(3), logits)
    freq = torch.bincount(draws, minlength=3).float() / 20000
    assert torch.allclose(freq, torch.tensor([0.7, 0.2, 0.1]), atol=0.015)


def test_sac_module_tanh_bounds_and_logp():
    mod = trl.RLModuleSpec(trl.SACModule, {"hidden": 16}).build(3, 1)
    params = mod.init_state(_gen(0))
    obs = np.random.default_rng(0).normal(size=(64, 3)).astype(np.float32)
    a, logp = mod.sample_action(params, obs, _gen(1))
    assert a.shape == (64, 1) and torch.all(a.abs() <= 1.0)
    assert torch.isfinite(logp).all()
    q1, q2 = mod.q_values(params, obs, a)
    assert q1.shape == (64,) and not torch.allclose(q1, q2)
    # With the JAX module's weights and noise, its sample and log-prob.
    jmod = jrl.RLModuleSpec(jrl.SACModule, {"hidden": 16}).build(3, 1)
    jp = jmod.init_state(jax.random.PRNGKey(0))
    key = jax.random.PRNGKey(1)
    ja, jlogp = jmod.sample_action(jp, obs, key)
    eps = torch.from_numpy(np.array(jax.random.normal(key, (64, 1))))
    ta, tlogp = mod.sample_action(rl_params_from_jax(_np(jp), "cpu"), obs,
                                  eps=eps)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tlogp.numpy(), np.asarray(jlogp), rtol=1e-5,
                               atol=1e-5)


def test_multi_rl_module():
    multi = trl.MultiRLModule({
        "a": trl.RLModuleSpec(trl.DiscretePolicyModule).build(4, 2),
        "b": trl.RLModuleSpec(trl.SACModule).build(3, 1),
    })
    params = multi.init_state(_gen(0))
    assert set(params.keys()) == {"a", "b"}
    assert set(multi.keys()) == {"a", "b"}
    assert isinstance(multi["b"], trl.SACModule)
    again = multi.init_state(_gen(0))
    assert all(torch.equal(x, y) for (_, x), (_, y) in
               zip(tree_paths(params), tree_paths(again)))


def test_iql_module_has_value_net():
    mod = trl.RLModuleSpec(trl.IQLModule, {"hidden": 16}).build(3, 1)
    params = mod.init_state(_gen(0))
    assert "v" in params
    v = mod.v_values(params, np.zeros((4, 3), np.float32))
    assert v.shape == (4,)

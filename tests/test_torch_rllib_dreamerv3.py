"""DreamerV3 in the port, held against the JAX package on the CPU.

The pieces (symlog, the MLP, the GRU, the KL, the straight-through latent
sample), the world-model loss with every gradient leaf, the imagination
rollout, the lambda returns, the actor-critic loss with every gradient
leaf, one whole update with global-norm clipping and Adam, the runner's
act step and the sequence buffer, each on the same inputs made from a
numpy seed, with the JAX draws passed in as noise; then twins of
``tests/test_rllib_dreamerv3.py``'s two training tests, the learner on
``device="cpu"``.

The losses, gradients and updates are compared in float64 on both sides
(JAX under ``jax.enable_x64``, the port on f64 tensors), so that the
tolerances test the math and not the order of f32 roundings: in f32 the
two packages' world-model gradients differ by up to ~1e-5 of a leaf's
scale (reductions over the batch and the time loop in another order),
and the same noise moves the parameters after an update alike.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ray_tpu_torch
from ray_tpu.rllib import dreamerv3 as jd
from ray_tpu_torch.convert import rl_params_from_jax
from ray_tpu_torch.rllib import DreamerV3Config
from ray_tpu_torch.rllib import dreamerv3 as td
from ray_tpu_torch.rllib.algorithm import (
    to_numpy,
    tree_map,
    tree_paths,
    value_and_grad,
)
from ray_tpu_torch.rllib.env import CartPole, Pendulum
from torch_rllib_common import one_intra_op_thread  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6
T = 12
ENVS = {"cartpole": (4, 2, True), "pendulum": (3, 1, False)}


def _t(x):
    """An array as a tensor of the same dtype (f64 under ``x64``)."""
    return torch.from_numpy(np.array(x))


def _conv(tree):
    """JAX params → the port's, through the converter, then f64."""
    return tree_map(lambda x: x.double(), rl_params_from_jax(tree, "cpu"))


@pytest.fixture
def x64():
    with jax.enable_x64():
        yield


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol, err_msg=what)


def _close_trees(got, want, rtol=RTOL, atol=ATOL):
    """Leaf by leaf, in ``jax.tree.leaves``' order."""
    got = [(p, np.asarray(x)) for p, x in tree_paths(to_numpy(got))]
    want = jax.tree.leaves(want)
    assert len(got) == len(want)
    for (path, g), w in zip(got, want):
        _close(g, w, rtol, atol, what=str(path))


def _setup(env, seed=0):
    obs_size, act_size, discrete = ENVS[env]
    jhp = jd._Hyper()
    thp = td._Hyper(device="cpu")
    k_wm, k_ac = jax.random.split(jax.random.PRNGKey(seed))
    f64 = lambda a: np.asarray(a, np.float32).astype(np.float64)  # noqa: E731
    jwm = jax.tree.map(f64, jd.init_world_model(k_wm, jhp, obs_size,
                                                act_size))
    jac = jax.tree.map(f64, jd.init_actor_critic(k_ac, jhp, act_size,
                                                 discrete))
    return jhp, thp, jwm, jac, _conv(jwm), _conv(jac)


def _batch(env, seed=1, B=8):
    obs_size, act_size, discrete = ENVS[env]
    rng = np.random.default_rng(seed)
    if discrete:
        actions = np.eye(act_size, dtype=np.float32)[
            rng.integers(act_size, size=(B, T))]
    else:
        actions = rng.uniform(-1, 1, (B, T, act_size)).astype(np.float32)
    dones = (rng.random((B, T)) < 0.1).astype(np.float32)
    is_first = np.zeros((B, T), np.float32)
    is_first[:, 0] = 1.0
    is_first[:, 1:] = dones[:, :-1]
    batch = {
        "obs": rng.normal(size=(B, T, obs_size)).astype(np.float32) * 2,
        "actions": actions,
        "rewards": rng.normal(size=(B, T)).astype(np.float32),
        "dones": dones,
        "is_first": is_first,
    }
    return {k: v.astype(np.float64) for k, v in batch.items()}


def _wm_noise(key, hp, B):
    """The Gumbel noise the JAX world model draws from ``key``."""
    return np.stack([np.asarray(jax.random.gumbel(k, (B, hp.stoch,
                                                      hp.classes)))
                     for k in jax.random.split(key, T)])


def _ac_noise(key, hp, N, act_size, discrete):
    """The draws of the JAX imagination from ``key``: per step, the action's
    (Gumbel or Gaussian) from the first half of its key, the latent's
    Gumbel from the second."""
    acts, lats = [], []
    for k in jax.random.split(key, hp.horizon):
        ka, kz = jax.random.split(k)
        draw = jax.random.gumbel if discrete else jax.random.normal
        acts.append(np.asarray(draw(ka, (N, act_size))))
        lats.append(np.asarray(jax.random.gumbel(kz, (N, hp.stoch,
                                                      hp.classes))))
    return {"action": _t(np.stack(acts)), "latent": _t(np.stack(lats))}


# ----------------------------------------------------------------- pieces
def test_symlog_symexp_mlp_gru_kl():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(5, 7)).astype(np.float32) * 5
    _close(td.symlog(_t(x)), jd.symlog(x), 1e-6, 1e-6)
    _close(td.symexp(_t(x)), jd.symexp(x), 1e-6, 1e-6)
    mlp = jd._mlp_init(jax.random.PRNGKey(3), [7, 16, 4], 0.5)
    _close(td._mlp(rl_params_from_jax(mlp, "cpu"), _t(x)),
           jd._mlp(mlp, x), 1e-6, 1e-6)
    gru = jd._gru_init(jax.random.PRNGKey(4), 7, 6)
    h = rng.normal(size=(5, 6)).astype(np.float32)
    _close(td._gru(rl_params_from_jax(gru, "cpu"), _t(h), _t(x)),
           jd._gru(gru, h, x), 1e-6, 1e-6)
    a = rng.normal(size=(5, 8, 8)).astype(np.float32)
    b = rng.normal(size=(5, 8, 8)).astype(np.float32)
    _close(td._kl(_t(a), _t(b)), jd._kl(a, b), 1e-6, 1e-6)


def test_sample_latent_and_its_straight_through_gradient():
    hp = jd._Hyper()
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(6, hp.stoch * hp.classes)).astype(np.float32)
    w = rng.normal(size=(6, hp.stoch * hp.classes)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    g = np.asarray(jax.random.gumbel(key, (6, hp.stoch, hp.classes)))

    # The passed Gumbel noise picks jax.random.categorical's indices.
    mixed = np.asarray(jnp.log(0.99 * jax.nn.softmax(
        logits.reshape(6, hp.stoch, hp.classes)) + 0.01 / hp.classes))
    np.testing.assert_array_equal(
        np.argmax(mixed + g, -1),
        np.asarray(jax.random.categorical(key, mixed)))

    (jst, jl) = jd._sample_latent(key, logits, hp)
    tst, tl = td._sample_latent(_t(logits), hp, gumbel_noise=_t(g))
    _close(tst.detach(), jst, 1e-6, 1e-6)
    _close(tl, jl, 1e-6, 1e-6)

    jgrad = jax.grad(
        lambda lg: (jd._sample_latent(key, lg, hp)[0] * w).sum())(logits)
    lt = _t(logits).requires_grad_(True)
    (td._sample_latent(lt, hp, gumbel_noise=_t(g))[0] * _t(w)).sum() \
        .backward()
    _close(lt.grad, jgrad, 1e-5, 1e-6)


# ----------------------------------------------------------- world model
@pytest.mark.parametrize("env", sorted(ENVS))
def test_world_model_loss_and_gradients(env, x64):
    jhp, thp, jwm, _, twm, _ = _setup(env)
    batch = _batch(env)
    key = jax.random.PRNGKey(5)
    (jloss, (jfeat, jmet)), jgrads = jax.jit(jax.value_and_grad(
        jd.make_wm_loss(jhp), has_aux=True))(jwm, key, batch)
    noise = _t(_wm_noise(key, jhp, 8))
    tloss, (tfeat, tmet), tgrads = value_and_grad(
        td.make_wm_loss(thp), twm, {k: _t(v) for k, v in batch.items()},
        None, noise)
    _close(tloss, jloss)
    _close(tfeat.detach(), jfeat)
    assert sorted(tmet) == sorted(jmet)
    for k in jmet:
        _close(tmet[k], jmet[k], what=k)
    _close_trees(tgrads, jgrads)


# ---------------------------------------------------------- actor-critic
def _feat0(jhp, jwm, env, key):
    batch = _batch(env)
    _, (feat, _) = jd.make_wm_loss(jhp)(jwm, key, batch)
    return np.asarray(feat).reshape(-1, feat.shape[-1])


@pytest.mark.parametrize("env", sorted(ENVS))
def test_imagine_lambda_returns_and_actor_critic_gradients(env, x64):
    _, act_size, discrete = ENVS[env]
    jhp, thp, jwm, jac, twm, tac = _setup(env)
    feat0 = _feat0(jhp, jwm, env, jax.random.PRNGKey(6))
    key = jax.random.PRNGKey(7)
    noise = _ac_noise(key, jhp, feat0.shape[0], act_size, discrete)
    _, jimagine, jupdate = jd.make_ac_update(jhp, discrete, act_size)
    _, timagine, tupdate = td.make_ac_update(thp, discrete, act_size)

    jtraj = jax.jit(jimagine)(jwm, jac, key, feat0)
    ttraj = timagine(twm, tac, _t(feat0), noise=noise)
    for name, g, w in zip(("feat", "feat2", "logp", "ent", "rew", "cont"),
                          ttraj, jtraj):
        _close(g.detach(), w, what=name)

    # Lambda returns against the JAX body's reverse scan, on its numbers.
    rew, cont = np.asarray(jtraj[4]), np.asarray(jtraj[5])
    values = np.random.default_rng(3).normal(size=rew.shape)

    def back(acc, xs):
        r, d, v = xs
        ret = r + d * ((1 - jhp.lam) * v + jhp.lam * acc)
        return ret, ret

    _, want = jax.lax.scan(back, values[-1], (rew, cont * jhp.gamma,
                                              values), reverse=True)
    _close(td.lambda_returns(_t(rew), _t(cont), _t(values), thp), want)

    ret_std = np.float32(1.7)
    jloss, jgrads, jmean, jstd = jax.jit(jupdate)(jwm, jac, key, feat0,
                                                  ret_std)
    tloss, tgrads, tmean, tstd = tupdate(twm, tac, _t(feat0), ret_std,
                                         noise=noise)
    _close(tloss, jloss)
    _close(tmean, jmean)
    _close(tstd, jstd)
    _close_trees(tgrads, jgrads)


# ------------------------------------------------------- one whole update
def _jax_train_once(jhp, discrete, act_size):
    """The JAX learner's ``train_once`` (its ``DreamerV3.setup``), with the
    optimizers it builds there."""
    wm_tx = optax.chain(optax.clip_by_global_norm(100.0),
                        optax.adam(jhp.wm_lr))
    ac_tx = optax.chain(optax.clip_by_global_norm(100.0),
                        optax.adam(jhp.ac_lr))
    wm_loss = jd.make_wm_loss(jhp)
    _, _, ac_update = jd.make_ac_update(jhp, discrete, act_size)

    def train_once(wm, ac, wm_opt, ac_opt, key, batch, ret_std):
        k1, k2 = jax.random.split(key)
        (_, (feat, metrics)), wm_grads = jax.value_and_grad(
            wm_loss, has_aux=True)(wm, k1, batch)
        up, wm_opt = wm_tx.update(wm_grads, wm_opt, wm)
        wm = optax.apply_updates(wm, up)
        feat0 = jax.lax.stop_gradient(feat.reshape(-1, feat.shape[-1]))
        acl, ac_grads, ret_mean, new_std = ac_update(wm, ac, k2, feat0,
                                                     ret_std)
        up, ac_opt = ac_tx.update(ac_grads, ac_opt, ac)
        ac = optax.apply_updates(ac, up)
        metrics = dict(metrics)
        metrics.update(ac_loss=acl, imag_return=ret_mean)
        return wm, ac, wm_opt, ac_opt, new_std, metrics, wm_grads

    return wm_tx, ac_tx, jax.jit(train_once)


@pytest.mark.parametrize("env,blowup", [("cartpole", 1.0),
                                        ("pendulum", 1.0),
                                        ("cartpole", 30.0)])
def test_train_once_with_clipping_and_adam(env, blowup, x64):
    """Two updates in a row, each from the same params and optimizer state
    on both sides (the JAX ones): a difference of one rounding in the
    params could flip a near-tie of a latent's argmax in the next update.
    ``blowup`` scales the decoder's weights so the world model's gradient
    norm passes the clip (100)."""
    _, act_size, discrete = ENVS[env]
    jhp, thp, jwm, jac, _, _ = _setup(env)
    jwm["dec"] = [{"w": l["w"] * blowup, "b": l["b"]} for l in jwm["dec"]]
    wm_tx, ac_tx, jtrain = _jax_train_once(jhp, discrete, act_size)
    jwm_opt, jac_opt = wm_tx.init(jwm), ac_tx.init(jac)
    ttx_wm, ttx_ac = td.ClippedAdam(thp.wm_lr), td.ClippedAdam(thp.ac_lr)
    ttrain = td.make_train_once(thp, discrete, act_size, ttx_wm, ttx_ac)

    def port_opt(state):  # optax's chain state → the port's Adam state
        adam = state[1][0]
        return {"count": int(adam.count), "mu": tree_map(_t, adam.mu),
                "nu": tree_map(_t, adam.nu)}

    ret_std = np.float32(1.0)
    norms = []
    for step in range(2):
        batch = _batch(env, seed=10 + step)
        key = jax.random.PRNGKey(20 + step)
        k1, k2 = jax.random.split(key)
        noise = {"wm": _t(_wm_noise(k1, jhp, 8)),
                 "ac": _ac_noise(k2, jhp, 8 * T, act_size, discrete)}
        (twm, tac, twm_opt, tac_opt, tstd, tmet) = ttrain(
            tree_map(_t, jwm), tree_map(_t, jac), port_opt(jwm_opt),
            port_opt(jac_opt), {k: _t(v) for k, v in batch.items()},
            ret_std, None, noise)
        (jwm, jac, jwm_opt, jac_opt, jstd, jmet, jg) = jtrain(
            jwm, jac, jwm_opt, jac_opt, key, batch, ret_std)
        norms.append(float(optax.global_norm(jg)))
        _close(tstd, jstd)
        for k in jmet:
            _close(tmet[k], jmet[k], what=k)
        _close_trees(twm, jwm)
        _close_trees(tac, jac)
        for got, want in ((twm_opt, jwm_opt), (tac_opt, jac_opt)):
            assert got["count"] == int(want[1][0].count)
            _close_trees(got["mu"], want[1][0].mu)
            _close_trees(got["nu"], want[1][0].nu)
        ret_std = 0.99 * ret_std + 0.01 * float(jstd)
    if blowup > 1:
        assert min(norms) > 100.0, norms


def test_clip_by_global_norm_matches_optax(x64):
    rng = np.random.default_rng(4)
    tree = {"a": [{"w": rng.normal(size=(3, 4)) * 40, "b": rng.normal(
        size=4)}], "c": {"x": rng.normal(size=5) * 30}}
    tree = jax.tree.map(lambda a: np.asarray(a, np.float64), tree)
    for max_norm in (10.0, 1e4):
        want, _ = optax.clip_by_global_norm(max_norm).update(tree, None)
        got = td.clip_by_global_norm(tree_map(_t, tree), max_norm)
        _close_trees(got, want, 1e-6, 1e-6)


# ------------------------------------------------------------- the runner
@pytest.mark.parametrize("env", sorted(ENVS))
def test_runner_act_step(env, x64):
    """The numpy act step against the JAX runner's, on its own draws."""
    obs_size, act_size, discrete = ENVS[env]
    jhp, thp, jwm, jac, _, _ = _setup(env)
    policy, _, _ = jd.make_ac_update(jhp, discrete, act_size)

    @jax.jit
    def jax_act(key, obs, h, z, a_prev, first):  # the JAX runner's act
        kz, ka = jax.random.split(key)
        mask = 1.0 - first
        h, z, a_prev = h * mask, z * mask, a_prev * mask
        h = jd._gru(jwm["gru"], h[None],
                    jnp.concatenate([z, a_prev])[None])[0]
        emb = jd._mlp(jwm["enc"], jd.symlog(obs))
        post = jd._mlp(jwm["post"], jnp.concatenate([h, emb]))
        z, _ = jd._sample_latent(kz, post[None], jhp)
        z = z[0]
        a, _, _ = policy(jac, ka, jnp.concatenate([h, z])[None])
        return a[0], h, z

    np_wm = jax.tree.map(np.asarray, jwm)
    np_ac = jax.tree.map(np.asarray, jac)
    rng = np.random.default_rng(8)
    h = np.zeros(jhp.deter, np.float32)
    z = np.zeros(jhp.stoch * jhp.classes, np.float32)
    a = np.zeros(act_size, np.float32)
    for t in range(5):
        obs = rng.normal(size=obs_size).astype(np.float32)
        first = np.float32(t in (0, 3))
        key = jax.random.PRNGKey(40 + t)
        kz, ka = jax.random.split(key)
        lat = np.asarray(jax.random.gumbel(kz, (1, jhp.stoch,
                                                jhp.classes)))[0]
        draw = jax.random.gumbel if discrete else jax.random.normal
        act = np.asarray(draw(ka, (1, act_size)))[0]
        ja, jh, jz = jax_act(key, obs, h, z, a, first)
        ta, th, tz = td.act_np(np_wm, np_ac, thp, discrete, obs, h, z, a,
                               first, lat, act)
        _close(th, jh, 1e-5, 1e-6)
        _close(tz, jz, 0, 1e-12)  # one-hot (JAX's straight-through sum)
        _close(ta, ja, 1e-5, 1e-6)
        h, z, a = th, tz, ta


def test_sequence_buffer_windows_equal():
    rng = np.random.default_rng(5)
    jb, tb = jd.SequenceBuffer(500, seed=3), td.SequenceBuffer(500, seed=3)
    for _ in range(3):
        batch = {"obs": rng.normal(size=(128, 4)).astype(np.float32),
                 "is_first": (rng.random(128) < 0.05).astype(np.float32)}
        jb.add_batch(batch)
        tb.add_batch(batch)
    for _ in range(3):
        want, got = jb.sample(8, 12), tb.sample(8, 12)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


# ------------------------------------------------- training (the JAX twins)
@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()


def _build(env, **training):
    cfg = (
        DreamerV3Config()
        .environment(env)
        .env_runners(1, rollout_steps=128)
        .debugging(seed=7)
    )
    defaults = dict(min_buffer=256, train_ratio=4, batch_size=8, seq_len=12,
                    device="cpu")
    defaults.update(training)
    return cfg.training(**defaults).build()


def test_dreamer_world_model_learns_cartpole(cluster):
    algo = _build(CartPole)
    wm0, ac0 = to_numpy(algo.wm), to_numpy(algo.ac)
    losses = []
    for _ in range(6):
        result = algo.train()
        if "wm_loss" in result:
            losses.append(result["wm_loss"])
    assert len(losses) >= 4, f"never reached min_buffer: {result}"
    assert all(np.isfinite(l) for l in losses)
    # The world model fits the dynamics: loss drops from first to last.
    assert losses[-1] < losses[0], losses
    assert np.isfinite(result["imag_return"])

    def moved(a, b):
        return sum(float(np.abs(x - y).sum()) for (_, x), (_, y) in
                   zip(tree_paths(a), tree_paths(to_numpy(b))))

    assert moved(wm0, algo.wm) > 0
    assert moved(ac0, algo.ac) > 0
    algo.stop()


def test_dreamer_continuous_and_checkpoint(cluster, tmp_path):
    algo = _build(Pendulum, min_buffer=128)
    for _ in range(3):
        result = algo.train()
    assert result["buffer_size"] > 0
    path = algo.save(str(tmp_path))
    it = algo.iteration

    algo2 = _build(Pendulum, min_buffer=128)
    algo2.restore(path)
    assert algo2.iteration == it
    np.testing.assert_allclose(
        algo2.wm["gru"]["wi"].numpy(), algo.wm["gru"]["wi"].numpy(),
    )
    algo.stop()
    algo2.stop()

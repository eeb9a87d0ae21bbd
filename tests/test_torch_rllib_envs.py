"""RLlib's environments and host-side data pieces: the port against the
JAX package, on the CPU.

``CartPoleTorch`` and ``PendulumTorch`` are held against ``CartPoleJax``
and ``PendulumJax`` transition by transition on the same states and
actions (atol 1e-5), then against the numpy envs; auto-reset, truncation
and the batched env axis are the twins of ``TestJaxEnvParity``.  The
numpy pieces the port copies (``CartPole``, ``Pendulum``, the replay
buffers, the connectors) must give the JAX package's outputs exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu.rllib as jrl
from ray_tpu.rllib.env import CartPoleJax, PendulumJax
import ray_tpu_torch.rllib as trl
from ray_tpu_torch.rllib.env import CartPoleTorch, PendulumTorch
from torch_rllib_common import one_intra_op_thread  # noqa: F401

ATOL = 1e-5


def _cartpole_cases(n, seed):
    rng = np.random.default_rng(seed)
    states = rng.uniform(-0.15, 0.15, (n, 4)).astype(np.float32)
    actions = rng.integers(0, 2, n).astype(np.int32)
    return states, actions


def _pendulum_cases(n, seed):
    rng = np.random.default_rng(seed)
    th = rng.uniform(-np.pi, np.pi, n)
    thdot = rng.uniform(-4.0, 4.0, n)
    u = rng.uniform(-2.5, 2.5, n)  # includes the clip boundary
    states = np.stack([th, thdot], -1).astype(np.float32)
    return states, u.astype(np.float32)


def _torch_step(env, phys, actions, steps=0):
    n = len(phys)
    state = {"phys": torch.from_numpy(phys),
             "steps": torch.full((n,), steps, dtype=torch.int32)}
    _, obs, rew, done = env.step(torch.Generator().manual_seed(1), state,
                                 torch.from_numpy(actions))
    return obs.numpy(), rew.numpy(), done.numpy()


def _jax_step(env, phys, actions, steps=0):
    n = len(phys)
    state = {"phys": jnp.asarray(phys),
             "steps": jnp.full((n,), steps, jnp.int32)}
    keys = jax.random.split(jax.random.PRNGKey(1), n)
    _, obs, rew, done = env.vec_step(keys, state, jnp.asarray(actions))
    return np.asarray(obs), np.asarray(rew), np.asarray(done)


@pytest.mark.parametrize("name", ["cartpole", "pendulum"])
def test_transitions_match_jax(name):
    if name == "cartpole":
        tenv, jenv = CartPoleTorch(), CartPoleJax()
        phys, actions = _cartpole_cases(500, 0)
    else:
        tenv, jenv = PendulumTorch(), PendulumJax()
        phys, actions = _pendulum_cases(500, 1)
    tobs, trew, tdone = _torch_step(tenv, phys, actions)
    jobs, jrew, jdone = _jax_step(jenv, phys, actions)
    np.testing.assert_array_equal(tdone, jdone)
    np.testing.assert_allclose(trew, jrew, atol=ATOL, rtol=0)
    live = ~tdone  # past done each env has reset from its own draws
    assert live.sum() >= 250
    np.testing.assert_allclose(tobs[live], jobs[live], atol=ATOL, rtol=0)


def test_cartpole_matches_numpy_env():
    env, ne = CartPoleTorch(), trl.CartPole(seed=0)
    phys, actions = _cartpole_cases(100, 0)
    tobs, trew, tdone = _torch_step(env, phys, actions)
    compared = 0
    for i in range(100):
        ne.state, ne.steps = phys[i].copy(), 0
        nobs, nrew, ndone, _ = ne.step(int(actions[i]))
        assert bool(tdone[i]) == ndone
        assert float(trew[i]) == nrew == 1.0
        if not ndone:  # post-done the torch env has auto-reset
            np.testing.assert_allclose(tobs[i], nobs, atol=ATOL)
            compared += 1
    assert compared >= 50  # the sweep must mostly hit live states


def test_pendulum_matches_numpy_env():
    env, npd = PendulumTorch(), trl.Pendulum(seed=0)
    phys, u = _pendulum_cases(100, 1)
    tobs, trew, _ = _torch_step(env, phys, u)
    for i in range(100):
        npd.state, npd.steps = phys[i].astype(np.float64), 0
        nobs, nrew, _, _ = npd.step(u[i])
        np.testing.assert_allclose(tobs[i], nobs, atol=ATOL)
        np.testing.assert_allclose(trew[i], nrew, atol=ATOL)


def test_cartpole_auto_reset():
    env = CartPoleTorch()
    # A state past the angle threshold terminates on any action...
    state = {"phys": torch.tensor([[0.0, 0.0, 0.5, 0.0]]),
             "steps": torch.tensor([10], dtype=torch.int32)}
    new_state, obs, _, done = env.step(torch.Generator().manual_seed(0),
                                       state, torch.tensor([0]))
    assert bool(done[0])
    # ...and the returned state belongs to a FRESH episode.
    assert int(new_state["steps"][0]) == 0
    assert torch.all(new_state["phys"].abs() <= 0.05)
    assert torch.equal(obs, new_state["phys"])


def test_pendulum_truncation_auto_reset():
    env = PendulumTorch(max_steps=5)
    state = {"phys": torch.tensor([[0.1, 0.0]]),
             "steps": torch.tensor([4], dtype=torch.int32)}
    new_state, _, _, done = env.step(torch.Generator().manual_seed(0),
                                     state, torch.tensor([0.0]))
    assert bool(done[0])  # 5th step truncates
    assert int(new_state["steps"][0]) == 0


def test_vectorized_env_axis():
    env = CartPoleTorch()
    gen = torch.Generator().manual_seed(0)
    state, obs = env.reset(gen, 8)
    assert obs.shape == (8, 4) and state["phys"].shape == (8, 4)
    # Each env draws its own reset noise.
    assert len(torch.unique(obs[:, 0])) > 1
    state2, obs2, rew, done = env.step(gen, state,
                                       torch.ones(8, dtype=torch.long))
    assert obs2.shape == (8, 4) and rew.shape == (8,)
    assert done.shape == (8,) and done.dtype == torch.bool
    # The same generator seed gives the same envs.
    _, again = env.reset(torch.Generator().manual_seed(0), 8)
    assert torch.equal(again, obs)


def test_auto_reset_keeps_each_envs_draw_only_where_done():
    env = PendulumTorch(max_steps=3)
    gen = torch.Generator().manual_seed(4)
    state = {"phys": torch.tensor([[0.2, 0.1], [0.3, -0.2]]),
             "steps": torch.tensor([2, 0], dtype=torch.int32)}
    new, _, _, done = env.step(gen, state, torch.zeros(2))
    assert done.tolist() == [True, False]
    assert new["steps"].tolist() == [0, 1]
    # The live env stepped its own dynamics; the done one took its reset.
    _, o, _, _ = env.step(torch.Generator(), {
        "phys": state["phys"][1:], "steps": state["steps"][1:]},
        torch.zeros(1))
    assert torch.allclose(env.obs(new)[1], o[0])


# ----------------------------------------------------- the numpy copies
@pytest.mark.parametrize("pkg", ["CartPole", "Pendulum"])
def test_numpy_envs_equal_jax_packages(pkg):
    outs = []
    for mod in (jrl, trl):
        env = getattr(mod, pkg)(seed=3)
        obs, trace = env.reset(), []
        rng = np.random.default_rng(0)
        for _ in range(300):
            a = int(rng.integers(0, 2)) if pkg == "CartPole" else \
                rng.uniform(-2, 2, 1)
            obs, r, d, _ = env.step(a)
            trace.append((obs.copy(), r, d))
            if d:
                obs = env.reset()
        outs.append(trace)
    for (o1, r1, d1), (o2, r2, d2) in zip(*outs):
        np.testing.assert_array_equal(o1, o2)
        assert r1 == r2 and d1 == d2


def _batch(n, base=0):
    return {
        "obs": np.arange(base, base + n, dtype=np.float32)[:, None],
        "actions": np.zeros(n, np.int64),
    }


def test_replay_buffers_equal_jax_packages():
    outs = []
    for mod in (jrl, trl):
        buf = mod.ReplayBuffer(capacity=10, seed=2)
        buf.add_batch(_batch(15))
        per = mod.PrioritizedReplayBuffer(capacity=100, seed=1)
        per.add_batch(_batch(50))
        s = per.sample(16)
        per.update_priorities(s["_indices"], np.linspace(0.1, 9, 16))
        outs.append((len(buf), buf.sample(32), s, per.sample(64)))
    (n1, *a), (n2, *b) = outs
    assert n1 == n2 == 10
    assert a[0]["obs"].min() >= 5  # the oldest 5 were overwritten
    for x, y in zip(a, b):
        assert sorted(x) == sorted(y)
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])


def test_connectors_equal_jax_packages():
    def run(mod):
        pipe = mod.ConnectorPipeline([mod.ObsToFloatBatch()])
        pipe.append(mod.NormalizeObs())
        rng = np.random.default_rng(0)
        normed = [pipe({"obs": rng.normal(size=(4, 3))})["obs"]
                  for _ in range(3)]
        scaled = mod.ScaleActions(-2.0, 2.0)(
            {"actions": np.array([-1.0, 0.0, 1.0])})["actions"]
        clipped = mod.ClipActions(-0.5, 0.5)(
            {"actions": np.array([-1.0, 0.2, 1.0])})["actions"]
        gae = mod.ComputeGAE(gamma=0.9, lam=0.8)(
            {"rewards": rng.normal(size=20), "dones": rng.random(20) < 0.2,
             "vf_preds": rng.normal(size=20)}, last_value=0.7)
        adv = mod.NormalizeAdvantages()(
            {"advantages": rng.normal(size=20)})["advantages"]
        return normed + [scaled, clipped, gae["advantages"],
                         gae["returns"], adv]

    for x, y in zip(run(jrl), run(trl)):
        np.testing.assert_array_equal(x, y)

"""RLlib's algorithms in a port cluster, on the CPU.

First the whole-run parity: IMPALA (1 runner, rollout 64, 3 batches a
step, 2 ``train()`` calls) and PPO (1 runner) run in a JAX cluster, which
is shut down, then in a port cluster with their learners on
``device="cpu"`` and their initial params taken from the JAX package's
initialisation (carried by ``convert.rl_params_from_jax``).  The runners'
numpy samplers are shared, so the two loss sequences must agree within
rtol 1e-5.  Then the twins of ``tests/test_rllib.py`` and
``tests/test_rllib_algos.py`` (actor manager, DQN, PER and checkpoint,
IMPALA, APPO, BC from dicts and from Data, MARWIL, PPO's runner
replacement and learning) and of the BC Tuner of
``tests/test_tune_schedulers.py``.
"""

import jax
import numpy as np
import pytest

import ray_tpu
import ray_tpu.rllib as jrl
import ray_tpu.rllib.ppo as jppo
import ray_tpu_torch
import ray_tpu_torch.rllib as trl
import ray_tpu_torch.rllib.ppo as tppo
from ray_tpu_torch.convert import rl_params_from_jax
from ray_tpu_torch.rllib.ppo import _compute_gae
from torch_rllib_common import one_intra_op_thread  # noqa: F401

PARITY_SEED = 7
PPO_PARITY = dict(num_env_runners=1, rollout_steps=256, num_sgd_epochs=2,
                  minibatch_size=64, seed=PARITY_SEED)


def _impala_parity(rl, **extra):
    cfg = (rl.IMPALAConfig().env_runners(1, rollout_steps=64)
           .training(batches_per_step=3, **extra).debugging(PARITY_SEED))
    algo = cfg.build()
    try:
        return [algo.train()["loss"] for _ in range(2)]
    finally:
        algo.stop()


def _ppo_parity(rl, **extra):
    algo = rl.PPOConfig(**PPO_PARITY, **extra).build()
    try:
        return [algo.train() for _ in range(2)]
    finally:
        algo.stop()


def _jax_init(seed):
    return jax.tree.map(np.asarray,
                        jppo._init_policy(jax.random.PRNGKey(seed), 4, 2, 32))


@pytest.fixture(scope="module")
def jax_runs():
    ray_tpu.init(num_cpus=8)
    try:
        return {"impala": _impala_parity(jrl), "ppo": _ppo_parity(jrl)}
    finally:
        ray_tpu.shutdown()


@pytest.fixture(scope="module")
def cluster(jax_runs):
    ctx = ray_tpu_torch.init(num_cpus=8)
    yield ctx
    ray_tpu_torch.shutdown()


@pytest.fixture
def jax_init_params(monkeypatch):
    """The port's policy init returns the JAX package's, for the seed it
    is given (IMPALA and PPO both draw it from ``config.seed``)."""
    monkeypatch.setattr(
        tppo, "_init_policy",
        lambda gen, *a: rl_params_from_jax(_jax_init(PARITY_SEED),
                                           gen.device))


# ------------------------------------------------------ whole-run parity
def test_impala_loss_sequence_matches_jax(cluster, jax_runs,
                                          jax_init_params):
    got = _impala_parity(trl, device="cpu")
    np.testing.assert_allclose(got, jax_runs["impala"], rtol=1e-5)


def test_ppo_loss_sequence_matches_jax(cluster, jax_runs, jax_init_params):
    got = _ppo_parity(trl, device="cpu")
    for g, w in zip(got, jax_runs["ppo"]):
        assert g["num_env_steps_sampled"] == w["num_env_steps_sampled"]
        assert g["episode_return_mean"] == w["episode_return_mean"]
        np.testing.assert_allclose(g["total_loss"], w["total_loss"],
                                   rtol=1e-5)
        for k in ("policy_loss", "value_loss", "entropy"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=1e-6,
                                       err_msg=k)


# ------------------------------------------------ twins of test_rllib.py
def test_cartpole_dynamics():
    env = trl.CartPole(seed=1)
    obs = env.reset()
    assert obs.shape == (4,)
    total, done = 0.0, False
    while not done:
        obs, r, done, _ = env.step(1)  # constant push falls over quickly
        total += r
    assert 1 <= total < 200


def test_gae_simple():
    traj = {
        "rewards": np.array([1.0, 1.0], np.float32),
        "values": np.array([0.0, 0.0], np.float32),
        "dones": np.array([False, True]),
        "last_value": 5.0,  # ignored: terminal
    }
    adv, ret = _compute_gae(traj, gamma=1.0, lam=1.0)
    np.testing.assert_allclose(adv, [2.0, 1.0])
    np.testing.assert_allclose(ret, [2.0, 1.0])


def test_ppo_trains_and_updates(cluster):
    cfg = trl.PPOConfig(num_env_runners=2, rollout_steps=128,
                        num_sgd_epochs=2, minibatch_size=64, seed=3,
                        device="cpu")
    algo = cfg.build()
    p0 = algo.learner.get_params()
    m1 = algo.train()
    assert m1["training_iteration"] == 1
    assert m1["num_env_steps_sampled"] == 256
    assert np.isfinite(m1["total_loss"])
    p1 = algo.learner.get_params()
    assert np.abs(p1["wp"] - p0["wp"]).sum() > 0  # parameters moved
    m2 = algo.train()
    assert m2["training_iteration"] == 2
    assert m2["episode_return_mean"] is not None
    algo.stop()


def test_ppo_improves_cartpole(cluster):
    cfg = trl.PPOConfig(num_env_runners=2, rollout_steps=512,
                        num_sgd_epochs=4, minibatch_size=128, lr=5e-3,
                        seed=0, device="cpu")
    algo = cfg.build()
    first = last = None
    for _ in range(6):
        m = algo.train()
        if m["episode_return_mean"] is not None:
            if first is None:
                first = m["episode_return_mean"]
            last = m["episode_return_mean"]
    algo.stop()
    assert first is not None and last is not None
    assert last > first  # learning signal: mean episode return improves


def test_runner_failure_replaced(cluster):
    cfg = trl.PPOConfig(num_env_runners=2, rollout_steps=64,
                        num_sgd_epochs=1, device="cpu")
    algo = cfg.build()
    algo.train()
    ray_tpu_torch.kill(algo.runners[0])  # the next train() replaces it
    algo.train()
    m = algo.train()
    assert m["num_env_steps_sampled"] >= 64
    algo.stop()


# ------------------------------------------ twins of test_rllib_algos.py
def _batch(n, base=0):
    return {
        "obs": np.arange(base, base + n, dtype=np.float32)[:, None],
        "actions": np.zeros(n, np.int64),
    }


def test_ring_overwrite():
    buf = trl.ReplayBuffer(capacity=10)
    buf.add_batch(_batch(15))
    assert len(buf) == 10
    assert buf.sample(32)["obs"].min() >= 5  # the oldest 5 overwritten


def test_prioritized_weights_and_updates():
    buf = trl.PrioritizedReplayBuffer(capacity=100, seed=1)
    buf.add_batch(_batch(50))
    s = buf.sample(16)
    assert "_weights" in s and "_indices" in s
    assert s["_weights"].max() <= 1.0 + 1e-6
    buf.update_priorities(s["_indices"], np.full(16, 10.0))
    s2 = buf.sample(64)  # high-priority items now dominate sampling
    assert np.isin(s2["_indices"], s["_indices"]).mean() > 0.5


def test_actor_manager_foreach_and_replacement(cluster):
    @ray_tpu_torch.remote
    class W:
        def __init__(self, idx):
            self.idx = idx

        def who(self):
            return self.idx

        def die(self):
            import os

            os._exit(1)

    mgr = trl.FaultTolerantActorManager(lambda i: W.remote(i), 3)
    assert dict(mgr.foreach("who", timeout=60)) == {0: 0, 1: 1, 2: 2}
    mgr.foreach("die", timeout=30)  # all die; all replaced
    assert mgr.num_replacements == 3
    assert dict(mgr.foreach("who", timeout=60)) == {0: 0, 1: 1, 2: 2}
    mgr.kill_all()


def _dqn(**training):
    return (trl.DQNConfig().env_runners(2, rollout_steps=64)
            .training(device="cpu", **training))


def test_dqn_trains(cluster):
    algo = _dqn(min_buffer_size=64, num_learn_steps=8,
                target_update_freq=2).debugging(seed=5).build()
    p0 = {k: v.clone() for k, v in algo.params.items()}
    for _ in range(3):
        result = algo.train()
    assert result["buffer_size"] > 0
    assert result["loss"] is not None and np.isfinite(result["loss"])
    assert all(str(v.device) == "cpu" for v in algo.params.values())
    moved = sum(float((p0[k] - algo.params[k]).abs().sum()) for k in p0)
    assert moved > 0
    algo.stop()


def test_dqn_prioritized_and_checkpoint(cluster, tmp_path):
    def build():
        return (trl.DQNConfig().env_runners(1, rollout_steps=64)
                .training(min_buffer_size=32, num_learn_steps=4,
                          prioritized=True, device="cpu").build())

    algo = build()
    algo.train()
    algo.train()
    path = algo.save(str(tmp_path))
    it = algo.iteration
    algo2 = build()
    algo2.restore(path)
    assert algo2.iteration == it
    np.testing.assert_allclose(algo2.params["w0"].numpy(),
                               algo.params["w0"].numpy())
    algo.stop()
    algo2.stop()


def test_impala_trains(cluster):
    algo = (trl.IMPALAConfig().env_runners(2, rollout_steps=64)
            .training(batches_per_step=3, device="cpu").build())
    result = algo.train()
    assert result["num_env_steps_sampled"] == 3 * 64
    assert np.isfinite(result["loss"])
    assert algo.train()["training_iteration"] == 2
    algo.stop()


def test_appo_clip_variant(cluster):
    algo = (trl.APPOConfig().env_runners(1, rollout_steps=64)
            .training(batches_per_step=2, device="cpu").build())
    assert algo.config.use_appo_clip
    assert np.isfinite(algo.train()["loss"])
    algo.stop()


def _expert_data(n=512):
    # Simple rule: action = 1 iff obs[0] > 0 — learnable by BC.
    rng = np.random.default_rng(0)
    obs = rng.normal(size=(n, 4)).astype(np.float32)
    return {"obs": obs, "actions": (obs[:, 0] > 0).astype(np.int64)}


def test_bc_learns_rule(cluster):
    data = _expert_data()
    algo = (trl.BCConfig().offline(data)
            .training(num_sgd_steps=64, lr=5e-2, device="cpu").build())
    for _ in range(4):
        result = algo.train()
    assert result["loss"] < 0.3
    correct = sum(algo.compute_action(data["obs"][i]) == data["actions"][i]
                  for i in range(100))
    assert correct >= 90


def test_bc_from_ray_data(cluster):
    import ray_tpu_torch.data as rdata

    raw = _expert_data(128)
    rows = [{"obs": raw["obs"][i], "actions": int(raw["actions"][i])}
            for i in range(128)]
    ds = rdata.from_items(rows, parallelism=4)
    algo = (trl.BCConfig().offline(ds)
            .training(num_sgd_steps=8, device="cpu").build())
    assert np.isfinite(algo.train()["loss"])


def test_marwil_beta_weighting(cluster):
    data = _expert_data(256)
    data["advantages"] = np.ones(256, np.float32)
    algo = (trl.MARWILConfig().offline(data)
            .training(num_sgd_steps=8, device="cpu").build())
    assert algo.config.beta == 1.0
    assert np.isfinite(algo.train()["loss"])


# --------------------------- twin of the BC Tuner (test_tune_schedulers)
def test_class_trainable_algorithm(cluster):
    import ray_tpu_torch.tune as tune

    rng = np.random.default_rng(0)
    data = {
        "obs": rng.normal(size=(64, 4)).astype(np.float32),
        "actions": (rng.random(64) > 0.5).astype(np.int64),
    }

    def trainable(config):
        import ray_tpu_torch.train as train
        from ray_tpu_torch.rllib import BCConfig

        algo = (BCConfig().offline(data)
                .training(device="cpu", **config).build())
        for _ in range(3):
            train.report(algo.train())

    grid = tune.Tuner(
        trainable,
        param_space={"lr": tune.grid_search([1e-3, 1e-2])},
        tune_config=tune.TuneConfig(metric="loss", mode="min"),
    ).fit()
    assert len(grid.results) == 2
    assert grid.get_best_result().metrics["loss"] > 0

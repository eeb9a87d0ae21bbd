"""Offline RL in the port, on the CPU.

Twins of ``tests/test_rllib_offline_cql.py``: ``OfflineData`` over a
dataset stream, a dict and a parquet round trip; CQL and IQL learn
Pendulum from a logged behaviour dataset, held to the JAX tests' seeded
thresholds; CQL's state round trip.  Every learner is on ``device="cpu"``
in one port cluster.  SAC and multi-agent learning are in
``test_torch_rllib_sac.py``.
"""

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.rllib import (
    CQLConfig,
    IQLConfig,
    OfflineData,
    Pendulum,
    record_transitions,
)
from torch_rllib_common import one_intra_op_thread  # noqa: F401


@pytest.fixture(scope="module")
def cluster():
    ctx = ray_tpu_torch.init(num_cpus=4)
    yield ctx
    ray_tpu_torch.shutdown()


def _behavior_policy(obs, rng):
    """Noisy energy-shaping swing-up + PD catch, NORMALIZED to [-1, 1]
    (the module's tanh range), the JAX tests' own behaviour policy:
    medium quality, with 30% uniform exploration for off-policy action
    coverage."""
    cos_th, sin_th, thdot = float(obs[0]), float(obs[1]), float(obs[2])
    if rng.random() < 0.3:
        return np.array([rng.uniform(-1.0, 1.0)], np.float32)
    energy = thdot ** 2 / 6.0 + 5.0 * cos_th  # E_top = 5 at rest upright
    if cos_th > 0.85 and abs(thdot) < 4.0:
        u = -(5.0 * sin_th + 1.0 * thdot)  # stabilize near the top
    else:  # pump energy with the swing direction
        u = (
            2.0 * np.sign(thdot) * np.sign(5.0 - energy)
            if abs(thdot) > 1e-3
            else 2.0
        )
    return np.array([np.clip(u, -2.0, 2.0) / 2.0], np.float32)


def _rollout_return(policy, episodes=4, seed=500):
    returns = []
    for ep in range(episodes):
        env = Pendulum(seed=seed + ep)
        rng = np.random.default_rng(seed + ep)
        obs = env.reset()
        total, done = 0.0, False
        while not done:
            a = policy(obs, rng)
            obs, r, done, _ = env.step(np.asarray(a) * 2.0)  # scale to env
            total += r
        returns.append(total)
    return float(np.mean(returns))


@pytest.fixture(scope="module")
def offline_dataset(cluster):
    return record_transitions(
        Pendulum, _behavior_policy, n_steps=8_000, seed=3
    )


def _dataset_episode_returns(ds) -> np.ndarray:
    rewards, dones = [], []
    for batch in ds.iter_batches(batch_size=4096, batch_format="numpy"):
        rewards.append(np.asarray(batch["rewards"], np.float64))
        dones.append(np.asarray(batch["dones"], bool))
    r, d = np.concatenate(rewards), np.concatenate(dones)
    returns, total = [], 0.0
    for rew, done in zip(r, d):
        total += float(rew)
        if done:
            returns.append(total)
            total = 0.0
    return np.asarray(returns)


class TestOfflineData:
    def test_sample_from_dataset_stream(self, offline_dataset):
        data = OfflineData(offline_dataset, seed=0)
        batch = data.sample(128)
        assert set(batch) == {"obs", "actions", "rewards", "next_obs",
                              "dones"}
        assert batch["obs"].shape == (128, 3)
        assert batch["actions"].shape == (128, 1)
        assert np.abs(batch["actions"]).max() <= 1.0
        b2 = data.sample(128)  # shuffled reads, not a fixed window
        assert not np.array_equal(batch["obs"], b2["obs"])

    def test_sample_from_dict(self):
        data = OfflineData({
            "obs": np.zeros((50, 3), np.float32),
            "actions": np.zeros((50, 1), np.float32),
            "rewards": np.zeros(50, np.float32),
            "next_obs": np.zeros((50, 3), np.float32),
            "dones": np.zeros(50, bool),
        })
        assert data.sample(16)["obs"].shape == (16, 3)
        assert data.num_rows() == 50

    def test_parquet_roundtrip(self, offline_dataset, tmp_path):
        path = str(tmp_path / "transitions")
        offline_dataset.write_parquet(path)
        batch = OfflineData(path, seed=1).sample(64)
        assert batch["obs"].shape == (64, 3)


class TestCQL:
    def test_cql_learns_pendulum_from_offline_data(self, offline_dataset):
        algo = (
            CQLConfig()
            .offline(offline_dataset)
            .environment(Pendulum)
            .training(
                batch_size=256, learn_steps_per_iter=500, hidden=64,
                cql_alpha=0.5, cql_n_actions=8, seed=0, device="cpu",
            )
            .build()
        )
        random_baseline = _rollout_return(
            lambda obs, rng: rng.uniform(-1.0, 1.0, size=1)
        )
        behavior_return = float(np.mean(_dataset_episode_returns(
            offline_dataset
        )))
        assert behavior_return > random_baseline, (
            behavior_return, random_baseline)
        # The JAX test's seeded threshold: close >= 20% of the gap
        # between the random baseline and the logged behaviour policy.
        threshold = random_baseline + 0.2 * (
            behavior_return - random_baseline
        )
        best, stats = -np.inf, {}
        for _ in range(8):
            stats = algo.training_step()
            best = max(
                best, algo.evaluate(episodes=6)["episode_return_mean"]
            )
            if best > threshold:
                break
        assert np.isfinite(stats["critic_loss"])
        assert np.isfinite(stats["cql_penalty"])
        assert best > threshold, (
            best, threshold, random_baseline, behavior_return,
        )

    def test_cql_state_roundtrip(self, offline_dataset):
        def build():
            return (
                CQLConfig()
                .offline(offline_dataset)
                .environment(Pendulum)
                .training(learn_steps_per_iter=5, batch_size=64, hidden=16,
                          device="cpu")
                .build()
            )

        algo = build()
        algo.training_step()
        state = algo.get_state()
        assert isinstance(state["log_alpha"], np.ndarray)
        algo2 = build()
        algo2.set_state(state)
        r1 = algo.evaluate(episodes=2)["episode_return_mean"]
        r2 = algo2.evaluate(episodes=2)["episode_return_mean"]
        assert r1 == pytest.approx(r2)


class TestIQL:
    def test_iql_learns_pendulum_from_offline_data(self, offline_dataset):
        algo = (
            IQLConfig()
            .offline(offline_dataset)
            .environment(Pendulum)
            .training(
                batch_size=256, learn_steps_per_iter=500, hidden=64,
                expectile=0.7, beta=3.0, seed=0, device="cpu",
            )
            .build()
        )
        random_baseline = _rollout_return(
            lambda obs, rng: rng.uniform(-1.0, 1.0, size=1)
        )
        best = -np.inf
        for _ in range(6):
            stats = algo.training_step()
            best = max(
                best, algo.evaluate(episodes=2)["episode_return_mean"]
            )
        assert np.isfinite(stats["q_loss"]) and np.isfinite(stats["pi_loss"])
        assert best > random_baseline + 250, (best, random_baseline)

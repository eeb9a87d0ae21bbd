"""SAC and multi-agent learning in the port, on the CPU.

Twins of ``TestSAC`` in ``tests/test_rllib_rlmodule_sac.py`` (SAC improves
on Pendulum by the JAX test's margin, its checkpoint round trip) and of
``tests/test_rllib_multi_agent.py``, every learner on ``device="cpu"``;
SAC's runners sample on the CPU in a port cluster.
"""

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.rllib import (
    ALL_DONE,
    IndependentTrainer,
    Pendulum,
    SACConfig,
    TwoAgentCoopEnv,
)
from torch_rllib_common import one_intra_op_thread  # noqa: F401


@pytest.fixture(scope="module")
def cluster():
    ctx = ray_tpu_torch.init(num_cpus=4)
    yield ctx
    ray_tpu_torch.shutdown()


class TestSAC:
    def test_sac_improves_on_pendulum(self, cluster):
        algo = (
            SACConfig()
            .environment(Pendulum)
            .training(
                rollout_steps=400, learn_steps_per_iter=100,
                warmup_steps=600, batch_size=128, hidden=64, seed=0,
                device="cpu",
            )
            .build()
        )
        try:
            returns = []
            for _ in range(20):
                result = algo.train()
                if not np.isnan(result["episode_return_mean"]):
                    returns.append(result["episode_return_mean"])
            assert len(returns) >= 6
            first = float(np.mean(returns[:3]))
            last = float(np.mean(returns[-3:]))
            # The JAX test's margin over the first returns.
            assert last > first + 250, (first, last)
        finally:
            algo.stop()

    def test_sac_state_roundtrip(self, cluster, tmp_path):
        def build():
            return (
                SACConfig()
                .environment(Pendulum)
                .training(rollout_steps=50, warmup_steps=10,
                          learn_steps_per_iter=4, batch_size=32, hidden=16,
                          device="cpu")
                .build()
            )

        algo = build()
        try:
            algo.train()
            path = algo.save(str(tmp_path / "ck"))
            algo2 = build()
            try:
                algo2.restore(path)
                assert algo2._total_steps == algo._total_steps
                np.testing.assert_array_equal(
                    algo2.params["pi"]["w0"].numpy(),
                    algo.params["pi"]["w0"].numpy())
            finally:
                algo2.stop()
        finally:
            algo.stop()


# ------------------------------------------ twins of the multi-agent tests
class TestMultiAgent:
    def test_env_dict_protocol(self):
        env = TwoAgentCoopEnv(seed=0, max_steps=4)
        obs = env.reset()
        assert set(obs) == {"a0", "a1"}
        _, rewards, dones, _ = env.step({"a0": 0, "a1": 1})
        assert set(rewards) == {"a0", "a1"}
        assert ALL_DONE in dones

    def test_cooperative_reward(self):
        env = TwoAgentCoopEnv(seed=1, max_steps=8)
        env.reset()
        t = dict(env._targets)
        _, rewards, _, _ = env.step({a: t[a] for a in env.agents})
        assert rewards["a0"] == 1.0 and rewards["a1"] == 1.0
        t = dict(env._targets)
        _, rewards, _, _ = env.step({"a0": t["a0"], "a1": 1 - t["a1"]})
        assert rewards["a0"] == 0.0  # cooperative: one miss zeroes both

    def test_independent_policies_learn_coordination(self):
        trainer = IndependentTrainer(
            lambda: TwoAgentCoopEnv(seed=0, max_steps=32), seed=0,
            device="cpu",
        )
        first = trainer.train(episodes_per_iter=8)["episode_reward_mean"]
        last = first
        for _ in range(25):
            last = trainer.train(episodes_per_iter=8)["episode_reward_mean"]
        # A random joint policy matches both targets 25% of the time.
        assert last > first + 15, (first, last)

    def test_shared_policy_mapping(self):
        trainer = IndependentTrainer(
            lambda: TwoAgentCoopEnv(seed=0, max_steps=16),
            policy_mapping_fn=lambda agent: "shared",
            seed=0, device="cpu",
        )
        assert set(trainer.params.keys()) == {"shared"}
        out = trainer.train(episodes_per_iter=4)
        assert "shared" in out["policy_losses"]
        assert np.isfinite(out["policy_losses"]["shared"])

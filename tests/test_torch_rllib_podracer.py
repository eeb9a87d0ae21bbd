"""The Podracer trainers of the port, on the CPU.

Twins of ``tests/test_rllib_podracer.py``: Anakin with ``device="cpu"``
(``num_devices=2`` is two CPU replicas, each with its own envs and
generator, their gradients averaged), Sebulba with its learner on the CPU
and its runners' forwards on ``runner_device="cpu"`` (or the numpy host
path), the IMPALA runner-death and restart-budget tests, the placement
bundles in a cluster declaring ``resources={"GPU": 2}`` by hand (they ask
for ``GPU``), the mailbox and broadcast, and the ``bench_rl --quick``
smoke.  Against the JAX package: Sebulba's loss sequence at staleness 0
(sync, one runner, host inference, from the JAX package's initial params)
and ``bench_rl --quick``'s rows key for key, both run in a JAX cluster
that is shut down before the port's starts.  With ``device=None`` and no
card, ``Anakin``, ``TorchLearner`` and a ``"device"`` runner raise.
"""

import jax
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu.rllib.ppo as jppo
import ray_tpu_torch
import ray_tpu_torch.rllib.ppo as tppo
from ray_tpu_torch.convert import rl_params_from_jax
from ray_tpu_torch.rllib import CartPole, IMPALAConfig
from ray_tpu_torch.rllib.podracer import (
    AnakinConfig,
    SebulbaConfig,
    evaluate_policy_numpy,
)
from torch_rllib_common import one_intra_op_thread  # noqa: F401


def _seeded_threshold(random_baseline: float, ceiling: float = 200.0,
                      close: float = 0.2) -> float:
    """The pass bar is derived from the SEEDED random baseline (close >=
    ``close`` of the gap to the env ceiling), as the JAX tests do."""
    assert random_baseline < ceiling
    return random_baseline + close * (ceiling - random_baseline)


def _sync_sebulba_config(cls, seed: int):
    cfg = cls()
    cfg.num_env_runners = 1
    cfg.envs_per_runner = 1
    cfg.rollout_steps = 64
    cfg.batches_per_step = 3
    cfg.inference = "host"  # EnvRunner-identical numpy sampling path
    cfg.pipeline_sampling = False  # staleness 0 by construction
    cfg.seed = seed
    return cfg


def _port_sync_sebulba(seed: int):
    cfg = _sync_sebulba_config(SebulbaConfig, seed)
    cfg.device = "cpu"
    return cfg


def _sebulba_losses(cfg, n=2):
    algo = cfg.build()
    out = []
    try:
        for _ in range(n):
            r = algo.train()
            assert r["staleness_max"] == 0
            assert r["num_stale_trajs_dropped"] == 0
            out.append(r["loss"])
    finally:
        algo.stop()
    return out


@pytest.fixture(scope="module")
def jax_runs():
    from ray_tpu.rllib.podracer import SebulbaConfig as JaxSebulbaConfig
    from ray_tpu.rllib.podracer import bench_rl

    ray_tpu.init(num_cpus=8)
    try:
        return {
            "sebulba": _sebulba_losses(
                _sync_sebulba_config(JaxSebulbaConfig, 7)),
            "bench": (bench_rl.bench_anakin_scaling(quick=True)
                      + bench_rl.bench_anakin_vs_host_loop(quick=True)
                      + bench_rl.bench_sebulba(quick=True)),
        }
    finally:
        ray_tpu.shutdown()


@pytest.fixture(scope="module")
def cluster(jax_runs):
    ctx = ray_tpu_torch.init(num_cpus=8, resources={"GPU": 2})
    yield ctx
    ray_tpu_torch.shutdown()


def _anakin(envs, unroll, updates, devices, seed=0):
    cfg = AnakinConfig()
    cfg.num_envs_per_device = envs
    cfg.unroll_length = unroll
    cfg.updates_per_step = updates
    cfg.num_devices = devices
    cfg.device = "cpu"
    cfg.seed = seed
    return cfg


# ---------------------------------------------------------------- Anakin
class TestAnakin:
    def test_anakin_learns_cartpole(self):
        algo = _anakin(32, 16, 50, 2).build()
        assert len(algo.devices) == 2  # two CPU replicas
        base = algo.evaluate(num_envs=16, seed=3)
        threshold = _seeded_threshold(base)
        best = base
        for _ in range(6):
            result = algo.train()
            best = max(best, algo.evaluate(num_envs=16, seed=3))
            if best > threshold:
                break
        assert np.isfinite(result["loss"])
        assert best > threshold, (best, threshold, base)

    def test_anakin_step_accounting_and_devices(self):
        algo = _anakin(8, 4, 2, 2).build()
        r = algo.train()
        assert r["num_devices"] == 2
        assert r["num_env_steps_sampled"] == 2 * 8 * 4 * 2
        assert r["num_learner_updates"] == 2
        assert r["env_steps_per_s"] > 0
        assert all(np.isfinite(r[k]) for k in ("loss", "loss_mean",
                                                "reward_mean", "done_rate"))

    def test_anakin_state_roundtrip(self):
        algo = _anakin(8, 4, 2, 1).build()
        algo.train()
        state = algo.get_state()
        assert all(isinstance(v, np.ndarray) for v in state["params"].values())
        algo2 = _anakin(8, 4, 2, 1).build()
        algo2.set_state(state)
        for k, v in state["params"].items():
            np.testing.assert_array_equal(algo2.get_state()["params"][k], v)

    def test_anakin_resize_carries_params(self):
        algo = _anakin(8, 4, 2, 1).build()
        algo.train()
        before = algo.get_state()["params"]
        out = algo.resize(2)
        assert out == {"num_devices": 2, "previous": 1}
        for k, v in before.items():
            np.testing.assert_array_equal(algo.get_state()["params"][k], v)
        r = algo.train()
        assert r["num_devices"] == 2 and algo.total_updates == 4

    def test_replicas_average_their_gradients(self):
        """Each replica rolls out its own envs; the mean of two replicas'
        losses, each over E envs, has the gradient of one loss over their
        2E trajectories (``pmean`` of the replicas' gradients)."""
        from ray_tpu_torch.rllib.algorithm import value_and_grad
        from ray_tpu_torch.rllib.impala import make_vtrace_loss

        algo = _anakin(4, 3, 1, 2).build()
        with torch.no_grad():
            batches = [algo._rollout(r, algo.params) for r in range(2)]
        loss_fn = make_vtrace_loss(gamma=0.99)
        both = {k: torch.cat([b[k] for b in batches]) for k in batches[0]}
        _, _, g_all = value_and_grad(loss_fn, algo.params, both)

        def mean_of_two(p, bs):
            return (loss_fn(p, bs[0])[0] + loss_fn(p, bs[1])[0]) / 2, None

        _, _, g_pm = value_and_grad(mean_of_two, algo.params, batches)
        for k in g_all:
            torch.testing.assert_close(g_pm[k], g_all[k], rtol=1e-5,
                                       atol=1e-6)

    def test_anakin_jobs_share_chips_via_placement(self, cluster):
        """Two Anakin jobs pinned to actor-role GPU bundles of ONE
        placement group train concurrently — the chip-sharing
        composition (the GPUs are declared; the trainers run on the
        CPU)."""
        from ray_tpu_torch.core.placement import podracer_placement_group
        from ray_tpu_torch.rllib.podracer.anakin import anakin_actor

        placement = podracer_placement_group(
            num_actor_bundles=2, num_learner_bundles=0, chips_per_actor=1
        )
        assert placement.pg.bundle_specs() == [{"CPU": 1.0, "GPU": 1.0}] * 2
        assert placement.ready(timeout=60)
        jobs = [anakin_actor(_anakin(4, 4, 2, 1, seed=i),
                             scheduling_strategy=placement.actor_strategy(i))
                for i in range(2)]
        results = ray_tpu_torch.get([j.train.remote() for j in jobs],
                                    timeout=180)
        assert all(np.isfinite(r["loss"]) for r in results)
        assert all(r["num_env_steps_sampled"] == 4 * 4 * 2 for r in results)
        for j in jobs:
            ray_tpu_torch.kill(j)
        placement.remove()


# --------------------------------------------------------------- Sebulba
class TestSebulba:
    def test_loss_parity_with_impala_at_staleness_0(self, cluster):
        """Sync Sebulba (1 runner x 1 env, host inference) IS IMPALA:
        same seeds, same sampler math, shared v-trace loss — the loss
        sequences must match."""
        s_losses = _sebulba_losses(_port_sync_sebulba(7))
        im = (IMPALAConfig().env_runners(1, rollout_steps=64)
              .training(batches_per_step=3, device="cpu"))
        im.seed = 7
        impala = im.build()
        i_losses = [impala.train()["loss"] for _ in range(2)]
        impala.stop()
        np.testing.assert_allclose(s_losses, i_losses, rtol=1e-5)

    def test_loss_sequence_matches_jax_sebulba(self, cluster, jax_runs,
                                               monkeypatch):
        jparams = jax.tree.map(np.asarray, jppo._init_policy(
            jax.random.PRNGKey(7), 4, 2, 32))
        monkeypatch.setattr(tppo, "_init_policy",
                            lambda gen, *a: rl_params_from_jax(jparams,
                                                               gen.device))
        got = _sebulba_losses(_port_sync_sebulba(7))
        np.testing.assert_allclose(got, jax_runs["sebulba"], rtol=1e-5)

    def test_staleness_bound_enforced(self, cluster):
        algo = _port_sync_sebulba(3).build()
        try:
            algo.train()  # params now ahead of version 0
            T, B = 4, 1
            traj = {
                "obs": np.zeros((T, B, 4), np.float32),
                "actions": np.zeros((T, B), np.int32),
                "rewards": np.ones((T, B), np.float32),
                "dones": np.zeros((T, B), bool),
                "logp_old": np.full((T, B), -0.7, np.float32),
                "last_value": np.zeros(B, np.float32),
                "episode_returns": [],
                "params_version": 0,
                "env_steps": T * B,
            }
            stats = {"episode_returns": [], "env_steps": 0,
                     "staleness": [], "dropped": 0}
            # version is 3 after one train (3 updates); staleness 3 > 2.
            algo.config.max_staleness = 2
            assert algo._version == 3
            assert algo._consume_trajectory(dict(traj), stats) is None
            assert stats["dropped"] == 1
            traj["params_version"] = algo._version  # fresh enough
            loss = algo._consume_trajectory(dict(traj), stats)
            assert loss is not None and np.isfinite(float(loss))
            # Consumed-path staleness only.
            assert stats["staleness"] == [0]
        finally:
            algo.stop()

    def _learning_config(self, seed):
        cfg = SebulbaConfig()
        cfg.num_env_runners = 2
        cfg.envs_per_runner = 4
        cfg.rollout_steps = 64
        cfg.batches_per_step = 8
        cfg.seed = seed
        cfg.device = "cpu"
        cfg.runner_device = "cpu"  # "device" inference on the CPU
        return cfg

    def test_sebulba_learns_cartpole(self, cluster):
        algo = self._learning_config(0).build()
        try:
            info = ray_tpu_torch.get(
                [a.describe.remote() for a in algo.runner_group.actors],
                timeout=60)
            assert [i["forward_device"] for i in info] == ["cpu", "cpu"]
            maker = lambda: CartPole()  # noqa: E731
            base = evaluate_policy_numpy(
                algo._np_params(), maker, episodes=4, seed=5
            )
            threshold = _seeded_threshold(base)
            best = base
            for _ in range(20):
                result = algo.train()
                best = max(best, evaluate_policy_numpy(
                    algo._np_params(), maker, episodes=4, seed=5
                ))
                if best > threshold:
                    break
            assert np.isfinite(result["loss"])
            assert best > threshold, (best, threshold, base)
            assert result["staleness_max"] <= algo.config.max_staleness
        finally:
            algo.stop()

    def test_set_state_version_monotonic(self, cluster):
        algo = _port_sync_sebulba(11).build()
        try:
            ckpt = algo.get_state()  # version 0
            algo.train()  # version 3
            v_live = algo._version
            algo.set_state(ckpt)
            assert algo._version == v_live + 1
            held = [
                ray_tpu_torch.get(
                    a.set_params.remote(algo._np_params(), 0), timeout=60
                )
                for a in algo.runner_group.actors
            ]
            assert held == [algo._version] * len(held)
            r = algo.train()  # staleness stays non-negative post-restore
            assert r["staleness_mean"] >= 0.0
            assert np.isfinite(r["loss"])
        finally:
            algo.stop()

    def test_actor_death_recovery_converges(self, cluster):
        algo = self._learning_config(1).build()
        try:
            maker = lambda: CartPole()  # noqa: E731
            base = evaluate_policy_numpy(
                algo._np_params(), maker, episodes=4, seed=9
            )
            threshold = _seeded_threshold(base)
            algo.train()
            ray_tpu_torch.kill(algo.runner_group.actors[0])
            restarts = 0
            best = base
            for _ in range(20):
                result = algo.train()
                restarts += result["num_runner_restarts"]
                best = max(best, evaluate_policy_numpy(
                    algo._np_params(), maker, episodes=4, seed=9
                ))
                if best > threshold and restarts >= 1:
                    break
            assert restarts >= 1
            assert best > threshold, (best, threshold, base)
        finally:
            algo.stop()


# ----------------------------------------------- IMPALA kill regression
class TestImpalaRunnerDeath:
    def test_injected_kill_is_surfaced_not_stalled(self, cluster):
        algo = (IMPALAConfig().env_runners(2, rollout_steps=32)
                .training(batches_per_step=4, device="cpu").build())
        try:
            import time

            r = algo.train()
            assert r["num_runner_restarts"] == 0
            ray_tpu_torch.kill(algo.runner_group.actors[1])
            time.sleep(0.5)
            restarts = 0
            for _ in range(12):
                r = algo.train()
                assert np.isfinite(r["loss"])
                restarts += r["num_runner_restarts"]
                if restarts:
                    break
                time.sleep(0.25)
            assert restarts >= 1
        finally:
            algo.stop()

    def test_restart_budget_bounds_respawns(self, cluster):
        from ray_tpu_torch.rllib.actor_manager import FaultTolerantActorManager

        @ray_tpu_torch.remote
        class Crasher:
            def sample(self):
                import os

                os._exit(1)

        mgr = FaultTolerantActorManager(
            lambda i: Crasher.remote(), 1, max_restarts=2,
            on_respawn=lambda i, a: mgr.submit(i, "sample"),
            name="crash_test",
        )
        mgr.submit(0, "sample")
        with pytest.raises(RuntimeError, match="restart budget"):
            for _ in range(10):
                mgr.wait_any(timeout=60)
        assert mgr.num_replacements == 2
        mgr.kill_all()

    def test_restart_window_resets_budget(self):
        from ray_tpu_torch.rllib.actor_manager import FaultTolerantActorManager

        mgr = FaultTolerantActorManager(
            lambda i: object(), 1, max_restarts=1, name="window_test"
        )
        mgr._replace(0, RuntimeError("death 1"))  # 1/1 this window
        with pytest.raises(RuntimeError, match="restart budget"):
            mgr._replace(0, RuntimeError("death 2"))
        mgr.new_restart_window()
        mgr._replace(0, RuntimeError("death 3"))  # absorbed again
        assert mgr.num_replacements == 2


# ------------------------------------------------------------- placement
class TestPodracerPlacement:
    def test_device_role_bundles(self, cluster):
        from ray_tpu_torch.core.placement import PodracerPlacement

        placement = PodracerPlacement(
            num_actor_bundles=2, num_learner_bundles=1, chips_per_actor=0.5,
            chips_per_learner=1,
        )
        assert placement.pg.bundle_specs() == [
            {"CPU": 1.0, "GPU": 0.5}, {"CPU": 1.0, "GPU": 0.5},
            {"CPU": 1.0, "GPU": 1.0}]
        assert placement.ready(timeout=60)
        assert placement.pg.bundle_count == 3
        assert placement.actor_strategy(1).bundle_index == 1
        assert placement.learner_strategy(0).bundle_index == 2
        with pytest.raises(IndexError):
            placement.actor_strategy(2)
        with pytest.raises(IndexError):
            placement.learner_strategy(1)
        placement.remove()

    def test_role_resources_and_validation(self):
        from ray_tpu_torch.core.placement import PodracerPlacement

        with pytest.raises(ValueError):
            PodracerPlacement(num_actor_bundles=0)


# ---------------------------------------------------------- p2p broadcast
class TestBroadcastFanOut:
    def test_mailbox_try_take_latest(self):
        from ray_tpu_torch.collective.p2p import Mailbox

        box = Mailbox()
        assert box.try_take_latest("edge") is None
        box.deposit("edge", 1, "v1")
        box.deposit("edge", 3, "v3")
        box.deposit("edge", 2, "v2")
        box.deposit("other", 9, "keep")
        assert box.try_take_latest("edge") == (3, "v3")
        assert box.try_take_latest("edge") is None
        assert len(box) == 1

    def test_broadcast_local_short_circuit(self):
        from ray_tpu_torch.collective.p2p import StageChannel, local_mailbox

        ch = StageChannel("bcast-test")
        nbytes = ch.broadcast(
            5, {"w": np.ones(4)},
            [("bcast-test:params->0", ""), ("bcast-test:params->1", "")],
        )
        assert nbytes == 0  # every destination local: nothing serialized
        for i in range(2):
            seq, value = local_mailbox().try_take_latest(
                f"bcast-test:params->{i}"
            )
            assert seq == 5
            np.testing.assert_array_equal(value["w"], np.ones(4))


# ------------------------------------------------------ no card, no run
def test_no_card_and_no_device_raises(cluster, monkeypatch):
    from ray_tpu_torch.core.serialization import dumps_function
    from ray_tpu_torch.rllib.podracer import SebulbaEnvRunner

    # A "device" runner with no card lease and no runner_device fails
    # when it is built (this worker sees no card).
    runner = SebulbaEnvRunner.remote(
        0, dumps_function(lambda: CartPole()), 1, 0,
        {"w1": np.zeros((4, 2), np.float32)}, 0, "device", "t")
    with pytest.raises(Exception, match="device='cpu'"):
        ray_tpu_torch.get(runner.describe.remote(), timeout=60)
    ray_tpu_torch.kill(runner)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AnakinConfig().build()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tppo.TorchLearner(tppo.PPOConfig(), 4, 2)


# ----------------------------------------------------------- bench smoke
class TestBenchRlQuick:
    def test_bench_rl_quick_smoke(self, cluster, jax_runs):
        """``bench_rl --quick --device cpu``: every stage runs, the
        Anakin-vs-host-loop ratio clears 1.0, and the rows carry the JAX
        bench's keys."""
        from ray_tpu_torch.rllib.podracer import bench_rl

        rows = bench_rl.bench_anakin_scaling(quick=True, device="cpu")
        assert any(
            r["metric"].startswith("rl_anakin_env_steps_per_s")
            and r["value"] > 0
            for r in rows
        )
        host = bench_rl.bench_anakin_vs_host_loop(quick=True, device="cpu")
        assert host[0]["metric"] == "rl_anakin_vs_host_loop"
        assert host[0]["ratio"] > 1.0, host[0]
        seb = bench_rl.bench_sebulba(quick=True, device="cpu")
        assert seb[0]["metric"] == "rl_sebulba_learner_steps_per_s"
        assert seb[0]["value"] > 0
        got = [(r["metric"], sorted(r)) for r in rows + host + seb]
        want = [(r["metric"], sorted(r)) for r in jax_runs["bench"]]
        assert got == want

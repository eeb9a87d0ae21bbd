"""Sebulba — host-side envs feeding split actor/learner device pipelines.

Podracer (arxiv 2104.06272) §3: when the environment can't be jitted
(simulators, games, anything Python), keep envs on HOST actors but make
every policy decision a *batched* device computation: each env-runner
actor steps a batch of envs and runs one batched forward per timestep on
its local "actor" device (the card share it leased); finished unrolls
stream to the learner, which applies IMPALA's V-trace loss
(``rllib.impala.make_vtrace_loss`` over the trajectory batch) on the
learner's device (``resolve_device(config.device)``) and broadcasts fresh
parameters back, as numpy, over the ``collective.p2p.StageChannel``
zero-copy path — serialized once, fanned out to every runner, adopted at
the next unroll boundary.

Staleness is bounded, not hidden: every trajectory carries the parameter
version that produced it; the learner corrects up to
``max_staleness`` versions with the V-trace rho/c clipping and DROPS
anything older (counted, surfaced in the result dict).  Runner death is
harvested by the ``FaultTolerantActorManager`` — killed, respawned with
current params into the same slot (bounded restarts), resubmitted — the
learner's wait never stalls on a corpse.

Placement: ``SebulbaConfig.use_placement`` reserves device-role bundles
(``core.placement.podracer_placement_group``, ``chips_per_actor`` =
``num_gpus_per_env_runner``) — runner actors pin to "actor" bundles,
keeping the learner's cards and the inference cards disjoint, and letting
several RL jobs (or RL next to serving) share one cluster under the
normal placement-group arbitration.
"""

from __future__ import annotations

import logging
import os
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.core.serialization import dumps_function

from ..algorithm import Algorithm, AlgorithmConfig
from ..actor_manager import FaultTolerantActorManager
from ..impala import make_vtrace_loss

logger = logging.getLogger(__name__)


def evaluate_policy_numpy(params, env_maker, episodes: int = 6,
                          seed: int = 0, greedy: bool = True) -> float:
    """Mean episode return of ``params`` over fresh env copies (host
    rollout, no cluster) — the seeded eval both learning tests and the
    bench use."""
    from ..ppo import _np_policy_forward

    returns: List[float] = []
    rng = np.random.default_rng(seed)
    for ep in range(episodes):
        env = env_maker()
        env.rng = np.random.default_rng(seed * 997 + ep)
        obs = env.reset()
        done, total = False, 0.0
        while not done:
            logits, _ = _np_policy_forward(params, obs)
            if greedy:
                action = int(np.argmax(logits))
            else:
                z = logits - logits.max()
                probs = np.exp(z) / np.exp(z).sum()
                action = int(rng.choice(len(probs), p=probs))
            obs, r, done, _ = env.step(action)
            total += r
        returns.append(total)
    return float(np.mean(returns))


@ray_tpu_torch.remote
class SebulbaEnvRunner:
    """Host-side sampling actor stepping a BATCH of Python envs.

    Inference modes: ``"device"`` (default) runs one batched torch forward
    per timestep on ``resolve_device(runner_device)`` — with
    ``runner_device=None``, the card share this runner leased
    (``SebulbaConfig.num_gpus_per_env_runner``, or the placement's
    ``chips_per_actor``); a runner with no card and no ``runner_device``
    raises when it is built, it never runs on the CPU unasked.  (The JAX
    package's "device" is the process's default JAX device, whatever it
    is: the one place the port differs.)  ``"host"`` loops the numpy
    forward per env, bit-identical to ``ppo.EnvRunner`` at batch 1 (the
    IMPALA parity path).  Parameters arrive either by direct
    ``set_params`` call or by ``StageChannel`` broadcast into this
    process's mailbox, adopted at the next unroll boundary
    (``params_version`` tags every trajectory so the learner can bound
    staleness).
    """

    def __init__(self, index: int, env_maker_payload: bytes, num_envs: int,
                 seed: int, params: Dict[str, np.ndarray], version: int,
                 inference: str = "device", channel_tag: str = "",
                 runner_device: Optional[str] = None):
        from ray_tpu_torch.core.serialization import loads_function

        maker = loads_function(env_maker_payload)
        self.index = index
        self.envs = [maker() for _ in range(num_envs)]
        # Decorrelate env reset streams (env 0 keeps the maker's own
        # seeding — the B=1 parity path must match EnvRunner exactly).
        for j, env in enumerate(self.envs[1:], start=1):
            if hasattr(env, "rng"):
                env.rng = np.random.default_rng((seed + 1) * 100003 + j)
        self.rng = np.random.default_rng(seed)
        self.obs = np.stack([env.reset() for env in self.envs])
        self.episode_return = np.zeros(num_envs, np.float64)
        self.completed_returns: List[float] = []
        self.inference = inference
        self._edge = f"{channel_tag}:params->{index}"
        self.device = None
        if inference == "device":
            from ray_tpu_torch.device import resolve_device

            self.device = resolve_device(runner_device)
        self._adopt(params, version)

    def _adopt(self, params, version) -> None:
        self.params = {k: np.asarray(v) for k, v in params.items()}
        self.version = int(version)
        if self.device is not None:
            from ..algorithm import to_tensors

            self._tparams = to_tensors(self.params, self.device)

    def describe(self) -> Dict[str, Any]:
        """Where this runner's forward runs: its inference mode, the
        device of its params and its ``CUDA_VISIBLE_DEVICES``."""
        return {
            "inference": self.inference,
            "forward_device": (str(self._tparams["w1"].device)
                               if self.device is not None else "numpy"),
            "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "pid": os.getpid(),
        }

    def address(self) -> str:
        from ray_tpu_torch.collective.p2p import StageChannel

        return StageChannel.self_address()

    def set_params(self, params: Dict[str, np.ndarray], version: int):
        if int(version) > self.version:
            self._adopt(params, version)
        return self.version

    def _poll_params(self) -> None:
        """Adopt the newest broadcast parameters, if any landed."""
        from ray_tpu_torch.collective.p2p import local_mailbox
        from ray_tpu_torch.core.serialization import SerializedPayload

        latest = local_mailbox().try_take_latest(self._edge)
        if latest is None:
            return
        _seq, value = latest
        if type(value) is SerializedPayload:
            value = value.deserialize()
        version, params = value
        if int(version) > self.version:
            self._adopt(params, version)

    def _forward_batch(self, obs):
        """(B, obs) -> (logits (B, A), values (B,)) on the runner's device
        (one batched inference request per timestep) or via the shared
        numpy forward (``ppo._np_policy_forward``)."""
        if self.device is not None:
            import torch

            from ..ppo import _policy_forward

            with torch.no_grad():
                x = torch.as_tensor(np.asarray(obs, np.float32),
                                    device=self.device)
                logits, values = _policy_forward(self._tparams, x)
            return logits.cpu().numpy(), values.cpu().numpy()
        from ..ppo import _np_policy_forward

        return _np_policy_forward(self.params, obs)

    def run_unroll(self, num_steps: int) -> Dict[str, Any]:
        """Sample ``num_steps`` transitions from every env; returns a
        time-major (T, B, ...) trajectory batch tagged with the params
        version that produced it."""
        self._poll_params()
        B = len(self.envs)
        obs_buf, act_buf, rew_buf, done_buf, logp_buf = [], [], [], [], []
        for _ in range(num_steps):
            logits, _values = self._forward_batch(self.obs)
            actions = np.zeros(B, np.int64)
            logps = np.zeros(B, np.float32)
            for j in range(B):
                z = logits[j] - logits[j].max()
                probs = np.exp(z) / np.exp(z).sum()
                actions[j] = int(self.rng.choice(len(probs), p=probs))
                logps[j] = float(np.log(probs[actions[j]] + 1e-12))
            obs_buf.append(self.obs.copy())
            act_buf.append(actions)
            logp_buf.append(logps)
            next_obs = np.empty_like(self.obs)
            rewards = np.zeros(B, np.float32)
            dones = np.zeros(B, bool)
            for j, env in enumerate(self.envs):
                o, r, d, _ = env.step(int(actions[j]))
                rewards[j], dones[j] = r, d
                self.episode_return[j] += r
                if d:
                    self.completed_returns.append(
                        float(self.episode_return[j])
                    )
                    self.episode_return[j] = 0.0
                    o = env.reset()
                next_obs[j] = o
            self.obs = next_obs
            rew_buf.append(rewards)
            done_buf.append(dones)
        _logits, last_values = self._forward_batch(self.obs)
        returns, self.completed_returns = self.completed_returns, []
        return {
            "obs": np.asarray(obs_buf, np.float32),
            "actions": np.asarray(act_buf, np.int32),
            "rewards": np.asarray(rew_buf, np.float32),
            "dones": np.asarray(done_buf, bool),
            "logp_old": np.asarray(logp_buf, np.float32),
            "last_value": np.asarray(last_values, np.float32),
            "episode_returns": returns,
            "params_version": self.version,
            "env_steps": num_steps * B,
        }


class SebulbaConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.num_env_runners = 2
        self.envs_per_runner = 4
        self.rollout_steps = 64
        self.batches_per_step = 4  # learner updates per train() call
        self.max_staleness = 4  # versions; older trajectories are dropped
        self.queue_capacity = 0  # 0 = 2 * num_env_runners
        self.inference = "device"  # "device" | "host"
        # False = sync: update -> flushed broadcast -> resubmit.  With
        # ONE runner that is staleness 0 by construction (the IMPALA-
        # parity configuration); more runners still carry their already-
        # in-flight unroll one version behind.
        self.pipeline_sampling = True
        self.use_placement = False
        self.max_restarts = -1  # -1 = 2 * num_env_runners + 4
        self.device = None  # the learner's device; None = the card
        # "device" inference: each runner's device (None = its card share,
        # leased below) and the share of a card each runner leases.
        self.runner_device = None
        self.num_gpus_per_env_runner = 0.0
        self.hidden = 32
        self.lr = 3e-3
        self.entropy_coeff = 0.01
        self.value_coeff = 0.5
        self.vtrace_clip_rho = 1.0
        self.vtrace_clip_c = 1.0


class Sebulba(Algorithm):
    def setup(self, config: SebulbaConfig) -> None:
        import torch

        from ray_tpu_torch.collective.p2p import StageChannel
        from ray_tpu_torch.device import resolve_device

        from ..algorithm import Adam, seeded_generator, value_and_grad
        from ..env import CartPole
        from ..ppo import _init_policy

        maker = config.env_maker or (lambda: CartPole())
        self._maker_payload = dumps_function(maker)
        probe = maker()
        self.obs_size = probe.observation_size
        self.num_actions = probe.num_actions

        self.device = resolve_device(config.device)
        self.params = _init_policy(
            seeded_generator(self.device, config.seed), self.obs_size,
            self.num_actions, config.hidden
        )
        self.tx = Adam(config.lr)
        self.opt_state = self.tx.init(self.params)
        tx = self.tx

        loss_fn = make_vtrace_loss(
            gamma=config.gamma,
            rho_bar=config.vtrace_clip_rho,
            c_bar=config.vtrace_clip_c,
            value_coeff=config.value_coeff,
            entropy_coeff=config.entropy_coeff,
        )

        def batched_update(params, opt_state, batch):
            """V-trace over a (B, T, ...) trajectory batch: the shared
            loss, averaged over the batch axis."""
            loss, _aux, grads = value_and_grad(loss_fn, params, batch)
            params, opt_state = tx.step(params, grads, opt_state)
            return params, opt_state, loss

        self._update = batched_update

        self._placement = None
        if config.use_placement:
            from ray_tpu_torch.core.placement import podracer_placement_group

            self._placement = podracer_placement_group(
                num_actor_bundles=config.num_env_runners,
                num_learner_bundles=1,
                chips_per_actor=config.num_gpus_per_env_runner,
                name="sebulba",
            )
            self._placement.ready(timeout=60)

        self._version = 0
        self._channel = StageChannel(
            f"sebulba-{os.getpid()}-{id(self):x}", recv_timeout_s=60.0
        )
        self._addresses: Dict[int, str] = {}
        self._queue: deque = deque()
        self._stale_dropped = 0

        max_restarts = config.max_restarts
        if max_restarts is not None and max_restarts < 0:
            max_restarts = 2 * config.num_env_runners + 4
        self.runner_group = FaultTolerantActorManager(
            self._make_runner,
            config.num_env_runners,
            max_restarts=max_restarts,
            on_respawn=self._on_respawn,
            name="sebulba",
        )
        for i in range(config.num_env_runners):
            self.runner_group.submit(
                i, "run_unroll", config.rollout_steps
            )

    # ------------------------------------------------------------- runners
    def _np_params(self):
        from ..algorithm import to_numpy

        return to_numpy(self.params)

    def _make_runner(self, i: int):
        cfg = self.config
        cls = SebulbaEnvRunner
        opts: Dict[str, Any] = {}
        if cfg.num_gpus_per_env_runner:
            opts["num_gpus"] = cfg.num_gpus_per_env_runner
        if self._placement is not None:
            opts["scheduling_strategy"] = self._placement.actor_strategy(i)
        if opts:
            cls = cls.options(**opts)
        actor = cls.remote(
            i, self._maker_payload, cfg.envs_per_runner, cfg.seed + i,
            self._np_params(), self._version, cfg.inference,
            self._channel.tag, cfg.runner_device,
        )
        try:
            self._addresses[i] = ray_tpu_torch.get(
                actor.address.remote(), timeout=60
            )
        except Exception:  # noqa: BLE001 — broadcast degrades to set_params
            logger.warning("runner %d address fetch failed; "
                           "broadcast will skip it", i)
            self._addresses.pop(i, None)
        return actor

    def _on_respawn(self, i: int, actor) -> None:
        """A replacement runner spawned with CURRENT params — just point
        it back at the sampling loop."""
        self.runner_group.submit(i, "run_unroll", self.config.rollout_steps)

    def _broadcast_params(self, flush: bool) -> None:
        """Serialize once, fan out to every runner's mailbox over the
        zero-copy push path; a dead destination is the manager's problem
        (detected at harvest), not the broadcast's.

        ``flush`` waits for every ack before returning (the sync-mode
        staleness guarantee needs params IN the mailbox before the
        runner is resubmitted).  Pipelined mode skips it — params are
        fresh immutable buffers each version, newest-wins adoption makes
        a late ack harmless, and blocking the learner hot path on every
        runner's ack per update would serialize learning on the slowest
        runner; the channel is drained once per training step instead."""
        from ray_tpu_torch.util import flight_recorder

        destinations = [
            (f"{self._channel.tag}:params->{i}", addr)
            for i, addr in sorted(self._addresses.items())
        ]
        if not destinations:
            return
        value = (self._version, self._np_params())
        try:
            nbytes = self._channel.broadcast(
                self._version, value, destinations, timeout=30.0
            )
            if flush:
                self._channel.flush(timeout=30.0)
            flight_recorder.record_rl_broadcast(nbytes, len(destinations))
        except Exception as e:  # noqa: BLE001 — dead runner mid-broadcast
            logger.warning("param broadcast v%d partially failed: %s",
                           self._version, e)

    # ------------------------------------------------------------- learner
    def _consume_trajectory(self, traj, stats: Dict[str, Any]):
        """Staleness gate + one batched v-trace update + broadcast.
        Returns the loss, or None if the trajectory was dropped."""
        from ray_tpu_torch.util import flight_recorder

        from ..impala import trajectory_batch

        cfg = self.config
        staleness = self._version - int(traj["params_version"])
        if staleness > cfg.max_staleness:
            self._stale_dropped += 1
            stats["dropped"] += 1
            flight_recorder.record_rl_stale_dropped("sebulba")
            return None
        # Consumed-path staleness only: the result dict's staleness_max
        # must agree with the recorder histogram (and with the bound —
        # dropped trajectories are accounted by the dropped counter).
        stats["staleness"].append(staleness)
        # Runner batches are time-major (T, B); the loss wants the batch
        # axis leading.
        batch = trajectory_batch(traj, self.device, time_major=True)
        self.params, self.opt_state, loss = self._update(
            self.params, self.opt_state, batch
        )
        self._version += 1
        flight_recorder.record_rl_update(
            "sebulba", staleness=staleness, queue_depth=len(self._queue)
        )
        self._broadcast_params(flush=not cfg.pipeline_sampling)
        stats["episode_returns"].extend(traj["episode_returns"])
        stats["env_steps"] += int(traj["env_steps"])
        return loss

    def training_step(self) -> Dict[str, Any]:
        import time as _time

        cfg = self.config
        capacity = cfg.queue_capacity or 2 * cfg.num_env_runners
        stats: Dict[str, Any] = {
            "episode_returns": [], "env_steps": 0, "staleness": [],
            "dropped": 0,
        }
        loss = None
        processed = 0
        restarts_before = self.runner_group.num_replacements
        self.runner_group.new_restart_window()
        t0 = _time.perf_counter()
        while processed < cfg.batches_per_step:
            i, traj = self.runner_group.wait_any(timeout=300)
            if cfg.pipeline_sampling:
                # Resubmit BEFORE the update: the runner samples the
                # next unroll (under current-or-soon params) while the
                # learner works — the Sebulba overlap.  Staleness is the
                # price; the gate below bounds it.
                self.runner_group.submit(i, "run_unroll", cfg.rollout_steps)
            self._queue.append(traj)
            while len(self._queue) > capacity:
                # Oldest-first shedding: over capacity the backlog can
                # only get staler.
                from ray_tpu_torch.util import flight_recorder

                self._queue.popleft()
                self._stale_dropped += 1
                stats["dropped"] += 1
                flight_recorder.record_rl_stale_dropped("sebulba")
            while self._queue and processed < cfg.batches_per_step:
                out = self._consume_trajectory(
                    self._queue.popleft(), stats
                )
                if out is not None:
                    loss = out
                    processed += 1
            if not cfg.pipeline_sampling:
                # Sync mode: the runner only resamples AFTER the fresh
                # params landed (flushed broadcast) — with a single
                # runner that is staleness 0 by construction, the
                # IMPALA-parity configuration (with more runners their
                # already-in-flight unrolls still arrive one version
                # behind).
                self.runner_group.submit(i, "run_unroll", cfg.rollout_steps)
        # Pipelined broadcasts were fire-and-forget; drain the acks once
        # per step so delivery errors still surface (as warnings).
        if cfg.pipeline_sampling:
            try:
                self._channel.flush(timeout=30.0)
            except Exception as e:  # noqa: BLE001 — dead runner's ack
                logger.warning("param broadcast ack drain: %s", e)
        dt = _time.perf_counter() - t0
        from ray_tpu_torch.util import flight_recorder

        flight_recorder.record_rl_rollout(
            "sebulba", stats["env_steps"], dt
        )
        flight_recorder.record_rl_learner_rate(
            "sebulba", processed / max(dt, 1e-9)
        )
        returns = stats["episode_returns"]
        staleness = stats["staleness"]
        return {
            "episode_return_mean": (
                float(np.mean(returns)) if returns else None
            ),
            "num_env_steps_sampled": stats["env_steps"],
            "loss": float(loss) if loss is not None else None,
            "num_learner_updates": processed,
            "learner_steps_per_s": processed / max(dt, 1e-9),
            "params_version": self._version,
            "staleness_mean": (
                float(np.mean(staleness)) if staleness else 0.0
            ),
            "staleness_max": int(max(staleness)) if staleness else 0,
            "num_stale_trajs_dropped": stats["dropped"],
            "num_runner_restarts": (
                self.runner_group.num_replacements - restarts_before
            ),
            "queue_depth": len(self._queue),
        }

    # ------------------------------------------------------------ lifecycle
    def get_state(self) -> Dict[str, Any]:
        return {"params": self._np_params(), "version": self._version}

    def set_state(self, state: Dict[str, Any]) -> None:
        from ..algorithm import to_tensors

        self.params = to_tensors(state["params"], self.device)
        self.opt_state = self.tx.init(self.params)
        # The version is MONOTONIC across restores: runners adopt only
        # newer versions, so restoring an old checkpoint must re-issue
        # the restored params under a version ABOVE anything a live
        # runner holds — otherwise every broadcast would be rejected and
        # the fleet would keep sampling the pre-restore policy (with
        # negative staleness sailing through the gate).
        self._version = max(
            self._version, int(state.get("version", 0))
        ) + 1
        np_params = self._np_params()
        for i, actor in enumerate(self.runner_group.actors):
            try:
                actor.set_params.remote(np_params, self._version)
            except Exception as e:  # noqa: BLE001 — dead runner: the
                # manager respawns it with current params at harvest.
                logger.warning("set_state push to runner %d failed: %s",
                               i, e)

    def cleanup(self) -> None:
        self.runner_group.kill_all()
        if self._placement is not None:
            try:
                self._placement.remove()
            except Exception:  # noqa: BLE001 — shutdown best-effort
                logger.info("podracer placement group removal failed "
                            "(cluster already down?)")


SebulbaConfig.ALGO_CLS = Sebulba

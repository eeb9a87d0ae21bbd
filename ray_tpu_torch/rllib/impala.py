"""IMPALA — asynchronous actor-learner with V-trace off-policy correction.

Reference: ray ``rllib/algorithms/impala/`` (decoupled sampling and
learning: EnvRunners produce trajectories under a stale behavior policy;
the learner corrects with V-trace importance weights).  APPO is this plus a
PPO-style clipped surrogate on the corrected advantages — exposed here via
``APPOConfig`` (``use_appo_clip``).

Async shape: each runner has one in-flight sample at all times; the learner
harvests whichever finishes first, updates, and resubmits that runner with
fresh params — sampling never barriers on the slowest runner.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.core.serialization import dumps_function

from .actor_manager import FaultTolerantActorManager
from .algorithm import Algorithm, AlgorithmConfig
from .ppo import EnvRunner  # same on-policy sampler (returns logp_old)

logger = logging.getLogger(__name__)


def make_vtrace_loss(
    *,
    gamma: float,
    rho_bar: float = 1.0,
    c_bar: float = 1.0,
    value_coeff: float = 0.5,
    entropy_coeff: float = 0.01,
    use_appo_clip: bool = False,
    appo_clip_eps: float = 0.2,
):
    """Time-major V-trace actor-critic loss over a batch of trajectories.

    This is THE loss for every actor-learner split in the package:
    IMPALA/APPO use it on one trajectory (N = 1), the podracer trainers
    on many — Sebulba over a trajectory batch (host rollouts under a
    stale behavior policy, rho/c clipping doing the off-policy
    correction), Anakin over the env axis on the card (on-policy, so the
    ratios are exactly 1 and it reduces to n-step actor-critic).

    ``batch`` keys: obs (N, T, obs), actions (N, T), rewards (N, T),
    dones (N, T, float), logp_old (N, T), last_value (N,) — returns
    ``(loss, (pg_loss, value_loss, entropy))``, each the mean over the N
    trajectories of the single-trajectory value (all have T steps, so
    the mean of their means).  The V-trace recursion runs backwards over
    T on (N,) tensors; its targets carry no gradient.
    """

    def loss_fn(params, batch):
        import torch

        from .ppo import _policy_forward

        logits, values = _policy_forward(params, batch["obs"])
        logp_all = torch.log_softmax(logits, -1)
        logp = torch.gather(
            logp_all, -1, batch["actions"].long()[..., None]
        )[..., 0]
        # Importance ratios target/behavior.
        rhos = torch.exp(logp - batch["logp_old"])
        last_value = batch["last_value"][:, None]
        with torch.no_grad():
            clipped_rho = torch.clamp(rhos, max=rho_bar)
            clipped_c = torch.clamp(rhos, max=c_bar)
            discounts = gamma * (1.0 - batch["dones"])
            values_next = torch.cat([values[:, 1:], last_value], 1)
            deltas = clipped_rho * (
                batch["rewards"] + discounts * values_next - values
            )
            acc = torch.zeros_like(deltas[:, 0])
            vs_minus_v = [None] * deltas.shape[1]
            for t in range(deltas.shape[1] - 1, -1, -1):
                acc = deltas[:, t] + discounts[:, t] * clipped_c[:, t] * acc
                vs_minus_v[t] = acc
            vs = torch.stack(vs_minus_v, 1) + values
            vs_next = torch.cat([vs[:, 1:], last_value], 1)
            pg_adv = clipped_rho * (
                batch["rewards"] + discounts * vs_next - values
            )
        if use_appo_clip:  # APPO: clipped surrogate on vtrace advantages
            surrogate = torch.minimum(
                rhos * pg_adv,
                torch.clamp(rhos, 1 - appo_clip_eps, 1 + appo_clip_eps)
                * pg_adv,
            )
            pg_loss = -torch.mean(surrogate)
        else:
            pg_loss = -torch.mean(logp * pg_adv)
        value_loss = torch.mean((values - vs) ** 2)
        entropy = -torch.mean(
            torch.sum(torch.exp(logp_all) * logp_all, -1)
        )
        loss = pg_loss + value_coeff * value_loss - entropy_coeff * entropy
        return loss, (pg_loss.detach(), value_loss.detach(),
                      entropy.detach())

    return loss_fn


def make_vtrace_update(tx, loss_fn):
    """Gradient of a v-trace ``loss_fn`` + the optimizer's step (``tx``,
    an ``algorithm.Adam``): ``update(params, opt_state, batch) ->
    (params, opt_state, loss, aux)`` on the params' device."""

    from .algorithm import value_and_grad

    def update(params, opt_state, batch):
        loss, aux, grads = value_and_grad(loss_fn, params, batch)
        params, opt_state = tx.step(params, grads, opt_state)
        return params, opt_state, loss, aux

    return update


def trajectory_batch(traj, device, time_major: bool = False):
    """A runner's trajectory (numpy) → the loss's (N, T, ...) tensors on
    ``device``: one trajectory (T, ...) becomes N = 1; a time-major
    (T, B, ...) batch (``time_major``) is transposed to (B, T, ...)."""
    import torch

    def put(key, dtype=None):
        # A copy: arrays read from the object store are read-only.
        v = torch.as_tensor(np.array(traj[key], dtype), device=device)
        if time_major:
            return v.transpose(0, 1)
        return v[None]

    last = torch.as_tensor(np.array(traj["last_value"], np.float32),
                           device=device).reshape(-1)
    return {
        "obs": put("obs"),
        "actions": put("actions"),
        "rewards": put("rewards"),
        "dones": put("dones", np.float32),
        "logp_old": put("logp_old"),
        "last_value": last,
    }


class IMPALAConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 3e-3
        self.hidden = 32
        self.rollout_steps = 128
        self.vtrace_clip_rho = 1.0
        self.vtrace_clip_c = 1.0
        self.entropy_coeff = 0.01
        self.value_coeff = 0.5
        self.batches_per_step = 4  # learner updates per train() call
        self.use_appo_clip = False
        self.appo_clip_eps = 0.2
        self.device = None  # the learner's device; None = the card


class APPOConfig(IMPALAConfig):
    def __init__(self):
        super().__init__()
        self.use_appo_clip = True


class IMPALA(Algorithm):
    def setup(self, config: IMPALAConfig) -> None:
        from ray_tpu_torch.device import resolve_device

        from .algorithm import Adam, seeded_generator
        from .env import CartPole
        from .ppo import _init_policy

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

        loss_fn = make_vtrace_loss(
            gamma=config.gamma,
            rho_bar=config.vtrace_clip_rho,
            c_bar=config.vtrace_clip_c,
            value_coeff=config.value_coeff,
            entropy_coeff=config.entropy_coeff,
            use_appo_clip=config.use_appo_clip,
            appo_clip_eps=config.appo_clip_eps,
        )
        self._vtrace_update = make_vtrace_update(self.tx, loss_fn)

        # One in-flight sample per runner at all times (the async core);
        # the manager owns liveness: a dead/stalled runner is killed,
        # respawned (bounded budget — a deterministic failure such as an
        # unimportable env_maker must not respawn forever), and
        # resubmitted with current params via on_respawn.
        self.runner_group = FaultTolerantActorManager(
            self._make_runner,
            config.num_env_runners,
            max_restarts=2 * config.num_env_runners + 4,
            on_respawn=self._resubmit,
            name="impala",
        )
        for i in range(config.num_env_runners):
            self._resubmit(i)

    def _np_params(self):
        from .algorithm import to_numpy

        return to_numpy(self.params)

    def _make_runner(self, i: int):
        return EnvRunner.remote(self._maker_payload, self.config.seed + i)

    def _resubmit(self, i: int, actor=None) -> None:
        """Issue the next sample for runner ``i`` (also the on_respawn
        hook — a replacement runner starts sampling with fresh params)."""
        self.runner_group.submit(
            i, "sample", self._np_params(), self.config.rollout_steps
        )

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        episode_returns: List[float] = []
        steps = 0
        loss = None
        processed = 0
        restarts_before = self.runner_group.num_replacements
        # Per-step restart budget: transient deaths over a long run are
        # absorbed; a crash-loop within one step still trips it.
        self.runner_group.new_restart_window()
        while processed < cfg.batches_per_step:
            # Harvest whichever runner finishes first; death handling
            # (kill + bounded respawn + resubmit) lives in the manager —
            # the wait never stalls on a dead runner.
            i, traj = self.runner_group.wait_any(timeout=300)
            batch = trajectory_batch(traj, self.device)
            self.params, self.opt_state, loss, _aux = self._vtrace_update(
                self.params, self.opt_state, batch
            )
            episode_returns.extend(traj["episode_returns"])
            steps += len(traj["obs"])
            processed += 1
            # Resubmit with fresh params — only this runner, no barrier.
            self._resubmit(i)
        return {
            "episode_return_mean": (
                float(np.mean(episode_returns)) if episode_returns else None
            ),
            "num_env_steps_sampled": steps,
            "loss": float(loss) if loss is not None else None,
            "num_runner_restarts": (
                self.runner_group.num_replacements - restarts_before
            ),
        }

    def get_state(self) -> Dict[str, Any]:
        return {"params": self._np_params()}

    def set_state(self, state: Dict[str, Any]) -> None:
        from .algorithm import to_tensors

        self.params = to_tensors(state["params"], self.device)
        self.opt_state = self.tx.init(self.params)

    def cleanup(self) -> None:
        self.runner_group.kill_all()


class APPO(IMPALA):
    pass


IMPALAConfig.ALGO_CLS = IMPALA
APPOConfig.ALGO_CLS = APPO

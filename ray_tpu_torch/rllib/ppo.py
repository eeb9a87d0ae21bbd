"""PPO — algorithm + PyTorch learner + distributed env runners.

Reference architecture (ray ``rllib/algorithms/algorithm.py:212``,
``env/env_runner_group.py:70``, ``core/learner/learner_group.py:101``): the
Algorithm coordinates an EnvRunnerGroup of sampling actors and a Learner
performing SGD.  Here the policy/value nets and the PPO update are
functions over a tree of tensors on ``resolve_device(config.device)`` (the
card unless the config names a device); env runners stay CPU actors with
the numpy forward that receive broadcast params each iteration —
sampling scales with actors, learning runs on the card.
Fault tolerance: dead runners are detected at poll time and replaced
(the FaultTolerantActorManager pattern, ray ``rllib/utils/actor_manager.py``).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, List, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.core.serialization import dumps_function

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class PPOConfig:
    env_maker: Any = None  # callable () -> env; default CartPole
    num_env_runners: int = 2
    rollout_steps: int = 256  # per runner per iteration
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    lr: float = 3e-3
    entropy_coeff: float = 0.01
    value_coeff: float = 0.5
    num_sgd_epochs: int = 4
    minibatch_size: int = 128
    hidden: int = 32
    seed: int = 0
    device: Any = None  # the learner's device; None = the card

    def build(self) -> "PPO":
        return PPO(self)


# ----------------------------------------------------------------- learner
def _init_policy(generator, obs_size: int, num_actions: int, hidden: int):
    """Policy/value params drawn from ``generator``, on its device."""
    import torch

    device = generator.device
    scale = lambda fan_in: (2.0 / fan_in) ** 0.5  # noqa: E731
    normal = lambda *shape: torch.randn(  # noqa: E731
        shape, generator=generator, device=device)
    return {
        "w1": normal(obs_size, hidden) * scale(obs_size),
        "b1": torch.zeros(hidden, device=device),
        "wp": normal(hidden, num_actions) * 0.01,
        "bp": torch.zeros(num_actions, device=device),
        "wv": normal(hidden, 1) * scale(hidden),
        "bv": torch.zeros(1, device=device),
    }


def _policy_forward(params, obs):
    import torch

    h = torch.tanh(obs @ params["w1"] + params["b1"])
    logits = h @ params["wp"] + params["bp"]
    value = (h @ params["wv"] + params["bv"])[..., 0]
    return logits, value


def _np_policy_forward(params, obs):
    """Numpy twin of ``_policy_forward`` for host-side samplers (no torch
    import): EnvRunner, the Sebulba host-inference path, and
    ``evaluate_policy_numpy`` ALL call this one function — the
    bit-identical-parity claims between them are pinned on there being
    exactly one copy of this math.  ``obs`` may be a single observation
    (``(obs,)``) or a batch (``(B, obs)``); values follow the leading
    shape."""
    h = np.tanh(obs @ params["w1"] + params["b1"])
    logits = h @ params["wp"] + params["bp"]
    values = (h @ params["wv"] + params["bv"])[..., 0]
    return logits, values


class TorchLearner:
    """PPO update (clipped surrogate + value + entropy) on the learner's
    device: ``resolve_device(cfg.device)``, the card unless named."""

    def __init__(self, cfg: PPOConfig, obs_size: int, num_actions: int):
        import torch

        from ray_tpu_torch.device import resolve_device

        from .algorithm import Adam, seeded_generator, value_and_grad
        from .rl_module import action_logp

        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.params = _init_policy(
            seeded_generator(self.device, cfg.seed), obs_size, num_actions,
            cfg.hidden)
        self.tx = Adam(cfg.lr)
        self.opt_state = self.tx.init(self.params)

        clip_eps = cfg.clip_eps
        vf, ent = cfg.value_coeff, cfg.entropy_coeff

        def loss_fn(params, batch):
            logits, value = _policy_forward(params, batch["obs"])
            logp_all = torch.log_softmax(logits, -1)
            logp = action_logp(logits, batch["actions"])
            ratio = torch.exp(logp - batch["logp_old"])
            adv = batch["advantages"]
            surrogate = torch.minimum(
                ratio * adv,
                torch.clamp(ratio, 1 - clip_eps, 1 + clip_eps) * adv,
            )
            value_loss = torch.mean((value - batch["returns"]) ** 2)
            entropy = -torch.mean(
                torch.sum(torch.exp(logp_all) * logp_all, -1)
            )
            loss = -torch.mean(surrogate) + vf * value_loss - ent * entropy
            return loss, {
                "policy_loss": -torch.mean(surrogate).detach(),
                "value_loss": value_loss.detach(),
                "entropy": entropy.detach(),
            }

        def update(params, opt_state, batch):
            loss, stats, grads = value_and_grad(loss_fn, params, batch)
            params, opt_state = self.tx.step(params, grads, opt_state)
            stats["total_loss"] = loss
            return params, opt_state, stats

        self._update = update

    def update_minibatches(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        import torch

        n = len(batch["obs"])
        rng = np.random.default_rng(self.cfg.seed)
        stats = {}
        mb = min(self.cfg.minibatch_size, n)
        for _ in range(self.cfg.num_sgd_epochs):
            perm = rng.permutation(n)
            for i in range(0, n - mb + 1, mb):
                idx = perm[i : i + mb]
                sub = {k: torch.as_tensor(v[idx], device=self.device)
                       for k, v in batch.items()}
                self.params, self.opt_state, st = self._update(
                    self.params, self.opt_state, sub
                )
                stats = st
        return {k: float(v) for k, v in stats.items()}

    def get_params(self):
        from .algorithm import to_numpy

        return to_numpy(self.params)


# -------------------------------------------------------------- env runner
@ray_tpu_torch.remote
class EnvRunner:
    """Sampling actor: rolls out the current policy in its env copy."""

    def __init__(self, env_maker_payload: bytes, seed: int):
        from ray_tpu_torch.core.serialization import loads_function

        maker = loads_function(env_maker_payload)
        self.env = maker()
        self.rng = np.random.default_rng(seed)
        self.obs = self.env.reset()
        self.episode_return = 0.0
        self.completed_returns: List[float] = []

    def sample(self, params: Dict[str, np.ndarray], num_steps: int):
        """CPU numpy forward (tiny policy net) — no torch import needed."""
        obs_buf, act_buf, rew_buf, done_buf, logp_buf, val_buf = (
            [], [], [], [], [], [],
        )
        for _ in range(num_steps):
            logits, value = _np_policy_forward(params, self.obs)
            logits = logits - logits.max()
            probs = np.exp(logits) / np.exp(logits).sum()
            action = int(self.rng.choice(len(probs), p=probs))
            value = float(value)
            obs_buf.append(self.obs)
            act_buf.append(action)
            logp_buf.append(float(np.log(probs[action] + 1e-12)))
            val_buf.append(value)
            self.obs, reward, done, _ = self.env.step(action)
            rew_buf.append(reward)
            done_buf.append(done)
            self.episode_return += reward
            if done:
                self.completed_returns.append(self.episode_return)
                self.episode_return = 0.0
                self.obs = self.env.reset()
        # Bootstrap value for the unfinished tail.
        _, last_value = _np_policy_forward(params, self.obs)
        last_value = float(last_value)
        returns, self.completed_returns = self.completed_returns, []
        return {
            "obs": np.asarray(obs_buf, np.float32),
            "actions": np.asarray(act_buf, np.int32),
            "rewards": np.asarray(rew_buf, np.float32),
            "dones": np.asarray(done_buf, bool),
            "logp_old": np.asarray(logp_buf, np.float32),
            "values": np.asarray(val_buf, np.float32),
            "last_value": last_value,
            "episode_returns": returns,
        }


def _compute_gae(traj, gamma: float, lam: float):
    rewards, values, dones = traj["rewards"], traj["values"], traj["dones"]
    n = len(rewards)
    adv = np.zeros(n, np.float32)
    last_gae = 0.0
    next_value = traj["last_value"]
    for t in reversed(range(n)):
        nonterminal = 0.0 if dones[t] else 1.0
        delta = rewards[t] + gamma * next_value * nonterminal - values[t]
        last_gae = delta + gamma * lam * nonterminal * last_gae
        adv[t] = last_gae
        next_value = values[t]
    returns = adv + values
    return adv, returns


# ---------------------------------------------------------------- algorithm
class PPO:
    def __init__(self, config: Optional[PPOConfig] = None):
        from .env import CartPole

        self.config = config or PPOConfig()
        maker = self.config.env_maker or (lambda: CartPole())
        self._maker_payload = dumps_function(maker)
        probe = maker()
        self.obs_size = probe.observation_size
        self.num_actions = probe.num_actions
        self.learner = TorchLearner(self.config, self.obs_size, self.num_actions)
        self.runners = [
            self._make_runner(i) for i in range(self.config.num_env_runners)
        ]
        self.iteration = 0

    def _make_runner(self, idx: int):
        return EnvRunner.remote(self._maker_payload, self.config.seed + idx)

    def train(self) -> Dict[str, Any]:
        self.iteration += 1
        params = self.learner.get_params()
        refs = [
            (i, r.sample.remote(params, self.config.rollout_steps))
            for i, r in enumerate(self.runners)
        ]
        trajs = []
        episode_returns: List[float] = []
        for i, ref in refs:
            try:
                trajs.append(ray_tpu_torch.get(ref, timeout=300))
            except Exception as e:  # noqa: BLE001 - replace dead runner
                logger.warning("env runner %d failed (%s); replacing", i, e)
                self.runners[i] = self._make_runner(i)
        if not trajs:
            raise RuntimeError("all env runners failed")
        adv_list, ret_list = [], []
        for t in trajs:
            adv, ret = _compute_gae(
                t, self.config.gamma, self.config.gae_lambda
            )
            adv_list.append(adv)
            ret_list.append(ret)
            episode_returns.extend(t["episode_returns"])
        batch = {
            "obs": np.concatenate([t["obs"] for t in trajs]),
            "actions": np.concatenate([t["actions"] for t in trajs]),
            "logp_old": np.concatenate([t["logp_old"] for t in trajs]),
            "advantages": np.concatenate(adv_list),
            "returns": np.concatenate(ret_list),
        }
        adv = batch["advantages"]
        batch["advantages"] = (adv - adv.mean()) / (adv.std() + 1e-8)
        stats = self.learner.update_minibatches(batch)
        return {
            "training_iteration": self.iteration,
            "episode_return_mean": (
                float(np.mean(episode_returns)) if episode_returns else None
            ),
            "num_env_steps_sampled": sum(len(t["obs"]) for t in trajs),
            **stats,
        }

    def stop(self):
        for r in self.runners:
            try:
                ray_tpu_torch.kill(r)
            except Exception:
                pass

"""SAC — soft actor-critic for continuous control, on the RLModule +
connector architecture.

Reference: ray ``rllib/algorithms/sac/`` (tanh-gaussian policy, twin Q
with target networks, automatic entropy temperature).  The whole update
(actor + twin critics + alpha + polyak) is ONE function over the replay
batch on the learner's device (``resolve_device(hp.device)``, the card
unless named); env runner actors sample on the CPU with broadcast numpy
params through the connector pipelines (env→module obs batching,
module→env action scaling).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, Optional

import numpy as np

import ray_tpu_torch

from .algorithm import Algorithm, AlgorithmConfig
from .connectors import (
    ConnectorPipeline,
    ObsToFloatBatch,
    ScaleActions,
)
from .replay import ReplayBuffer
from .rl_module import RLModuleSpec, SACModule

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class _SACHyper:
    gamma: float = 0.99
    tau: float = 0.01  # polyak
    lr: float = 3e-3
    init_alpha: float = 0.1
    target_entropy: Optional[float] = None  # default: -action_size
    buffer_capacity: int = 50_000
    batch_size: int = 128
    rollout_steps: int = 200
    learn_steps_per_iter: int = 64
    warmup_steps: int = 500
    hidden: int = 64
    num_env_runners: int = 1
    seed: int = 0
    device: Any = None  # the learner's device; None = the card


class SACConfig(AlgorithmConfig):
    ALGO_CLS = None  # filled after SAC is defined

    def __init__(self):
        super().__init__()
        self.hp = _SACHyper()
        self.rl_module_spec = RLModuleSpec(SACModule)

    def training(self, **kwargs) -> "SACConfig":
        for k, v in kwargs.items():
            if hasattr(self.hp, k):
                setattr(self.hp, k, v)
            else:
                super().training(**{k: v})
        return self

    def rl_module(self, spec: RLModuleSpec) -> "SACConfig":
        self.rl_module_spec = spec
        return self


@ray_tpu_torch.remote
class _SACRunner:
    """CPU sampling actor: steps the env with the exploration forward of a
    broadcast RLModule params snapshot, through connector pipelines."""

    def __init__(self, env_payload, spec: RLModuleSpec, seed: int,
                 runner_idx: int, scale_low: float, scale_high: float):
        from ray_tpu_torch.core.serialization import loads_function

        from .algorithm import seeded_generator

        self.env = loads_function(env_payload)()
        self.module = spec.build(
            self.env.observation_size, self.env.action_size
        )
        self.env_to_module = ConnectorPipeline([ObsToFloatBatch()])
        self.module_to_env = ConnectorPipeline(
            [ScaleActions(scale_low, scale_high)]
        )
        self.seed = seed
        # Distinct noise stream per runner, seeded from (seed, runner_idx)
        # — small additive seed offsets would alias runner i's stream at
        # step t with runner j's at t + offset*(i-j) (correlated
        # exploration noise).
        self.runner_idx = runner_idx
        self._gen = seeded_generator("cpu", seed, runner_idx)
        self._step_count = 0
        self.obs = self.env.reset()
        self.episode_return = 0.0
        self.completed: list = []

    def sample(self, params, n_steps: int, random_actions: bool = False):
        import torch

        from .algorithm import to_tensors

        rows = {k: [] for k in
                ("obs", "actions", "rewards", "next_obs", "dones")}
        rng = np.random.default_rng(
            (self.seed, self.runner_idx, self._step_count)
        )
        tparams = None if random_actions else to_tensors(params, "cpu")
        for _ in range(n_steps):
            if random_actions:
                action = rng.uniform(-1.0, 1.0, self.env.action_size)
            else:
                batch = self.env_to_module({"obs": self.obs})
                with torch.no_grad():
                    out = self.module.forward_exploration(
                        tparams, batch, self._gen)
                action = out["actions"].numpy()[0]
            env_action = self.module_to_env({"actions": action})["actions"]
            next_obs, reward, done, _ = self.env.step(env_action)
            rows["obs"].append(np.asarray(self.obs, np.float32))
            rows["actions"].append(np.asarray(action, np.float32))
            rows["rewards"].append(np.float32(reward))
            rows["next_obs"].append(np.asarray(next_obs, np.float32))
            rows["dones"].append(done)
            self.episode_return += reward
            self._step_count += 1
            if done:
                self.completed.append(self.episode_return)
                self.episode_return = 0.0
                self.obs = self.env.reset()
            else:
                self.obs = next_obs
        episodes, self.completed = self.completed, []
        return (
            {k: np.asarray(v) for k, v in rows.items()},
            episodes,
        )


def make_sac_update(module, tx, alpha_tx, gamma, tau, target_entropy,
                    extra_critic_loss=None):
    """Build the SAC update step shared by SAC and its offline extensions
    (reference: ray CQL extends SAC's learner for exactly this reason).
    ``extra_critic_loss(params, batch, q1_data, q2_data, generator,
    noise)`` adds a regularizer to the Bellman loss (CQL's conservative
    penalty); its gradient flows into the critic nets only, like the
    Bellman term.

    ``update(params, target_params, log_alpha, opt_state,
    alpha_opt_state, batch, generator, noise=None)``: the noise of the
    target's next action, the actor's action and the regularizer
    (``noise["next"]``, ``noise["actor"]``, ``noise["extra"]``) is drawn
    from ``generator`` on the params' device unless passed in.
    """
    import torch

    from .algorithm import tree_map, value_and_grad

    def update(params, target_params, log_alpha, opt_state,
               alpha_opt_state, batch, generator, noise=None):
        noise = noise or {}
        alpha = torch.exp(log_alpha)

        # Critic target: r + gamma * (min target-Q(s', a') - alpha logp')
        with torch.no_grad():
            next_a, next_logp = module.sample_action(
                target_params, batch["next_obs"], generator,
                noise.get("next"),
            )
            tq1, tq2 = module.q_values(
                target_params, batch["next_obs"], next_a
            )
            target_v = torch.minimum(tq1, tq2) - alpha * next_logp
            nonterminal = 1.0 - batch["dones"].float()
            target_q = batch["rewards"] + gamma * nonterminal * target_v

        def critic_loss(p):
            q1, q2 = module.q_values(p, batch["obs"], batch["actions"])
            bellman = ((q1 - target_q) ** 2 + (q2 - target_q) ** 2).mean()
            extra = (
                extra_critic_loss(p, batch, q1, q2, generator,
                                  noise.get("extra"))
                if extra_critic_loss is not None
                else torch.zeros((), device=q1.device)
            )
            return bellman + extra, (bellman.detach(), extra.detach())

        def actor_loss(p):
            a, logp = module.sample_action(p, batch["obs"], generator,
                                           noise.get("actor"))
            q1, q2 = module.q_values(p, batch["obs"], a)
            # The actor's gradient is taken for the policy net only and
            # the critics' for the Q nets only (one optimizer over all).
            return (alpha.detach() * logp - torch.minimum(q1, q2)).mean(), \
                logp.detach()

        closs, (bellman, extra), cgrads = value_and_grad(
            critic_loss, params, wrt=("q1", "q2"))
        aloss, logp, agrads = value_and_grad(actor_loss, params, wrt=("pi",))
        # Actor gradients must not update the critics (and vice versa).
        grads = {"pi": agrads["pi"], "q1": cgrads["q1"], "q2": cgrads["q2"]}
        params, opt_state = tx.step(params, grads, opt_state)

        def alpha_loss(la):
            return (-torch.exp(la) * (logp + target_entropy)).mean(), None

        _al, _, agrad = value_and_grad(alpha_loss, log_alpha)
        log_alpha, alpha_opt_state = alpha_tx.step(
            log_alpha, agrad, alpha_opt_state
        )

        target_params = tree_map(
            lambda t, p: (1 - tau) * t + tau * p, target_params, params
        )
        stats = {
            "critic_loss": closs,
            "bellman_loss": bellman,
            "extra_critic_loss": extra,
            "actor_loss": aloss,
            "alpha": torch.exp(log_alpha),
        }
        return (params, target_params, log_alpha, opt_state,
                alpha_opt_state, stats)

    return update


class SAC(Algorithm):
    def setup(self, config: SACConfig):
        import torch

        from ray_tpu_torch.core.serialization import dumps_function
        from ray_tpu_torch.device import resolve_device

        from .algorithm import Adam, seeded_generator, tree_map

        hp = self.hp = config.hp
        env_maker = config.env_maker
        if env_maker is None:
            from .env import Pendulum

            env_maker = Pendulum
        probe = env_maker()
        self.obs_size = probe.observation_size
        self.action_size = probe.action_size
        low = getattr(probe, "action_low", -1.0)
        high = getattr(probe, "action_high", 1.0)

        config.rl_module_spec.model_config.setdefault("hidden", hp.hidden)
        self.module = config.rl_module_spec.build(
            self.obs_size, self.action_size
        )
        self.device = resolve_device(hp.device)
        self._gen = seeded_generator(self.device, hp.seed)
        self.params = self.module.init_state(self._gen)
        self.target_params = tree_map(torch.clone, self.params)
        self.log_alpha = torch.tensor(np.log(hp.init_alpha),
                                      dtype=torch.float32, device=self.device)
        target_entropy = (
            hp.target_entropy
            if hp.target_entropy is not None
            else -float(self.action_size)
        )

        self.tx = Adam(hp.lr)
        self.opt_state = self.tx.init(self.params)
        self.alpha_tx = Adam(hp.lr)
        self.alpha_opt_state = self.alpha_tx.init(self.log_alpha)
        self.buffer = ReplayBuffer(hp.buffer_capacity, seed=hp.seed)
        module = self.module
        gamma, tau = hp.gamma, hp.tau

        self._update = make_sac_update(
            module, self.tx, self.alpha_tx, gamma, tau, target_entropy
        )
        env_payload = dumps_function(env_maker)
        self.runners = [
            _SACRunner.remote(
                env_payload, config.rl_module_spec, hp.seed, i,
                low, high,
            )
            for i in range(max(1, hp.num_env_runners))
        ]
        self._total_steps = 0
        self._episode_returns: list = []

    def training_step(self) -> Dict[str, Any]:
        import torch

        from .algorithm import to_numpy

        hp = self.hp
        random_phase = self._total_steps < hp.warmup_steps
        np_params = to_numpy(self.params)
        refs = [
            r.sample.remote(np_params, hp.rollout_steps, random_phase)
            for r in self.runners
        ]
        for batch, episodes in ray_tpu_torch.get(refs, timeout=600):
            self.buffer.add_batch(batch)
            self._episode_returns.extend(episodes)
            self._total_steps += len(batch["rewards"])
        stats = {}
        if len(self.buffer) >= hp.batch_size and not random_phase:
            for _ in range(hp.learn_steps_per_iter):
                batch = self.buffer.sample(hp.batch_size)
                batch = {
                    k2: torch.as_tensor(v, device=self.device)
                    for k2, v in batch.items()
                }
                (self.params, self.target_params, self.log_alpha,
                 self.opt_state, self.alpha_opt_state, stats) = self._update(
                    self.params, self.target_params, self.log_alpha,
                    self.opt_state, self.alpha_opt_state, batch, self._gen,
                )
        recent = self._episode_returns[-20:]
        return {
            "episode_return_mean": (
                float(np.mean(recent)) if recent else float("nan")
            ),
            "num_env_steps_sampled": self._total_steps,
            **{k: float(v) for k, v in stats.items()},
        }

    def get_state(self):
        from .algorithm import to_numpy

        return {
            "params": to_numpy(self.params),
            "target_params": to_numpy(self.target_params),
            "log_alpha": to_numpy(self.log_alpha),
            "total_steps": self._total_steps,
        }

    def set_state(self, state):
        from .algorithm import to_tensors

        self.params = to_tensors(state["params"], self.device)
        self.target_params = to_tensors(state["target_params"], self.device)
        self.log_alpha = to_tensors(state["log_alpha"], self.device)
        self._total_steps = state["total_steps"]

    def cleanup(self):
        for r in self.runners:
            try:
                ray_tpu_torch.kill(r)
            except Exception:
                pass


SACConfig.ALGO_CLS = SAC

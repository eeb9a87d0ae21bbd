"""DQN — double-DQN with target network and (prioritized) replay.

Reference: ray ``rllib/algorithms/dqn/`` (new-API DQN: EnvRunners with
epsilon-greedy exploration feeding a replay buffer, Learner doing the
double-DQN TD update).  The TD update runs on the learner's device
(``resolve_device(config.device)``, the card unless named); sampling
stays on CPU actors with numpy forwards.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.core.serialization import dumps_function

from .actor_manager import FaultTolerantActorManager
from .algorithm import (
    Algorithm,
    AlgorithmConfig,
    init_mlp,
    mlp_forward,
    mlp_forward_np,
)

logger = logging.getLogger(__name__)

_N_LAYERS = 2  # hidden + head


class DQNConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 1e-3
        self.rollout_steps = 64
        self.hidden = 64
        self.buffer_capacity = 50_000
        self.learn_batch_size = 64
        self.num_learn_steps = 16  # per train() iteration
        self.target_update_freq = 4  # iterations between target syncs
        self.epsilon_start = 1.0
        self.epsilon_end = 0.05
        self.epsilon_decay_iters = 30
        self.min_buffer_size = 256
        self.prioritized = False
        self.double_q = True
        self.device = None  # the learner's device; None = the card


@ray_tpu_torch.remote
class DQNEnvRunner:
    """Epsilon-greedy sampler returning transition tuples."""

    def __init__(self, env_maker_payload: bytes, seed: int):
        from ray_tpu_torch.core.serialization import loads_function

        self.env = loads_function(env_maker_payload)()
        self.rng = np.random.default_rng(seed)
        self.obs = self.env.reset()
        self.episode_return = 0.0
        self.completed: List[float] = []

    def sample(self, params: Dict[str, np.ndarray], num_steps: int,
               epsilon: float):
        obs_b, act_b, rew_b, next_b, done_b = [], [], [], [], []
        for _ in range(num_steps):
            if self.rng.random() < epsilon:
                action = int(self.rng.integers(self.env.num_actions))
            else:
                q = mlp_forward_np(params, self.obs, _N_LAYERS)
                action = int(np.argmax(q))
            next_obs, reward, done, _ = self.env.step(action)
            obs_b.append(self.obs)
            act_b.append(action)
            rew_b.append(reward)
            next_b.append(next_obs)
            done_b.append(done)
            self.episode_return += reward
            self.obs = next_obs
            if done:
                self.completed.append(self.episode_return)
                self.episode_return = 0.0
                self.obs = self.env.reset()
        returns, self.completed = self.completed, []
        return {
            "obs": np.asarray(obs_b, np.float32),
            "actions": np.asarray(act_b, np.int64),
            "rewards": np.asarray(rew_b, np.float32),
            "next_obs": np.asarray(next_b, np.float32),
            "dones": np.asarray(done_b, np.float32),
        }, returns


class DQN(Algorithm):
    def setup(self, config: DQNConfig) -> None:
        import torch

        from ray_tpu_torch.device import resolve_device

        from .algorithm import Adam, seeded_generator, value_and_grad
        from .env import CartPole
        from .replay import PrioritizedReplayBuffer, ReplayBuffer

        maker = config.env_maker or (lambda: CartPole())
        self._maker_payload = dumps_function(maker)
        probe = maker()
        obs_size, num_actions = probe.observation_size, probe.num_actions

        self.device = resolve_device(config.device)
        sizes = [obs_size, config.hidden, num_actions]
        self.params = init_mlp(seeded_generator(self.device, config.seed),
                               sizes)
        self.target_params = {k: v.clone() for k, v in self.params.items()}
        self.tx = Adam(config.lr)
        self.opt_state = self.tx.init(self.params)
        self.buffer = (
            PrioritizedReplayBuffer(config.buffer_capacity, seed=config.seed)
            if config.prioritized
            else ReplayBuffer(config.buffer_capacity, seed=config.seed)
        )

        gamma, double_q = config.gamma, config.double_q
        tx = self.tx

        def loss_fn(p, target_params, batch, weights):
            q = mlp_forward(p, batch["obs"], _N_LAYERS)
            actions = batch["actions"].long()
            q_sa = torch.gather(q, 1, actions[:, None])[:, 0]
            with torch.no_grad():
                q_next_target = mlp_forward(
                    target_params, batch["next_obs"], _N_LAYERS
                )
                if double_q:
                    q_next_online = mlp_forward(
                        p, batch["next_obs"], _N_LAYERS
                    )
                    next_a = torch.argmax(q_next_online, dim=1)
                else:
                    next_a = torch.argmax(q_next_target, dim=1)
                next_q = torch.gather(q_next_target, 1, next_a[:, None])[:, 0]
                target = batch["rewards"] + gamma * (1 - batch["dones"]) * (
                    next_q
                )
            td = q_sa - target
            loss = torch.mean(weights * td**2)
            return loss, td.detach()

        def td_update(params, target_params, opt_state, batch, weights):
            loss, td, grads = value_and_grad(
                loss_fn, params, target_params, batch, weights
            )
            params, opt_state = tx.step(params, grads, opt_state)
            return params, opt_state, loss, td

        self._td_update = td_update
        self.runner_group = FaultTolerantActorManager(
            lambda i: DQNEnvRunner.remote(
                self._maker_payload, config.seed + i
            ),
            config.num_env_runners,
        )

    def _epsilon(self) -> float:
        cfg = self.config
        frac = min(1.0, self.iteration / max(1, cfg.epsilon_decay_iters))
        return cfg.epsilon_start + frac * (cfg.epsilon_end - cfg.epsilon_start)

    def training_step(self) -> Dict[str, Any]:
        import torch

        from .algorithm import to_numpy

        cfg = self.config
        np_params = to_numpy(self.params)
        eps = self._epsilon()
        results = self.runner_group.foreach(
            "sample", np_params, cfg.rollout_steps, eps
        )
        episode_returns: List[float] = []
        steps = 0
        for _, (batch, returns) in results:
            self.buffer.add_batch(batch)
            episode_returns.extend(returns)
            steps += len(batch["obs"])

        loss = None
        if len(self.buffer) >= cfg.min_buffer_size:
            for _ in range(cfg.num_learn_steps):
                sample = self.buffer.sample(cfg.learn_batch_size)
                weights = sample.pop("_weights", None)
                indices = sample.pop("_indices", None)
                w = torch.as_tensor(
                    weights
                    if weights is not None
                    else np.ones(cfg.learn_batch_size, np.float32),
                    device=self.device,
                )
                jb = {k: torch.as_tensor(v, device=self.device)
                      for k, v in sample.items()}
                self.params, self.opt_state, loss, td = self._td_update(
                    self.params, self.target_params, self.opt_state, jb, w
                )
                if indices is not None:
                    self.buffer.update_priorities(indices,
                                                  td.cpu().numpy())
        if self.iteration % cfg.target_update_freq == 0:
            self.target_params = {k: v.clone()
                                  for k, v in self.params.items()}
        return {
            "episode_return_mean": (
                float(np.mean(episode_returns)) if episode_returns else None
            ),
            "num_env_steps_sampled": steps,
            "epsilon": eps,
            "buffer_size": len(self.buffer),
            "loss": float(loss) if loss is not None else None,
        }

    def get_state(self) -> Dict[str, Any]:
        from .algorithm import to_numpy

        return {
            "params": to_numpy(self.params),
            "target_params": to_numpy(self.target_params),
        }

    def set_state(self, state: Dict[str, Any]) -> None:
        from .algorithm import to_tensors

        self.params = to_tensors(state["params"], self.device)
        self.target_params = to_tensors(state["target_params"], self.device)
        self.opt_state = self.tx.init(self.params)

    def cleanup(self) -> None:
        self.runner_group.kill_all()


DQNConfig.ALGO_CLS = DQN

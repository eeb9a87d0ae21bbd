"""Multi-agent environments + episode collection + independent learning.

Reference: ray ``rllib/env/multi_agent_env.py`` + ``multi_agent_env_runner.py``
+ ``rllib/core/rl_module/multi_rl_module.py``: an env steps a DICT of
per-agent actions and returns per-agent observations/rewards with a
``"__all__"`` done flag; the runner collects per-agent episodes; policies
map to agents through a ``policy_mapping_fn`` (agents may share one policy
or train independent ones).

This module provides the protocol, the episode collector, and
``IndependentTrainer``: per-policy REINFORCE-with-baseline learners over a
``MultiRLModule`` of discrete policy modules — the minimal multi-agent
learning stack the smoke envs need, structured so richer learners (PPO
losses per policy) slot in.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np

from .rl_module import DiscretePolicyModule, MultiRLModule, RLModuleSpec

ALL_DONE = "__all__"


class MultiAgentEnv:
    """Protocol: subclass with ``agents``, ``observation_sizes``,
    ``action_sizes`` dicts and dict-valued reset/step."""

    agents: List[str]

    def reset(self) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def step(self, actions: Dict[str, Any]):
        """-> (obs_dict, reward_dict, done_dict incl ALL_DONE, info)."""
        raise NotImplementedError


class TwoAgentCoopEnv(MultiAgentEnv):
    """Smoke env: two agents each see a target bit and earn +1 when BOTH
    match their action to their own target (cooperative coordination —
    learnable only if each agent's policy reads its own observation)."""

    agents = ["a0", "a1"]
    observation_sizes = {"a0": 2, "a1": 2}
    action_sizes = {"a0": 2, "a1": 2}

    def __init__(self, seed: int = 0, max_steps: int = 32):
        self.rng = np.random.default_rng(seed)
        self.max_steps = max_steps
        self._t = 0
        self._targets: Dict[str, int] = {}

    def _obs(self) -> Dict[str, np.ndarray]:
        return {
            a: np.eye(2, dtype=np.float32)[self._targets[a]]
            for a in self.agents
        }

    def reset(self):
        self._t = 0
        self._targets = {
            a: int(self.rng.integers(0, 2)) for a in self.agents
        }
        return self._obs()

    def step(self, actions):
        both = all(
            int(actions[a]) == self._targets[a] for a in self.agents
        )
        rewards = {a: 1.0 if both else 0.0 for a in self.agents}
        self._t += 1
        done = self._t >= self.max_steps
        self._targets = {
            a: int(self.rng.integers(0, 2)) for a in self.agents
        }
        dones = {a: done for a in self.agents}
        dones[ALL_DONE] = done
        return self._obs(), rewards, dones, {}


class MultiAgentEpisode:
    """Per-agent transition columns for one episode (reference
    ``MultiAgentEpisode``)."""

    def __init__(self, agents):
        self.steps: Dict[str, Dict[str, list]] = {
            a: {"obs": [], "actions": [], "rewards": []} for a in agents
        }
        self.total_reward = 0.0

    def add(self, agent, obs, action, reward):
        s = self.steps[agent]
        s["obs"].append(np.asarray(obs, np.float32))
        s["actions"].append(int(action))
        s["rewards"].append(float(reward))
        self.total_reward += float(reward)


def collect_episodes(
    env: MultiAgentEnv,
    module: MultiRLModule,
    params: Dict[str, Any],
    policy_mapping_fn: Callable[[str], str],
    n_episodes: int,
    generator,
) -> List[MultiAgentEpisode]:
    """Roll the env with per-agent policies (exploration forward), every
    action drawn from ``generator`` on the params' device."""
    import torch

    episodes = []
    for _ in range(n_episodes):
        ep = MultiAgentEpisode(env.agents)
        obs = env.reset()
        done = False
        while not done:
            actions = {}
            for agent, o in obs.items():
                pid = policy_mapping_fn(agent)
                with torch.no_grad():
                    out = module[pid].forward_exploration(
                        params[pid], {"obs": o[None]}, generator
                    )
                actions[agent] = int(out["actions"][0])
            next_obs, rewards, dones, _ = env.step(actions)
            for agent in obs:
                ep.add(agent, obs[agent], actions[agent], rewards[agent])
            obs = next_obs
            done = bool(dones.get(ALL_DONE, False))
        episodes.append(ep)
    return episodes


class IndependentTrainer:
    """Independent per-policy learners over a MultiRLModule (the
    reference's independent-learning mode of multi-agent training), on
    ``resolve_device(device)``: the card unless named."""

    def __init__(
        self,
        env_maker: Callable[[], MultiAgentEnv],
        policy_mapping_fn: Optional[Callable[[str], str]] = None,
        hidden: int = 32,
        lr: float = 3e-2,
        gamma: float = 0.99,
        seed: int = 0,
        device: Any = None,
    ):
        import torch

        from ray_tpu_torch.device import resolve_device

        from .algorithm import Adam, seeded_generator, value_and_grad
        from .rl_module import action_logp

        self.env_maker = env_maker
        probe = env_maker()
        self.policy_mapping_fn = policy_mapping_fn or (lambda agent: agent)
        policy_ids = sorted(
            {self.policy_mapping_fn(a) for a in probe.agents}
        )
        mods = {}
        for pid in policy_ids:
            agent = next(
                a for a in probe.agents if self.policy_mapping_fn(a) == pid
            )
            mods[pid] = RLModuleSpec(
                DiscretePolicyModule, {"hidden": hidden}
            ).build(
                probe.observation_sizes[agent], probe.action_sizes[agent]
            )
        self.device = resolve_device(device)
        self.module = MultiRLModule(mods)
        self.params = self.module.init_state(
            seeded_generator(self.device, seed))
        self.gamma = gamma
        self._gen = seeded_generator(self.device, seed + 1)
        self.tx = Adam(lr)
        self.opt_state = {
            pid: self.tx.init(self.params[pid]) for pid in policy_ids
        }

        def make_update(mod):
            def loss(p, obs, actions, returns):
                out = mod.forward_train(p, {"obs": obs})
                logp = action_logp(out["logits"], actions)
                baseline = returns.mean()
                adv = returns - baseline
                return -(logp * adv).mean(), None

            def update(params, opt_state, obs, actions, returns):
                lv, _, grads = value_and_grad(loss, params, obs, actions,
                                              returns)
                params, opt_state = self.tx.step(params, grads, opt_state)
                return params, opt_state, lv

            return update

        self._updates = {
            pid: make_update(self.module[pid]) for pid in policy_ids
        }
        self._env = env_maker()

    def train(self, episodes_per_iter: int = 8) -> Dict[str, Any]:
        import torch

        eps = collect_episodes(
            self._env, self.module, self.params, self.policy_mapping_fn,
            episodes_per_iter, self._gen,
        )
        # Batch per POLICY (agents sharing a policy pool their data).
        per_policy: Dict[str, Dict[str, list]] = {}
        for ep in eps:
            for agent, cols in ep.steps.items():
                pid = self.policy_mapping_fn(agent)
                acc = per_policy.setdefault(
                    pid, {"obs": [], "actions": [], "returns": []}
                )
                rets, g = [], 0.0
                for r in reversed(cols["rewards"]):
                    g = r + self.gamma * g
                    rets.append(g)
                acc["obs"].extend(cols["obs"])
                acc["actions"].extend(cols["actions"])
                acc["returns"].extend(reversed(rets))
        losses = {}
        dev = self.device
        for pid, acc in per_policy.items():
            self.params[pid], self.opt_state[pid], lv = self._updates[pid](
                self.params[pid],
                self.opt_state[pid],
                torch.as_tensor(np.stack(acc["obs"]), device=dev),
                torch.as_tensor(np.asarray(acc["actions"], np.int32),
                                device=dev),
                torch.as_tensor(np.asarray(acc["returns"], np.float32),
                                device=dev),
            )
            losses[pid] = float(lv)
        mean_r = float(np.mean([ep.total_reward for ep in eps]))
        return {"episode_reward_mean": mean_r, "policy_losses": losses}

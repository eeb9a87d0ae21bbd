"""Implicit Q-Learning — offline RL without out-of-sample Q queries.

Reference: ray ``rllib/algorithms/iql/`` (expectile-regression IQL):
  - V is trained by expectile regression toward min(Q1, Q2) on DATASET
    actions only (tau > 0.5 biases toward the upper envelope, a soft max
    over in-support actions),
  - Q is trained by Bellman backup toward r + gamma * V(s') (no policy
    actions anywhere in the critic path),
  - the policy is extracted by advantage-weighted regression:
    maximize exp(beta * (Q - V)) * log pi(a_data | s).

Fully offline on ``OfflineData``; actions use the module's normalized
[-1, 1] convention (see ``offline.record_transitions``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np

from .algorithm import Algorithm, AlgorithmConfig
from .offline import OfflineData
from .rl_module import RLModuleSpec, SACModule, _mlp_apply, _mlp_init


class IQLModule(SACModule):
    """SAC's tanh-gaussian policy + twin Q, plus the state-value net V
    that IQL's expectile regression trains."""

    def init_state(self, generator):
        params = super().init_state(generator)
        hidden = self.model_config.get("hidden", 64)
        # V is drawn after pi, q1 and q2, from the same generator.
        params["v"] = _mlp_init(
            generator, [self.obs_size, hidden, hidden, 1], out_scale=1.0
        )
        return params

    def v_values(self, params, obs):
        return _mlp_apply(params["v"], obs, 3, activation="relu")[..., 0]


@dataclasses.dataclass
class IQLHyperparams:
    lr: float = 3e-4
    gamma: float = 0.99
    tau: float = 0.005           # polyak for target Q nets
    expectile: float = 0.7       # V regression expectile (tau in the paper)
    beta: float = 3.0            # advantage-weighted regression temperature
    adv_clip: float = 100.0      # exp-weight clip
    hidden: int = 64
    batch_size: int = 256
    learn_steps_per_iter: int = 200
    seed: int = 0
    device: Any = None  # the learner's device; None = the card


class IQLConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.hp = IQLHyperparams()
        self.offline_data = None
        self.env_maker: Optional[Callable] = None
        self.rl_module_spec = RLModuleSpec(IQLModule, {})

    def training(self, **kwargs) -> "IQLConfig":
        for k, v in kwargs.items():
            if not hasattr(self.hp, k):
                raise ValueError(f"unknown IQL hyperparam {k!r}")
            setattr(self.hp, k, v)
        return self

    def offline(self, data) -> "IQLConfig":
        self.offline_data = data
        return self

    def environment(self, env_maker) -> "IQLConfig":
        self.env_maker = env_maker
        return self


def make_iql_update(module, tx, gamma, tau, expectile, beta, adv_clip):
    """``update(params, target_params, opt_state, batch) -> (params,
    target_params, opt_state, stats)``: V by expectile regression, the twin
    Q by the Bellman backup through V, the policy by advantage-weighted
    regression, one Adam step over all four nets, then polyak."""
    import torch

    from .algorithm import tree_map, value_and_grad

    def update(params, target_params, opt_state, batch):
        obs, acts = batch["obs"], batch["actions"]

        with torch.no_grad():
            # --- V's target: min target-Q(s, a_data)
            tq1, tq2 = module.q_values(target_params, obs, acts)
            q_data = torch.minimum(tq1, tq2)
            # --- Q's target: r + gamma * V(s') (dataset actions only)
            next_v = module.v_values(params, batch["next_obs"])
            nonterminal = 1.0 - batch["dones"].float()
            target_q = batch["rewards"] + gamma * nonterminal * next_v
            # --- the policy's advantage weights
            adv = q_data - module.v_values(params, obs)
            w_pi = torch.clamp(torch.exp(beta * adv), max=adv_clip)

        def v_loss(p):
            v = module.v_values(p, obs)
            diff = q_data - v
            w = torch.where(diff > 0, expectile, 1.0 - expectile)
            return (w * diff ** 2).mean(), None

        def q_loss(p):
            q1, q2 = module.q_values(p, obs, acts)
            return ((q1 - target_q) ** 2 + (q2 - target_q) ** 2).mean(), None

        # --- policy: advantage-weighted regression on dataset actions
        def pi_loss(p):
            mean, log_std = module._pi(p, obs)
            std = torch.exp(log_std)
            # log-prob of the dataset action under the tanh-gaussian
            a = torch.clamp(acts, -1 + 1e-5, 1 - 1e-5)
            pre = torch.atanh(a)
            logp = (
                -0.5 * (((pre - mean) / std) ** 2
                        + 2 * log_std + np.log(2 * np.pi))
            ).sum(-1)
            logp = logp - torch.log(1 - a ** 2 + 1e-6).sum(-1)
            return -(w_pi * logp).mean(), None

        vl, _, vgrads = value_and_grad(v_loss, params, wrt=("v",))
        ql, _, qgrads = value_and_grad(q_loss, params, wrt=("q1", "q2"))
        pl, _, pgrads = value_and_grad(pi_loss, params, wrt=("pi",))
        grads = {
            "pi": pgrads["pi"],
            "q1": qgrads["q1"],
            "q2": qgrads["q2"],
            "v": vgrads["v"],
        }
        params, opt_state = tx.step(params, grads, opt_state)
        target_params = tree_map(
            lambda t, p: (1 - tau) * t + tau * p, target_params, params
        )
        stats = {"v_loss": vl, "q_loss": ql, "pi_loss": pl}
        return params, target_params, opt_state, stats

    return update


class IQL(Algorithm):
    def setup(self, config: IQLConfig) -> None:
        import torch

        from ray_tpu_torch.device import resolve_device

        from .algorithm import Adam, seeded_generator, tree_map

        hp = self.hp = config.hp
        if config.offline_data is None:
            raise ValueError("IQL requires .offline(data)")
        self.data = (
            config.offline_data
            if isinstance(config.offline_data, OfflineData)
            else OfflineData(config.offline_data, seed=hp.seed)
        )
        self.env_maker = config.env_maker
        probe = self.data.sample(2)
        obs_size = probe["obs"].shape[1]
        action_size = probe["actions"].shape[1]

        config.rl_module_spec.model_config.setdefault("hidden", hp.hidden)
        self.module = module = config.rl_module_spec.build(
            obs_size, action_size
        )
        self.device = resolve_device(hp.device)
        self.params = module.init_state(
            seeded_generator(self.device, hp.seed))
        self.target_params = tree_map(torch.clone, self.params)
        self.tx = Adam(hp.lr)
        self.opt_state = self.tx.init(self.params)
        self._update = make_iql_update(
            module, self.tx, hp.gamma, hp.tau, hp.expectile, hp.beta,
            hp.adv_clip)
        self._steps = 0

    # Batches are sampled (and moved to the device) this many at a time.
    _SCAN_CHUNK = 50

    def training_step(self) -> Dict[str, Any]:
        import torch

        hp = self.hp
        stats = {}
        remaining = hp.learn_steps_per_iter
        while remaining > 0:
            k = min(self._SCAN_CHUNK, remaining)
            remaining -= k
            sampled = [self.data.sample(hp.batch_size) for _ in range(k)]
            batches = {
                key: torch.as_tensor(
                    np.stack([b[key] for b in sampled]),
                    dtype=torch.float32 if key != "dones" else None,
                    device=self.device,
                )
                for key in ("obs", "actions", "rewards", "next_obs", "dones")
            }
            self._steps += k
            for i in range(k):
                (self.params, self.target_params, self.opt_state,
                 stats) = self._update(
                    self.params, self.target_params, self.opt_state,
                    {key: v[i] for key, v in batches.items()},
                )
        out = {k2: float(v) for k2, v in stats.items()}
        out["learn_steps_total"] = self._steps
        return out

    def evaluate(self, episodes: int = 5, seed: int = 100) -> Dict[str, Any]:
        from .cql import CQL

        return CQL.evaluate(self, episodes=episodes, seed=seed)

    def get_state(self) -> Dict[str, Any]:
        from .algorithm import to_numpy

        return {
            "params": to_numpy(self.params),
            "target_params": to_numpy(self.target_params),
            "steps": self._steps,
        }

    def set_state(self, state: Dict[str, Any]) -> None:
        from .algorithm import to_tensors

        self.params = to_tensors(state["params"], self.device)
        self.target_params = to_tensors(state["target_params"], self.device)
        self.opt_state = self.tx.init(self.params)
        self._steps = state.get("steps", 0)


IQLConfig.ALGO_CLS = IQL

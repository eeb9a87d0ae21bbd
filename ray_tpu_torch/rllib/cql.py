"""Conservative Q-Learning — offline RL on the SAC module.

Reference: ray ``rllib/algorithms/cql/cql.py`` (+ ``cql_torch_learner``):
SAC's actor/critic/alpha losses plus the CQL(H) conservative regularizer
on both critics — logsumexp of Q over sampled (uniform + policy) actions
minus Q on dataset actions — which pushes Q down on out-of-distribution
actions so the learned policy stays inside the dataset's support.  Purely
offline: no env runners; transitions stream from ``OfflineData``.

Actions are stored NORMALIZED to the module's [-1, 1] tanh range; callers
scale to env units at evaluation time (``ScaleActions``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np

from .algorithm import Algorithm, AlgorithmConfig
from .offline import OfflineData
from .rl_module import RLModuleSpec, SACModule
from .sac import make_sac_update


@dataclasses.dataclass
class CQLHyperparams:
    lr: float = 3e-4
    gamma: float = 0.99
    tau: float = 0.005
    hidden: int = 64
    batch_size: int = 256
    learn_steps_per_iter: int = 200
    init_alpha: float = 0.2
    target_entropy: Optional[float] = None
    # CQL(H) regularizer
    cql_alpha: float = 1.0
    cql_n_actions: int = 8
    seed: int = 0
    device: Any = None  # the learner's device; None = the card


class CQLConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.hp = CQLHyperparams()
        self.offline_data = None
        self.env_maker: Optional[Callable] = None  # evaluation only
        self.rl_module_spec = RLModuleSpec(SACModule, {})

    def training(self, **kwargs) -> "CQLConfig":
        for k, v in kwargs.items():
            if not hasattr(self.hp, k):
                raise ValueError(f"unknown CQL hyperparam {k!r}")
            setattr(self.hp, k, v)
        return self

    def offline(self, data) -> "CQLConfig":
        self.offline_data = data
        return self

    def environment(self, env_maker) -> "CQLConfig":
        self.env_maker = env_maker
        return self

    def rl_module(self, spec: RLModuleSpec) -> "CQLConfig":
        self.rl_module_spec = spec
        return self


def cql_noise(generator, n_rand: int, batch_size: int, action_size: int):
    """The CQL penalty's draws: ``n_rand`` uniform actions in [-1, 1] per
    state and the policy proposal's standard normal noise."""
    import torch

    device = generator.device
    rand_a = torch.rand((n_rand, batch_size, action_size),
                        generator=generator, device=device) * 2.0 - 1.0
    pi_eps = torch.randn((batch_size, action_size), generator=generator,
                         device=device)
    return {"rand_a": rand_a, "pi_eps": pi_eps}


class CQL(Algorithm):
    def setup(self, config: CQLConfig) -> None:
        import torch

        from ray_tpu_torch.device import resolve_device

        from .algorithm import Adam, seeded_generator, tree_map

        hp = self.hp = config.hp
        if config.offline_data is None:
            raise ValueError("CQL requires .offline(data)")
        self.data = (
            config.offline_data
            if isinstance(config.offline_data, OfflineData)
            else OfflineData(config.offline_data, seed=hp.seed)
        )
        self.env_maker = config.env_maker
        probe_batch = self.data.sample(2)
        obs_size = probe_batch["obs"].shape[1]
        action_size = probe_batch["actions"].shape[1]
        self.obs_size, self.action_size = obs_size, action_size

        config.rl_module_spec.model_config.setdefault("hidden", hp.hidden)
        self.module = module = config.rl_module_spec.build(
            obs_size, action_size
        )
        self.device = resolve_device(hp.device)
        self._gen = seeded_generator(self.device, hp.seed)
        self.params = module.init_state(self._gen)
        self.target_params = tree_map(torch.clone, self.params)
        self.log_alpha = torch.tensor(np.log(hp.init_alpha),
                                      dtype=torch.float32, device=self.device)
        target_entropy = (
            hp.target_entropy
            if hp.target_entropy is not None
            else -float(action_size)
        )
        self.tx = Adam(hp.lr)
        self.opt_state = self.tx.init(self.params)
        self.alpha_tx = Adam(hp.lr)
        self.alpha_opt_state = self.alpha_tx.init(self.log_alpha)

        gamma, tau = hp.gamma, hp.tau
        cql_alpha, n_rand = hp.cql_alpha, hp.cql_n_actions

        def cql_penalty(p, obs, data_q1, data_q2, noise):
            """logsumexp over {uniform, current-policy} actions minus the
            dataset-action Q — per critic (the CQL(H) estimator)."""
            b = obs.shape[0]
            rand_a = noise["rand_a"]
            pi_a, pi_logp = module.sample_action(p, obs, eps=noise["pi_eps"])
            # Q of every uniform proposal in one batched call: the states
            # repeat over the n_rand axis.
            q1s, q2s = module.q_values(
                p, obs[None].expand(n_rand, b, obs.shape[-1]), rand_a
            )  # [n_rand, B]
            pq1, pq2 = module.q_values(p, obs, pi_a)
            # Importance correction: uniform proposals have log-density
            # -A*log(2); policy proposals use their own logp.
            log_u = -action_size * np.log(2.0)
            cat1 = torch.cat(
                [q1s - log_u, (pq1 - pi_logp)[None]], dim=0
            )
            cat2 = torch.cat(
                [q2s - log_u, (pq2 - pi_logp)[None]], dim=0
            )
            ls1 = torch.logsumexp(cat1, dim=0)
            ls2 = torch.logsumexp(cat2, dim=0)
            return (ls1 - data_q1).mean() + (ls2 - data_q2).mean()

        def conservative_extra(p, batch, q1_data, q2_data, generator,
                               noise):
            if noise is None:
                noise = cql_noise(generator, n_rand, batch["obs"].shape[0],
                                  action_size)
            return cql_alpha * cql_penalty(p, batch["obs"], q1_data,
                                           q2_data, noise)

        self._update = make_sac_update(
            module, self.tx, self.alpha_tx, gamma, tau, target_entropy,
            extra_critic_loss=conservative_extra,
        )
        self._steps = 0

    # Batches are sampled (and moved to the device) this many at a time.
    _SCAN_CHUNK = 50

    def update_many(self, batches, noises=None):
        """K updates in a row over stacked batches (leading axis K); the
        stats are the last update's.  ``noises`` (one dict a batch) is for
        parity with the JAX package's draws; by default every draw comes
        from the learner's generator."""
        stats = {}
        k = batches["rewards"].shape[0]
        for i in range(k):
            batch = {key: v[i] for key, v in batches.items()}
            (self.params, self.target_params, self.log_alpha,
             self.opt_state, self.alpha_opt_state, stats) = self._update(
                self.params, self.target_params, self.log_alpha,
                self.opt_state, self.alpha_opt_state, batch, self._gen,
                None if noises is None else noises[i],
            )
        return stats

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
            stats = self.update_many(batches)
        out = {k: float(v) for k, v in stats.items()}
        if "extra_critic_loss" in out:
            out["cql_penalty"] = out.pop("extra_critic_loss")
        out["learn_steps_total"] = self._steps
        return out

    # ------------------------------------------------------------ evaluation
    def evaluate(self, episodes: int = 5, seed: int = 100) -> Dict[str, Any]:
        """Greedy rollout of the learned policy in the (eval-only) env."""
        if self.env_maker is None:
            raise ValueError("evaluate() requires .environment(env_maker)")
        import torch

        from .algorithm import to_tensors

        # The greedy forward runs on the host: one tiny MLP a step.
        params = to_tensors(self.params, "cpu")
        returns = []
        for ep in range(episodes):
            env = self.env_maker(seed=seed + ep) if _takes_seed(
                self.env_maker
            ) else self.env_maker()
            lo = getattr(env, "action_low", -1.0)
            hi = getattr(env, "action_high", 1.0)
            obs = env.reset()
            total, done = 0.0, False
            while not done:
                with torch.no_grad():
                    out = self.module.forward_inference(
                        params,
                        {"obs": np.asarray(obs, np.float32)[None]},
                    )
                a = out["actions"].numpy()[0]
                env_a = lo + (a + 1.0) * 0.5 * (hi - lo)
                obs, r, done, _ = env.step(env_a)
                total += r
            returns.append(total)
        return {
            "episode_return_mean": float(np.mean(returns)),
            "episodes": episodes,
        }

    def get_state(self) -> Dict[str, Any]:
        from .algorithm import to_numpy

        return {
            "params": to_numpy(self.params),
            "target_params": to_numpy(self.target_params),
            "log_alpha": to_numpy(self.log_alpha),
            "steps": self._steps,
        }

    def set_state(self, state: Dict[str, Any]) -> None:
        from .algorithm import to_tensors

        self.params = to_tensors(state["params"], self.device)
        self.target_params = to_tensors(state["target_params"], self.device)
        self.log_alpha = to_tensors(state["log_alpha"], self.device)
        self.opt_state = self.tx.init(self.params)
        self.alpha_opt_state = self.alpha_tx.init(self.log_alpha)
        self._steps = state.get("steps", 0)


def _takes_seed(env_maker) -> bool:
    import inspect

    try:
        return "seed" in inspect.signature(env_maker).parameters
    except (TypeError, ValueError):
        return False


CQLConfig.ALGO_CLS = CQL

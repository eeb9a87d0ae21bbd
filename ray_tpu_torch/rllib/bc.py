"""Behavior Cloning — offline RL from a dataset of (obs, action) pairs.

Reference: ray ``rllib/algorithms/bc/`` (+ ``rllib/offline/``): supervised
cross-entropy on logged actions, reading batches through the Data layer.
MARWIL reduces to this when advantages are all-ones (``beta=0``); passing
``beta>0`` weights the loss by exponentiated advantages, giving the MARWIL
objective.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from .algorithm import Algorithm, AlgorithmConfig, init_mlp, mlp_forward

_N_LAYERS = 2


class BCConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 1e-3
        self.hidden = 64
        self.train_batch_size = 256
        self.num_sgd_steps = 16
        self.beta = 0.0  # >0 → MARWIL advantage weighting
        self.offline_data = None  # ray_tpu_torch.data.Dataset or dict
        self.device = None  # the learner's device; None = the card

    def offline(self, data) -> "BCConfig":
        self.offline_data = data
        return self


class BC(Algorithm):
    def setup(self, config: BCConfig) -> None:
        import torch

        from ray_tpu_torch.device import resolve_device

        from .algorithm import Adam, seeded_generator, value_and_grad

        data = config.offline_data
        if data is None:
            raise ValueError("BC requires .offline(data)")
        if not isinstance(data, dict):  # a Dataset of {"obs","actions",...}
            rows = data.take_all()
            data = {
                k: np.asarray([r[k] for r in rows])
                for k in rows[0].keys()
            }
        self.data = {
            "obs": np.asarray(data["obs"], np.float32),
            "actions": np.asarray(data["actions"], np.int64),
            "advantages": np.asarray(
                data.get(
                    "advantages", np.ones(len(data["actions"]), np.float32)
                ),
                np.float32,
            ),
        }
        obs_size = self.data["obs"].shape[1]
        num_actions = int(self.data["actions"].max()) + 1
        self.num_actions = num_actions

        self.device = resolve_device(config.device)
        self.params = init_mlp(seeded_generator(self.device, config.seed),
                               [obs_size, config.hidden, num_actions])
        self.tx = Adam(config.lr)
        self.opt_state = self.tx.init(self.params)
        self._rng = np.random.default_rng(config.seed)
        beta = config.beta
        tx = self.tx

        def loss_fn(p, batch):
            from .rl_module import action_logp

            logits = mlp_forward(p, batch["obs"], _N_LAYERS)
            logp = action_logp(logits, batch["actions"])
            weight = (
                torch.exp(beta * batch["advantages"]) if beta > 0 else 1.0
            )
            return -torch.mean(weight * logp), None

        def update(params, opt_state, batch):
            loss, _, grads = value_and_grad(loss_fn, params, batch)
            params, opt_state = tx.step(params, grads, opt_state)
            return params, opt_state, loss

        self._update = update

    def training_step(self) -> Dict[str, Any]:
        import torch

        cfg = self.config
        n = len(self.data["actions"])
        loss = None
        for _ in range(cfg.num_sgd_steps):
            idx = self._rng.integers(0, n, size=min(cfg.train_batch_size, n))
            batch = {k: torch.as_tensor(v[idx], device=self.device)
                     for k, v in self.data.items()}
            self.params, self.opt_state, loss = self._update(
                self.params, self.opt_state, batch
            )
        return {"loss": float(loss)}

    def compute_action(self, obs: np.ndarray) -> int:
        import torch

        x = torch.as_tensor(np.asarray(obs, np.float32), device=self.device)
        with torch.no_grad():
            logits = mlp_forward(self.params, x, _N_LAYERS)
        return int(torch.argmax(logits))

    def get_state(self) -> Dict[str, Any]:
        from .algorithm import to_numpy

        return {"params": to_numpy(self.params)}

    def set_state(self, state: Dict[str, Any]) -> None:
        from .algorithm import to_tensors

        self.params = to_tensors(state["params"], self.device)
        self.opt_state = self.tx.init(self.params)


class MARWILConfig(BCConfig):
    def __init__(self):
        super().__init__()
        self.beta = 1.0


class MARWIL(BC):
    pass


BCConfig.ALGO_CLS = BC
MARWILConfig.ALGO_CLS = MARWIL

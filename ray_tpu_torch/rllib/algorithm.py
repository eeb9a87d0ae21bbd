"""Algorithm base + config builder.

Reference: ``Algorithm`` (ray ``rllib/algorithms/algorithm.py:212`` — a
Tune Trainable whose ``step()`` runs one sample+learn iteration) and the
``AlgorithmConfig`` fluent builder (``rllib/algorithms/algorithm_config.py``).
Learners are PyTorch updates on the card; env runners stay CPU actors.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Callable, Dict, Optional

import numpy as np


class AlgorithmConfig:
    """Fluent builder: ``.environment(...).env_runners(...).training(...)``."""

    ALGO_CLS: Optional[type] = None

    def __init__(self):
        self.env_maker: Optional[Callable] = None
        self.num_env_runners: int = 2
        self.rollout_steps: int = 256
        self.gamma: float = 0.99
        self.lr: float = 3e-3
        self.seed: int = 0

    def environment(self, env_maker: Callable) -> "AlgorithmConfig":
        self.env_maker = env_maker
        return self

    def env_runners(
        self, num_env_runners: int, rollout_steps: Optional[int] = None
    ) -> "AlgorithmConfig":
        self.num_env_runners = num_env_runners
        if rollout_steps is not None:
            self.rollout_steps = rollout_steps
        return self

    def training(self, **kwargs) -> "AlgorithmConfig":
        for k, v in kwargs.items():
            if not hasattr(self, k) or callable(getattr(self, k)):
                # Fail loudly: a swallowed typo is a silently wrong run.
                raise ValueError(
                    f"unknown training option {k!r} for "
                    f"{type(self).__name__}"
                )
            setattr(self, k, v)
        return self

    def debugging(self, seed: int = 0) -> "AlgorithmConfig":
        self.seed = seed
        return self

    def build(self) -> "Algorithm":
        assert self.ALGO_CLS is not None, "config has no bound algorithm"
        return self.ALGO_CLS(self)


class Algorithm:
    """Train/save/restore lifecycle (Tune-Trainable-compatible: pass
    ``lambda config: algo.train()`` style loops, or use directly)."""

    def __init__(self, config: AlgorithmConfig):
        from ray_tpu_torch.core.usage import record_library_usage

        record_library_usage("rllib")
        self.config = config
        self.iteration = 0
        self.setup(config)

    # -- subclass surface ---------------------------------------------------
    def setup(self, config: AlgorithmConfig) -> None:
        raise NotImplementedError

    def training_step(self) -> Dict[str, Any]:
        raise NotImplementedError

    def get_state(self) -> Dict[str, Any]:
        return {}

    def set_state(self, state: Dict[str, Any]) -> None:
        pass

    def cleanup(self) -> None:
        pass

    # -- public lifecycle ---------------------------------------------------
    def train(self) -> Dict[str, Any]:
        self.iteration += 1
        result = self.training_step()
        result.setdefault("training_iteration", self.iteration)
        return result

    def save(self, checkpoint_dir: str) -> str:
        os.makedirs(checkpoint_dir, exist_ok=True)
        path = os.path.join(checkpoint_dir, "algorithm_state.pkl")
        state = {"iteration": self.iteration, "state": self.get_state()}
        with open(path, "wb") as f:
            pickle.dump(state, f)
        return path

    def restore(self, checkpoint_path: str) -> None:
        if os.path.isdir(checkpoint_path):
            checkpoint_path = os.path.join(
                checkpoint_path, "algorithm_state.pkl"
            )
        with open(checkpoint_path, "rb") as f:
            state = pickle.load(f)
        self.iteration = state["iteration"]
        self.set_state(state["state"])

    def stop(self) -> None:
        self.cleanup()


# --------------------------------------------------------- shared mlp module
def init_mlp(generator, sizes, out_scale: float = 0.01):
    """He-init MLP params; final layer near-zero (policy/Q head), drawn
    from ``generator`` (a ``torch.Generator``) on its device."""
    import torch

    device = generator.device
    params = {}
    for i, (fan_in, fan_out) in enumerate(zip(sizes[:-1], sizes[1:])):
        last = i == len(sizes) - 2
        scale = out_scale if last else (2.0 / fan_in) ** 0.5
        params[f"w{i}"] = torch.randn(
            (fan_in, fan_out), generator=generator, device=device
        ) * scale
        params[f"b{i}"] = torch.zeros(fan_out, dtype=torch.float32,
                                      device=device)
    return params


def mlp_forward(params, x, n_layers: int):
    import torch

    for i in range(n_layers):
        x = x @ params[f"w{i}"] + params[f"b{i}"]
        if i < n_layers - 1:
            x = torch.tanh(x)
    return x


def mlp_forward_np(params, x, n_layers: int):
    """Numpy twin for CPU env runners (no torch import in samplers)."""
    for i in range(n_layers):
        x = x @ params[f"w{i}"] + params[f"b{i}"]
        if i < n_layers - 1:
            x = np.tanh(x)
    return x

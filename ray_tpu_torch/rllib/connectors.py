"""Connector pipelines — the data-transform layer between env, module,
and learner.

Reference: ray ``rllib/connectors/`` — composable transforms applied
(env→module) before a forward pass on the env runner, (module→env) to the
forward outputs before stepping the env, and (learner) to collected
episodes before the update.  Algorithms assemble default pipelines; users
prepend/append their own connector pieces without touching algorithm code.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np


class Connector:
    """One transform.  ``ctx`` carries episode/batch metadata."""

    def __call__(self, batch: Dict[str, Any], **ctx) -> Dict[str, Any]:
        raise NotImplementedError

    def __repr__(self):
        return type(self).__name__


class ConnectorPipeline(Connector):
    def __init__(self, connectors: Optional[List[Connector]] = None):
        self.connectors = list(connectors or [])

    def __call__(self, batch, **ctx):
        for c in self.connectors:
            batch = c(batch, **ctx)
        return batch

    def prepend(self, connector: Connector) -> "ConnectorPipeline":
        self.connectors.insert(0, connector)
        return self

    def append(self, connector: Connector) -> "ConnectorPipeline":
        self.connectors.append(connector)
        return self

    def __repr__(self):
        return f"ConnectorPipeline({self.connectors})"


# ------------------------------------------------------------- env → module
class ObsToFloatBatch(Connector):
    """Stack raw observations into a float32 [B, obs] array."""

    def __call__(self, batch, **ctx):
        obs = batch.get("obs")
        arr = np.asarray(obs, np.float32)
        if arr.ndim == 1:
            arr = arr[None]
        return {**batch, "obs": arr}


class NormalizeObs(Connector):
    """Running mean/std observation filter (the MeanStdFilter connector)."""

    def __init__(self, eps: float = 1e-8):
        self.count = 0
        self.mean: Optional[np.ndarray] = None
        self.m2: Optional[np.ndarray] = None
        self.eps = eps

    def __call__(self, batch, update: bool = True, **ctx):
        obs = np.asarray(batch["obs"], np.float32)
        flat = obs.reshape(-1, obs.shape[-1])
        if update:
            for row in flat:
                self.count += 1
                if self.mean is None:
                    self.mean = row.copy()
                    self.m2 = np.zeros_like(row)
                else:
                    delta = row - self.mean
                    self.mean += delta / self.count
                    self.m2 += delta * (row - self.mean)
        if self.mean is None or self.count < 2:
            return batch
        std = np.sqrt(self.m2 / max(self.count - 1, 1)) + self.eps
        return {**batch, "obs": (obs - self.mean) / std}


# ------------------------------------------------------------- module → env
class ClipActions(Connector):
    def __init__(self, low: float = -1.0, high: float = 1.0):
        self.low, self.high = low, high

    def __call__(self, batch, **ctx):
        return {
            **batch,
            "actions": np.clip(
                np.asarray(batch["actions"]), self.low, self.high
            ),
        }


class ScaleActions(Connector):
    """Map [-1, 1] module outputs onto the env's action bounds."""

    def __init__(self, low: float, high: float):
        self.low, self.high = low, high

    def __call__(self, batch, **ctx):
        a = np.asarray(batch["actions"], np.float32)
        scaled = self.low + (a + 1.0) * 0.5 * (self.high - self.low)
        return {**batch, "actions": scaled}


# ----------------------------------------------------------------- learner
class ComputeGAE(Connector):
    """Generalized advantage estimation over a rollout batch with
    ``vf_preds``/``rewards``/``dones`` (+ bootstrap value)."""

    def __init__(self, gamma: float = 0.99, lam: float = 0.95):
        self.gamma, self.lam = gamma, lam

    def __call__(self, batch, last_value: float = 0.0, **ctx):
        rewards = np.asarray(batch["rewards"], np.float32)
        dones = np.asarray(batch["dones"], bool)
        values = np.asarray(batch["vf_preds"], np.float32)
        n = len(rewards)
        adv = np.zeros(n, np.float32)
        gae = 0.0
        next_value = last_value
        for t in range(n - 1, -1, -1):
            nonterminal = 0.0 if dones[t] else 1.0
            delta = (
                rewards[t] + self.gamma * next_value * nonterminal - values[t]
            )
            gae = delta + self.gamma * self.lam * nonterminal * gae
            adv[t] = gae
            next_value = values[t]
        return {**batch, "advantages": adv, "returns": adv + values}


class NormalizeAdvantages(Connector):
    def __call__(self, batch, **ctx):
        adv = np.asarray(batch["advantages"], np.float32)
        return {
            **batch,
            "advantages": (adv - adv.mean()) / (adv.std() + 1e-8),
        }

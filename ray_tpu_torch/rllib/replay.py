"""Replay buffers (reference: ray ``rllib/utils/replay_buffers/``)."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class ReplayBuffer:
    """Uniform ring buffer over transition dicts of parallel arrays."""

    def __init__(self, capacity: int, seed: int = 0):
        self.capacity = capacity
        self._storage: Optional[Dict[str, np.ndarray]] = None
        self._next = 0
        self._size = 0
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self._size

    def add_batch(self, batch: Dict[str, np.ndarray]) -> None:
        n = len(next(iter(batch.values())))
        if self._storage is None:
            self._storage = {
                k: np.zeros((self.capacity,) + v.shape[1:], v.dtype)
                for k, v in batch.items()
            }
        if n >= self.capacity:  # keep only the newest capacity rows
            batch = {k: v[n - self.capacity :] for k, v in batch.items()}
            n = self.capacity
        idx = (self._next + np.arange(n)) % self.capacity
        for k, v in batch.items():
            self._storage[k][idx] = v
        self._next = int((self._next + n) % self.capacity)
        self._size = min(self._size + n, self.capacity)

    def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
        idx = self._rng.integers(0, self._size, size=batch_size)
        return {k: v[idx] for k, v in self._storage.items()}


class PrioritizedReplayBuffer(ReplayBuffer):
    """Proportional prioritization (simplified PER: power-law probabilities
    over stored TD errors, importance weights returned with each sample)."""

    def __init__(self, capacity: int, alpha: float = 0.6,
                 beta: float = 0.4, seed: int = 0):
        super().__init__(capacity, seed)
        self.alpha = alpha
        self.beta = beta
        self._priorities = np.zeros(capacity, np.float64)
        self._max_priority = 1.0

    def add_batch(self, batch: Dict[str, np.ndarray]) -> None:
        n = min(len(next(iter(batch.values()))), self.capacity)
        start = self._next
        super().add_batch(batch)
        idx = (start + np.arange(n)) % self.capacity
        self._priorities[idx] = self._max_priority

    def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
        prios = self._priorities[: self._size] ** self.alpha
        probs = prios / prios.sum()
        idx = self._rng.choice(self._size, size=batch_size, p=probs)
        weights = (self._size * probs[idx]) ** (-self.beta)
        weights /= weights.max()
        out = {k: v[idx] for k, v in self._storage.items()}
        out["_weights"] = weights.astype(np.float32)
        out["_indices"] = idx.astype(np.int64)
        return out

    def update_priorities(self, indices: np.ndarray,
                          td_errors: np.ndarray) -> None:
        prios = np.abs(td_errors) + 1e-6
        self._priorities[indices] = prios
        self._max_priority = max(self._max_priority, float(prios.max()))

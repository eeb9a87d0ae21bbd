"""Offline RL data pipeline: dataset-backed transition reading.

Reference: ray ``rllib/offline/offline_data.py`` + ``offline_prelearner`` —
offline algorithms read logged transitions through the Data layer
(streaming, shuffled) instead of an env-runner replay buffer.  Sources:
a ``ray_tpu_torch.data.Dataset`` whose rows are transition dicts, a parquet/
json path, or an in-memory dict of column arrays.

Column schema (the SampleBatch subset continuous-control learners need):
``obs``, ``actions``, ``rewards``, ``next_obs``, ``dones``.
"""

from __future__ import annotations

import random
from typing import Any, Callable, Dict, Optional

import numpy as np

COLUMNS = ("obs", "actions", "rewards", "next_obs", "dones")


class OfflineData:
    """Shuffled minibatch sampler over an offline transition dataset.

    Streams blocks through ``Dataset.iter_batches`` into a local shuffle
    buffer (the reference's streaming read + local shuffle), re-iterating
    epochs forever; an in-memory dict source samples directly.
    """

    def __init__(self, source, shuffle_buffer_rows: int = 20_000,
                 seed: int = 0):
        self._rng = np.random.default_rng(seed)
        self._dataset = None
        self._columns: Optional[Dict[str, np.ndarray]] = None
        if isinstance(source, dict):
            self._columns = {
                k: np.asarray(v) for k, v in source.items()
            }
        elif isinstance(source, str):
            import ray_tpu_torch.data as rd

            self._dataset = (
                rd.read_parquet(source)
                if source.endswith(".parquet") or _has_parquet(source)
                else rd.read_json(source)
            )
        else:
            self._dataset = source  # a ray_tpu_torch.data.Dataset
        self._buffer: Dict[str, np.ndarray] = {}
        self._buffer_rows = 0
        self._shuffle_rows = shuffle_buffer_rows
        self._epoch_iter = None
        # Small datasets end up entirely in the buffer after one epoch:
        # stop streaming then (each refill is distributed work).
        self._epoch_rows = 0
        self._fully_buffered = False

    # ------------------------------------------------------------- sampling
    def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
        if self._columns is not None:
            n = len(next(iter(self._columns.values())))
            idx = self._rng.integers(0, n, size=batch_size)
            return {k: v[idx] for k, v in self._columns.items()}
        while not self._fully_buffered and self._buffer_rows < max(
            batch_size, self._shuffle_rows // 2
        ):
            if not self._fill_once():
                break
        if self._buffer_rows == 0:
            raise ValueError("offline dataset is empty")
        n = self._buffer_rows
        idx = self._rng.integers(0, n, size=min(batch_size, n))
        return {k: v[:n][idx] for k, v in self._buffer.items()}

    def _fill_once(self) -> bool:
        """Pull one block from the dataset into the shuffle buffer (bounded:
        oldest rows fall out once the buffer is full)."""
        if self._epoch_iter is None:
            self._epoch_iter = self._dataset.iter_batches(
                batch_size=4096, batch_format="numpy"
            )
        try:
            batch = next(self._epoch_iter)
        except StopIteration:
            self._epoch_iter = None  # next fill starts a new epoch
            if self._epoch_rows and self._buffer_rows >= min(
                self._epoch_rows, self._shuffle_rows
            ):
                # The whole dataset (or a full buffer's worth of it) is
                # resident: sampling needs no more distributed reads.
                self._fully_buffered = self._epoch_rows <= self._shuffle_rows
            self._epoch_rows = 0
            return self._buffer_rows > 0
        for k, v in batch.items():
            v = np.asarray(v)
            if v.dtype == object:
                # Parquet list columns (vector obs/actions) come back as
                # object arrays of arrays: re-stack to a 2-D float column.
                v = np.stack([np.asarray(x, np.float32) for x in v])
            cur = self._buffer.get(k)
            self._buffer[k] = v if cur is None else np.concatenate(
                [cur[-self._shuffle_rows:], v]
            )
        self._epoch_rows += len(next(iter(batch.values())))
        self._buffer_rows = min(
            self._shuffle_rows,
            len(next(iter(self._buffer.values()))),
        )
        # Keep the per-column trims aligned.
        for k in self._buffer:
            self._buffer[k] = self._buffer[k][-self._buffer_rows:]
        return True

    def num_rows(self) -> Optional[int]:
        if self._columns is not None:
            return len(next(iter(self._columns.values())))
        try:
            return self._dataset.count()
        except Exception:  # noqa: BLE001
            return None


def record_transitions(
    env_maker: Callable[[], Any],
    policy_fn: Callable[[np.ndarray, random.Random], np.ndarray],
    n_steps: int,
    seed: int = 0,
    parallelism: int = 4,
):
    """Roll a behavior policy and return a ``ray_tpu_torch.data.Dataset`` of
    transitions (the test/offline-generation analog of the reference's
    output writer, ``rllib/offline/json_writer.py``).

    ``policy_fn`` returns actions NORMALIZED to [-1, 1] (the module tanh
    convention the stored dataset uses); the env is stepped with the same
    action rescaled to its ``action_low``/``action_high`` units — the
    exact mapping offline learners' evaluation applies, so training and
    evaluation see identical dynamics."""
    import ray_tpu_torch.data as rd

    env = env_maker()
    lo = float(getattr(env, "action_low", -1.0))
    hi = float(getattr(env, "action_high", 1.0))
    rng = random.Random(seed)
    obs = env.reset()
    rows = []
    for _ in range(n_steps):
        action = np.asarray(policy_fn(obs, rng), np.float32).reshape(-1)
        env_action = lo + (action + 1.0) * 0.5 * (hi - lo)
        next_obs, reward, done, _info = env.step(env_action)
        rows.append(
            {
                "obs": np.asarray(obs, np.float32),
                "actions": action,
                "rewards": np.float32(reward),
                "next_obs": np.asarray(next_obs, np.float32),
                "dones": bool(done),
            }
        )
        obs = env.reset() if done else next_obs
    return rd.from_items(rows, parallelism=parallelism)


def _has_parquet(path: str) -> bool:
    import glob
    import os

    return bool(
        glob.glob(os.path.join(path, "*.parquet"))
        if os.path.isdir(path)
        else path.endswith(".parquet")
    )

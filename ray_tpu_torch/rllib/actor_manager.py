"""Fault-tolerant management of a homogeneous group of worker actors.

Reference: ``FaultTolerantActorManager`` (ray
``rllib/utils/actor_manager.py``): issue calls to all actors, harvest
results with a timeout, mark/replace the dead so one lost sampler never
stalls training.

Two harvest shapes:

- ``foreach`` — synchronous broadcast round (DQN's sampling barrier).
- ``submit`` / ``wait_any`` — one in-flight call per actor, harvest
  whichever finishes first (the IMPALA/Sebulba async core).  A dead or
  stalled actor is detected at harvest, killed, respawned (bounded by
  ``max_restarts`` so a deterministic failure cannot respawn forever),
  and handed to ``on_respawn`` so the caller can resubmit it with fresh
  state — the wait itself never stalls on the corpse.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, List, Optional, Tuple

import ray_tpu_torch

logger = logging.getLogger(__name__)


class FaultTolerantActorManager:
    def __init__(
        self,
        make_actor: Callable[[int], Any],
        num_actors: int,
        restore: bool = True,
        max_restarts: Optional[int] = None,
        on_respawn: Optional[Callable[[int, Any], None]] = None,
        name: str = "",
    ):
        """``make_actor(index) -> ActorHandle``; ``restore`` controls whether
        dead actors are transparently replaced at harvest time.
        ``max_restarts`` bounds replacements per restart WINDOW (None =
        unbounded) — callers open a new window each training step via
        ``new_restart_window()``, so occasional deaths over a long run
        are absorbed indefinitely while a fast crash-loop (a
        deterministic failure respawning within one step) still trips
        the budget; ``on_respawn(index, actor)`` runs after each
        replacement (typical use: resubmit work with current params);
        ``name`` tags the restart metric."""
        self._make_actor = make_actor
        self._restore = restore
        self._max_restarts = max_restarts
        self._on_respawn = on_respawn
        self._name = name or "actor_group"
        self.actors: List[Any] = [make_actor(i) for i in range(num_actors)]
        self.num_replacements = 0
        self._window_replacements = 0
        self._inflight: Dict[int, Any] = {}

    def __len__(self) -> int:
        return len(self.actors)

    # ---------------------------------------------------- broadcast round
    def foreach(
        self,
        method: str,
        *args,
        timeout: float = 300.0,
        **kwargs,
    ) -> List[Tuple[int, Any]]:
        """Call ``method`` on every actor; returns [(index, result)] for the
        healthy ones.  ``timeout`` bounds the whole round (a shared
        deadline, not per-actor).  Dead/stalled actors are killed and
        replaced."""
        refs = [
            (i, getattr(actor, method).remote(*args, **kwargs))
            for i, actor in enumerate(self.actors)
        ]
        return self._harvest(refs, timeout)

    def _harvest(self, refs, timeout: float) -> List[Tuple[int, Any]]:
        import time

        deadline = time.monotonic() + timeout
        out: List[Tuple[int, Any]] = []
        for i, ref in refs:
            remaining = max(0.1, deadline - time.monotonic())
            try:
                out.append((i, ray_tpu_torch.get(ref, timeout=remaining)))
            except Exception as e:  # noqa: BLE001
                self._replace(i, e)
        return out

    # ------------------------------------------------- async one-in-flight
    def submit(self, index: int, method: str, *args, **kwargs) -> None:
        """Issue ``method`` on actor ``index`` (one in-flight per slot —
        a second submit before harvest replaces the tracked ref)."""
        self._inflight[index] = getattr(
            self.actors[index], method
        ).remote(*args, **kwargs)

    def wait_any(self, timeout: float = 300.0) -> Tuple[int, Any]:
        """Block until ANY in-flight call completes successfully; returns
        ``(index, result)`` with the slot's in-flight entry cleared.

        A call that completed with an error means a dead/failed actor:
        it is killed, respawned (bounded), ``on_respawn`` runs, and the
        wait continues over the remaining in-flight set — one corpse
        never stalls the harvest.  Raises TimeoutError if nothing
        completes before the deadline and RuntimeError once the restart
        budget is exhausted."""
        import time

        deadline = time.monotonic() + timeout
        while True:
            if not self._inflight:
                raise RuntimeError(
                    f"{self._name}: wait_any with no in-flight calls "
                    "(submit work first, or every actor died with "
                    "on_respawn not resubmitting)"
                )
            idx_by_ref = {ref: i for i, ref in self._inflight.items()}
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(
                    f"{self._name}: no actor completed within {timeout:.0f}s"
                )
            ready, _ = ray_tpu_torch.wait(
                list(idx_by_ref), num_returns=1, timeout=remaining
            )
            if not ready:
                raise TimeoutError(
                    f"{self._name}: no actor completed within {timeout:.0f}s"
                )
            i = idx_by_ref[ready[0]]
            try:
                result = ray_tpu_torch.get(ready[0], timeout=60)
            except Exception as e:  # noqa: BLE001 — dead actor: replace
                del self._inflight[i]
                self._replace(i, e)
                continue
            del self._inflight[i]
            return i, result

    def inflight_count(self) -> int:
        return len(self._inflight)

    def new_restart_window(self) -> None:
        """Open a fresh restart-budget window (call at the top of each
        training step): ``max_restarts`` bounds respawns per window,
        not per group lifetime."""
        self._window_replacements = 0

    # ------------------------------------------------------- replacement
    def _replace(self, i: int, error: Exception) -> None:
        logger.warning(
            "%s actor %d failed (%s)%s", self._name, i, error,
            "; replacing" if self._restore else "",
        )
        if not self._restore:
            return
        # Kill the old handle FIRST — even on the budget-exhausted path:
        # a stalled (not dead) actor would otherwise leak its process +
        # resource slot exactly when the caller is about to give up.
        try:
            ray_tpu_torch.kill(self.actors[i])
        except Exception:
            pass
        if (
            self._max_restarts is not None
            and self._window_replacements >= self._max_restarts
        ):
            raise RuntimeError(
                f"{self._name}: actor {i} failed and the restart budget "
                f"({self._max_restarts} per window) is exhausted; "
                f"last error: {error}"
            ) from error
        self.actors[i] = self._make_actor(i)
        self.num_replacements += 1
        self._window_replacements += 1
        from ray_tpu_torch.util import flight_recorder

        flight_recorder.record_rl_runner_restart(self._name)
        if self._on_respawn is not None:
            self._on_respawn(i, self.actors[i])

    def kill_all(self) -> None:
        for actor in self.actors:
            try:
                ray_tpu_torch.kill(actor)
            except Exception:
                pass
        self.actors = []
        self._inflight = {}

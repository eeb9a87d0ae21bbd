"""Long-poll push of serve control state to handles and proxies.

Reference: ray ``python/ray/serve/_private/long_poll.py:252`` —
``LongPollHost`` on the controller holds per-key snapshot ids; clients
issue a blocking ``listen_for_change({key: last_seen_id})`` RPC that
returns as soon as any key advances.  Route tables and replica lists
propagate in one RPC latency instead of a poll period, and a killed
replica's removal is *pushed* to every router.

Host side lives in ``ServeController`` (``listen_for_change`` +
``_publish_state``); this module is the client: one daemon thread per
process multiplexes every handle/proxy subscription in that process over
a single outstanding listen call.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, Optional, Tuple

from ..util.debug_locks import make_lock

logger = logging.getLogger(__name__)

LISTEN_TIMEOUT_S = 30.0


class LongPollClient:
    """Per-process multiplexing client for the controller's long-poll host."""

    def __init__(self, controller_name: str):
        self._controller_name = controller_name
        self._known: Dict[Tuple, Tuple[int, Any]] = {}
        self._keys: set = set()
        self._lock = make_lock("serve.long_poll.client")
        self._thread: Optional[threading.Thread] = None
        self._stopped = False

    def register(self, key: Tuple) -> None:
        with self._lock:
            if key in self._keys:
                return
            self._keys.add(key)
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._listen_loop, daemon=True,
                    name="serve-long-poll",
                )
                self._thread.start()

    def get(self, key: Tuple):
        """Latest pushed snapshot for ``key`` (None until the first push)."""
        entry = self._known.get(key)
        return entry[1] if entry is not None else None

    def stop(self) -> None:
        self._stopped = True

    # ------------------------------------------------------------- internals
    def _listen_loop(self) -> None:
        import ray_tpu_torch

        controller = None
        while not self._stopped:
            try:
                if controller is None:
                    controller = ray_tpu_torch.get_actor(self._controller_name)
                with self._lock:
                    keys_to_ids = {
                        k: self._known.get(k, (0, None))[0]
                        for k in self._keys
                    }
                updates = ray_tpu_torch.get(
                    controller.listen_for_change.remote(
                        keys_to_ids, LISTEN_TIMEOUT_S
                    ),
                    timeout=LISTEN_TIMEOUT_S + 15,
                )
                if updates:
                    with self._lock:
                        self._known.update(updates)
            except Exception as e:  # noqa: BLE001 — controller restart etc.
                if self._stopped:
                    return
                logger.debug("long-poll listen failed (%s); retrying", e)
                controller = None
                time.sleep(0.5)


_client: Optional[LongPollClient] = None
_client_lock = make_lock("serve.long_poll.singleton")


def long_poll_client() -> LongPollClient:
    """Process-wide client (one listen loop no matter how many handles)."""
    global _client
    with _client_lock:
        if _client is None or _client._stopped:
            from .controller import CONTROLLER_NAME

            _client = LongPollClient(CONTROLLER_NAME)
        return _client


def reset_client() -> None:
    """Drop the process client (serve shutdown / tests)."""
    global _client
    with _client_lock:
        if _client is not None:
            _client.stop()
            _client = None

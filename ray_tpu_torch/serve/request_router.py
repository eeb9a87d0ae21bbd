"""Pluggable replica routing policies for DeploymentHandles.

Reference: ray ``python/ray/serve/_private/request_router/pow_2_router.py``
(the default) and ``python/ray/llm/_internal/serve/routing_policies/
prefix_aware/`` (LLM serving: requests sharing a prompt prefix go to the
replica whose KV cache is warm for it, unless that replica is overloaded).
"""

from __future__ import annotations

import random
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch


class ReplicaProbeError(Exception):
    """A replica queue probe failed — the handle force-refreshes its
    replica list and retries the route (a dead replica may be cached)."""


class RequestRouter:
    """Chooses a replica for one request.  May raise ReplicaProbeError to
    ask the handle for a fresh replica list."""

    def choose(self, replicas: List, args, kwargs):  # pragma: no cover
        raise NotImplementedError


class PowerOfTwoChoicesRouter(RequestRouter):
    """Probe two random replicas' queue depths, pick the shorter
    (reference ``pow_2_router.py:52``).  The ONE implementation of the
    default policy — DeploymentHandle delegates here too."""

    def choose(self, replicas: List, args, kwargs):
        if len(replicas) == 1:
            return replicas[0]
        a, b = random.sample(replicas, 2)
        try:
            qa, qb = ray_tpu_torch.get(
                [a.queue_len.remote(), b.queue_len.remote()], timeout=5
            )
        except Exception as e:
            raise ReplicaProbeError(str(e)) from e
        return a if qa <= qb else b


def _default_prompt_extractor(args, kwargs) -> Optional[str]:
    """Pull the prompt out of an OpenAI-style request body (the shapes the
    LLM app's endpoints receive)."""
    body = args[0] if args else kwargs.get("body")
    if isinstance(body, str):
        return body
    if isinstance(body, dict):
        if isinstance(body.get("prompt"), str):
            return body["prompt"]
        msgs = body.get("messages")
        if isinstance(msgs, list) and msgs:
            return "\x1e".join(
                str(m.get("content", "")) for m in msgs if isinstance(m, dict)
            )
    return None


class PrefixAwareRouter(RequestRouter):
    """Prefix-affinity routing with load protection.

    The first ``prefix_chars`` of the prompt key an affinity table mapping
    prefix → replica.  A hit routes back to the warm replica unless its
    queue is more than ``imbalance_factor`` deeper than the shortest
    replica's (then the request falls back to power-of-two and the prefix
    re-homes) — the reference's balanced-prefix-aware policy."""

    def __init__(
        self,
        prefix_chars: int = 64,
        imbalance_factor: float = 3.0,
        max_entries: int = 4096,
        prompt_extractor: Callable = _default_prompt_extractor,
    ):
        self.prefix_chars = prefix_chars
        self.imbalance_factor = imbalance_factor
        self.max_entries = max_entries
        self.extract = prompt_extractor
        self._affinity: Dict[str, Any] = {}  # prefix -> actor id
        self._fallback = PowerOfTwoChoicesRouter()
        # Cache-hit accounting: a "hit" is a warm-affinity route actually
        # taken (the request lands where its prefix KV is); re-homes and
        # cold prefixes are misses.  Published to the
        # ray_tpu_llm_prefix_cache_* counters under site="router".
        self.hits = 0
        self.misses = 0
        # Probing every replica per warm-prefix hit is O(n) RPCs on the hot
        # path; a short TTL bounds it to O(n) per interval (the reference's
        # bounded-probe design).  Queue depths staler than ~100 ms only
        # delay the re-home decision by one interval.
        self._lens_ttl_s = 0.1
        self._lens_cache: tuple = (0.0, None, None)  # (ts, replica_key, lens)

    def _queue_lens(self, replicas):
        import time as _time

        key = tuple(r._actor_id for r in replicas)
        ts, cached_key, lens = self._lens_cache
        now = _time.monotonic()
        if lens is not None and cached_key == key and now - ts < self._lens_ttl_s:
            return lens
        try:
            lens = ray_tpu_torch.get(
                [r.queue_len.remote() for r in replicas], timeout=5
            )
        except Exception:
            return None
        self._lens_cache = (now, key, lens)
        return lens

    def _account(self, hit: bool):
        if hit:
            self.hits += 1
        else:
            self.misses += 1
        try:
            from ray_tpu_torch.util import flight_recorder

            flight_recorder.record_llm_prefix_lookup("router", hit)
        except Exception:  # raylint: waive[RTL003] accounting must not fail routing
            pass

    def stats(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses,
                "entries": len(self._affinity)}

    def choose(self, replicas: List, args, kwargs):
        prompt = self.extract(args, kwargs)
        if prompt is None or len(replicas) == 1:
            return (
                replicas[0]
                if len(replicas) == 1
                else self._fallback.choose(replicas, args, kwargs)
            )
        prefix = prompt[: self.prefix_chars]
        by_id = {r._actor_id: r for r in replicas}
        warm_id = self._affinity.get(prefix)
        warm = by_id.get(warm_id)
        chosen = None
        if warm is not None:
            lens = self._queue_lens(replicas)
            if lens is None:
                # A probe failure may mean the warm replica is dead —
                # surface it so the handle force-refreshes and retries
                # (returning warm here would poison the hot prefix).
                raise ReplicaProbeError("queue probes failed")
            warm_len = lens[replicas.index(warm)]
            min_len = min(lens)
            if warm_len <= max(self.imbalance_factor * max(min_len, 1), 1):
                self._account(True)
                return warm
            # Overloaded warm replica: we already hold every queue length —
            # take the shortest instead of re-probing two random ones.
            chosen = replicas[lens.index(min_len)]
        if chosen is None:
            chosen = self._fallback.choose(replicas, args, kwargs)
        self._account(False)
        if len(self._affinity) >= self.max_entries:
            self._affinity.pop(next(iter(self._affinity)))
        self._affinity[prefix] = chosen._actor_id
        return chosen

"""Prefill/decode disaggregated serving: port of ``ray_tpu/llm/disagg.py``.

Prefill replicas compute a prompt's KV cache, decode replicas continue
token generation, and the KV pages move from one to the other without
re-running the prompt.  The pages ride the port's device-object store
(``collective.device_objects``): the prefill engine keeps its
``[L, 1, Hkv, n, D]`` pages resident on the card and returns ``DeviceRef``
metadata, and the decode replica fetches them (a local hit: the tensors
themselves, no copy) and splices them into its batch cache, one
device-to-device copy.

This module ports the in-process half.  What waits for the runtime's port
(ROADMAP A3): replicas as actors (``.remote()`` and ``ray_tpu.get`` in the
router's actor branches, so ``DisaggRouter`` refuses actor handles), the
remote fetch of pages another process owns, and the flight-recorder and
tracing hooks.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Dict, List, Optional

import torch

from ..collective.device_objects import device_object_store
from ..device import DeviceLike, resolve_device
from ..models import model_family
from ..models.gpt2_decode import sample_logits
from .continuous_batching import full_prompt_key, prefix_block_keys
from .engine import EngineConfig, SamplingParams, TorchLLMEngine, encode_prompt
from .tokenizer import ByteTokenizer


class PrefillEngine:
    """Prefill-only engine: prompt -> (first token, resident KV pages).

    No batch slots, no decode step: one eager prefill over the prompt's own
    length, as ``TorchLLMEngine`` prefills (causal attention gives the same
    values below the length, so the pages equal the JAX engine's first
    ``n`` rows).  The pages are published to the device-object store and
    ownership transfers to the fetching decode replica.  Callers on several
    threads prefill at once, each on its own tensors.  A prefill returns
    after its logits reach the host, so its pages are complete on the card
    before any other stream reads them.
    """

    def __init__(self, cfg: EngineConfig, tokenizer=None,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.tokenizer = tokenizer or ByteTokenizer()
        self.family = model_family(cfg.model)
        if cfg.param_loader is not None:
            self.params = cfg.param_loader()
        else:
            gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
            self.params = self.family.init(gen, cfg.model, self.device)
        self._gen = torch.Generator(device=self.device).manual_seed(
            cfg.seed + 1)

    def prefill(
        self, prompt: str, params: Optional[SamplingParams] = None
    ) -> Dict[str, Any]:
        """Run the prompt; return metadata + KV ``DeviceRef``s.

        The caller (router) hands the dict to a decode replica, which
        fetches and frees the refs: the pages live here only until that
        single consumer collects them."""
        params = params or SamplingParams()
        token_ids = encode_prompt(self.tokenizer, prompt, self.cfg.max_seq_len)
        n = len(token_ids)
        mcfg = self.cfg.model
        cache = self.family.init_cache(mcfg, 1, n, self.device)
        tokens = torch.tensor([token_ids], dtype=torch.long,
                              device=self.device)
        lengths = torch.tensor([n], device=self.device)
        logits, cache = self.family.prefill(self.params, tokens, lengths,
                                            cache, mcfg)
        host_logits = logits[0].cpu()
        if params.temperature == 0.0:
            first = int(torch.argmax(host_logits))
        else:
            first = int(sample_logits(logits, self._gen, params.temperature,
                                      params.top_k, params.top_p)[0])
        store = device_object_store()
        return {
            "prompt_len": n,
            "first_token": first,
            "sampling": params,
            # The prompt's token ids + last-position logits ride along so
            # the decode side can index its prefix KV cache and re-sample
            # the first token exactly on a cache hit.
            "token_ids": list(token_ids),
            "logits": host_logits,
            "k_ref": store.put(cache["k"]),
            "v_ref": store.put(cache["v"]),
        }


def fetch_prefill_kv(meta: Dict[str, Any]):
    """Collect (and free) the KV pages a ``PrefillEngine`` published for one
    prompt: the consumer side of the handoff, shared by every decode role."""
    store = device_object_store()
    k = store.fetch(meta["k_ref"])
    v = store.fetch(meta["v_ref"])
    store.free(meta["k_ref"])
    store.free(meta["v_ref"])
    return k, v


class DecodeReplica:
    """Decode-role replica over ``TorchLLMEngine``, whose
    ``add_request_from_kv`` owns the disaggregated admission; the engine's
    prefill never runs here."""

    def __init__(self, engine_cfg: Optional[EngineConfig] = None,
                 device: DeviceLike = None):
        self.engine = TorchLLMEngine(engine_cfg or EngineConfig(),
                                     device=device)

    def add_from_kv(self, meta: Dict[str, Any]) -> int:
        """Fetch the KV pages from the prefill owner and enqueue."""
        k, v = fetch_prefill_kv(meta)
        return self.engine.add_request_from_kv(meta, k, v)

    def run(self, request_id: int, timeout_s: float = 300.0) -> dict:
        """Decode until this request finishes; returns its result.
        Concurrent callers step the shared engine, so their requests share
        decode steps."""
        deadline = time.monotonic() + timeout_s
        while True:
            with self.engine._step_lock:
                done = self.engine._finished.pop(request_id, None)
                if done is None:
                    self.engine.step()
                    done = self.engine._finished.pop(request_id, None)
            if done is not None:
                return done
            if time.monotonic() > deadline:
                self.engine.cancel_request(request_id)
                raise TimeoutError(f"decode of request {request_id} timed out")

    def run_stream(self, request_id: int, timeout_s: float = 300.0):
        """Stream an adopted request's text deltas as they decode."""
        yield from self.engine.stream_request(request_id, timeout_s)


class PrefillReplica:
    """Prefill-role replica."""

    def __init__(self, engine_cfg: Optional[EngineConfig] = None,
                 device: DeviceLike = None):
        self.engine = PrefillEngine(engine_cfg or EngineConfig(),
                                    device=device)

    def prefill(
        self, prompt: str, params: Optional[SamplingParams] = None
    ) -> Dict[str, Any]:
        return self.engine.prefill(prompt, params)


def _is_actor(h) -> bool:
    return hasattr(getattr(h, "prefill", None), "remote") or hasattr(
        getattr(h, "add_from_kv", None), "remote"
    )


class DisaggRouter:
    """Routes new requests to prefill replicas and continuations to decode
    replicas, all plain local instances (actor handles wait for the
    runtime's port, ROADMAP A3, and are refused).

    **Prefix-cache-aware decode routing** (on by default): the router
    hashes the prompt into block-chain keys and routes a request sharing a
    prefix with earlier traffic to the decode replica those requests landed
    on.  On a full-coverage hit a batched decode replica admits straight
    from its prefix cache (``try_add_cached``) and the prefill hop is
    skipped."""

    def __init__(self, prefill_replicas: List[Any], decode_replicas: List[Any],
                 prefix_routing: bool = True,
                 prefix_block_tokens: int = 16,
                 max_affinity_entries: int = 4096,
                 imbalance_factor: float = 2.0):
        if not prefill_replicas or not decode_replicas:
            raise ValueError("need at least one prefill and one decode replica")
        if any(_is_actor(r) for r in [*prefill_replicas, *decode_replicas]):
            raise NotImplementedError(
                "DisaggRouter over actor handles needs the runtime's port "
                "(ROADMAP A3); pass local replica instances"
            )
        self.prefill_replicas = list(prefill_replicas)
        self.decode_replicas = list(decode_replicas)
        self._p_rr = itertools.cycle(range(len(self.prefill_replicas)))
        self._d_rr = itertools.cycle(range(len(self.decode_replicas)))
        self.prefix_routing = prefix_routing
        self.prefix_block_tokens = prefix_block_tokens
        self.max_affinity_entries = max_affinity_entries
        self._tokenizer = ByteTokenizer()
        # block-chain key -> decode replica index (insertion-ordered LRU),
        # lock-guarded: client threads route at once.
        self._affinity: Dict[bytes, int] = {}
        self._affinity_lock = threading.Lock()
        # Load guard: a warm replica whose queue is imbalance_factor deeper
        # than the lightest replica's loses a block-level affinity request.
        # Loads are TTL-cached.
        self.imbalance_factor = imbalance_factor
        self._loads_ttl_s = 0.1
        self._loads_cache: tuple = (0.0, None)  # (ts, loads | None)
        self.router_hits = 0
        self.router_misses = 0

    # ------------------------------------------------- prefix-aware routing
    def _select_decode(self, prompt: str):
        """Pick the decode replica for ``prompt``: deepest block-chain
        affinity match wins, round-robin otherwise.  Returns (replica,
        affinity_hit) and re-homes the prompt's chain onto the choice."""
        if not self.prefix_routing:
            return self.decode_replicas[next(self._d_rr)], False
        token_ids = self._tokenizer.encode(prompt)
        # Block chain + the exact-prompt key: short prompts (< one block)
        # produce no chain keys, and exact repeats are the most common
        # serving pattern: the full key gives both affinity.
        keys = prefix_block_keys(token_ids, self.prefix_block_tokens)
        keys.append(full_prompt_key(token_ids, self.prefix_block_tokens))
        with self._affinity_lock:
            idx = None
            exact = False
            for j in range(len(keys) - 1, -1, -1):  # deepest first
                idx = self._affinity.get(keys[j])
                if idx is not None and idx < len(self.decode_replicas):
                    exact = j == len(keys) - 1  # the exact-prompt key
                    break
                idx = None
        if idx is not None and not exact and len(self.decode_replicas) > 1:
            # Imbalance guard (outside the affinity lock): a block-level
            # match is locality advice; an exact-prompt match is exempt,
            # since that replica holds this prompt's full KV.
            loads = self._decode_loads()
            if loads is not None:
                warm, lightest = loads[idx], min(loads)
                if warm > self.imbalance_factor * max(lightest, 1):
                    idx = None
        hit = idx is not None
        with self._affinity_lock:
            if idx is None:
                idx = next(self._d_rr)
            if hit:
                self.router_hits += 1
            else:
                self.router_misses += 1
            for key in keys:
                self._affinity[key] = idx
            while len(self._affinity) > self.max_affinity_entries:
                self._affinity.pop(next(iter(self._affinity)))
        return self.decode_replicas[idx], hit

    def _decode_loads(self) -> Optional[List[int]]:
        """Per-decode-replica load (queued + decoding sequences) from the
        batched replicas' ``stats()``, TTL-cached; None when unavailable
        (plain replicas have no stats): the guard then stands down."""
        ts, loads = self._loads_cache
        now = time.monotonic()
        if ts > 0 and now - ts < self._loads_ttl_s:
            return loads
        try:
            stats = [d.stats() for d in self.decode_replicas]
            loads = [
                int(s["occupancy"]) + int(s["queue_depth"]) for s in stats
            ]
        except (AttributeError, KeyError, TypeError):
            loads = None
        self._loads_cache = (now, loads)
        return loads

    def _try_cached(self, d, prompt: str, params):
        """Prefix-cache fast path where the replica has one."""
        if not hasattr(d, "try_add_cached"):
            return None
        return d.try_add_cached(prompt, params)

    def _admit(self, prompt: str, params, d) -> int:
        """Admit ``prompt`` on decode replica ``d``: prefix-cache fast path
        first (no prefill hop), else prefill + KV handoff.  Returns the
        replica-local request id."""
        rid = self._try_cached(d, prompt, params)
        if rid is not None:
            return rid
        p = self.prefill_replicas[next(self._p_rr)]
        return d.add_from_kv(p.prefill(prompt, params))

    def generate(
        self,
        prompt: str,
        params: Optional[SamplingParams] = None,
        timeout_s: float = 300.0,
    ) -> dict:
        d, _ = self._select_decode(prompt)
        rid = self._admit(prompt, params, d)
        return d.run(rid, timeout_s=timeout_s)

    def stream(self, prompt: str,
               params: Optional[SamplingParams] = None,
               timeout_s: float = 300.0):
        """Streaming generate: admit (prefix cache or prefill + KV handoff),
        then yield the decode replica's text deltas."""
        d, _ = self._select_decode(prompt)
        rid = self._admit(prompt, params, d)
        yield from d.run_stream(rid, timeout_s=timeout_s)

    def generate_many(
        self,
        prompts: List[str],
        params: Optional[SamplingParams] = None,
        timeout_s: float = 300.0,
    ) -> List[dict]:
        """Every prompt through ``generate``, in order (the local branch of
        the JAX router's pipelined fan-out)."""
        return [self.generate(p, params, timeout_s) for p in prompts]

"""Prefill/decode disaggregated serving: port of ``ray_tpu/llm/disagg.py``.

Prefill replicas compute a prompt's KV cache, decode replicas continue
token generation, and the KV pages move from one to the other without
re-running the prompt.  The pages ride the port's device-object store
(``collective.device_objects``): the prefill engine keeps its
``[L, 1, Hkv, n, D]`` pages resident on its card and returns ``DeviceRef``
metadata, and the decode replica fetches them and splices them into its
batch cache.  In one process the fetch is a local hit (the tensors
themselves, no copy); from another process it is the owner's
``device_fetch`` RPC, one copy to the host there and one onto the decode
replica's card here, the same bytes.

Replicas are local instances or actors (``ray_tpu_torch.remote`` over
``PrefillReplica``, ``DecodeReplica`` or
``continuous_batching.BatchedDecodeReplica``, each with its own GPU lease).
``DisaggRouter`` takes either: over actors it fuses admission and
completion into one round trip where the decode replica supports it, and
``generate_many`` pipelines its prefills across the pool.  Each
``generate`` is one ``llm.disagg.generate`` span whose actor calls inherit
the trace, so router, prefill and decode export as one stitched trace.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Dict, List, Optional

import torch

import ray_tpu_torch

from ..collective.device_objects import device_object_store
from ..device import DeviceLike, resolve_device
from ..models import model_family
from ..models.gpt2_decode import sample_logits
from ..ops.attention import flash_attention
from .continuous_batching import full_prompt_key, prefix_block_keys
from .engine import EngineConfig, SamplingParams, TorchLLMEngine, encode_prompt
from ..util import flight_recorder, tracing
from .tokenizer import ByteTokenizer


# Prompt-length buckets of ``PrefillEngine``: a prompt runs padded to the
# first edge at or above its length.  Past the first edge the padding is
# under 2x the prompt; below it a prefill reads the weights whatever its
# length, so one 64-row bucket serves them all.
PREFILL_EDGES = (64, 128, 256, 512, 768, 1024)


def prefill_buckets(max_seq_len: int) -> List[int]:
    """The prefill buckets for prompts of up to ``max_seq_len`` tokens:
    ``PREFILL_EDGES``, doubled on past 1024, cut at ``max_seq_len``,
    which is always the last."""
    edges = list(PREFILL_EDGES)
    while edges[-1] < max_seq_len:
        edges.append(2 * edges[-1])
    return [e for e in edges if e < max_seq_len] + [max_seq_len]


class PrefillEngine:
    """Prefill-only engine: prompt -> (first token, resident KV pages).

    No batch slots, no decode step.  A prompt of ``n`` tokens runs right-
    padded to its bucket (``prefill_buckets``) over static inputs and one
    static cache; causal attention keeps rows ``[0, n)`` those of an
    unpadded prefill, and those rows are cloned out as the prompt's
    ``[L, 1, Hkv, n, D]`` pages (the JAX engine's first ``n`` rows).  On
    the card each bucket's prefill is a CUDA graph captured in the
    constructor, so a prefill is one replay; on the CPU the same padded
    prefill runs eagerly.  The pages are published to the device-object
    store and ownership transfers to the fetching decode replica.

    Callers on several threads prefill at once: each takes the engine's
    lock for its copy in, replay and copies out, and holds it until its
    logits reach the host, so its pages are complete on the card before
    any other stream reads them.
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
        # Prefills running now; kept while the span recorder is on.
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self.buckets = prefill_buckets(cfg.max_seq_len)
        top = self.buckets[-1]
        # Static inputs: [0] the prompt's length, [1:] its right-padded
        # tokens, filled by one copy a prefill.
        self._inputs = torch.zeros(1 + top, dtype=torch.long,
                                   device=self.device)
        self._cache = self.family.init_cache(cfg.model, 1, top, self.device)
        self._lock = threading.Lock()
        # Bucket -> its captured prefill and the graph's static logits.
        self._graphs: Dict[int, torch.cuda.CUDAGraph] = {}
        self._logits: Dict[int, torch.Tensor] = {}
        self.capture_s: Dict[int, float] = {}
        # Flash-forward launches each graph holds, counted at capture: a
        # replay launches them again, and the wrapper's counter, which
        # ticks on the host, sees only the capture.
        self._flash_per_replay: Dict[int, int] = {}
        self.counters = {"graph_prefills": 0, "eager_prefills": 0,
                         "padded_tokens": 0, "prompt_tokens": 0,
                         "graph_flash_launches": 0}
        if self.device.type == "cuda":
            self._capture()

    def _run(self, bucket: int) -> torch.Tensor:
        """The padded prefill of ``bucket`` rows over the static inputs:
        the last position's logits [1, V] f32, rows [0, bucket) of the
        static cache written."""
        tokens = self._inputs[None, 1:1 + bucket]
        return self.family.prefill(self.params, tokens, self._inputs[:1],
                                   self._cache, self.cfg.model)[0]

    def _capture(self) -> None:
        """Capture every bucket's prefill, each after one warm-up run, on a
        stream of the engine's own, into one memory pool: the graphs never
        run at once, so they may share it."""
        stream = torch.cuda.Stream(self.device)
        pool = torch.cuda.graph_pool_handle()
        current = torch.cuda.current_stream(self.device)
        self._inputs[0] = 1  # a length every bucket holds
        for b in self.buckets:
            t0 = time.perf_counter()
            stream.wait_stream(current)
            with torch.cuda.stream(stream):
                self._run(b)
            current.wait_stream(stream)
            graph = torch.cuda.CUDAGraph()
            before = flash_attention.launches
            # thread_local: other threads may use the card meanwhile.
            with torch.cuda.graph(graph, pool=pool, stream=stream,
                                  capture_error_mode="thread_local"):
                logits = self._run(b)
            self._flash_per_replay[b] = flash_attention.launches - before
            self._graphs[b], self._logits[b] = graph, logits
            torch.cuda.synchronize(self.device)
            self.capture_s[b] = time.perf_counter() - t0

    def bucket_of(self, n: int) -> int:
        """The bucket a prompt of ``n`` tokens runs in."""
        return next(b for b in self.buckets if b >= n)

    def run_ids(self, token_ids: List[int], marks: Optional[list] = None):
        """Prefill ``token_ids`` (at most ``max_seq_len`` of them):
        (last-position logits [1, V] f32, the same on the host as [V], k and
        v pages [L, 1, Hkv, n, D], the bucket replayed or 0 where the
        prefill ran eagerly), each a tensor of the caller's own.  ``marks``
        gets (``time.time_ns()``, ``time.thread_time_ns()``) once the work
        is enqueued, before the wait for the logits."""
        n = len(token_ids)
        b = self.bucket_of(n)
        row = torch.zeros(1 + b, dtype=torch.long)
        row[0] = n
        row[1:1 + n] = torch.tensor(token_ids, dtype=torch.long)
        with self._lock:
            self._inputs[:1 + b].copy_(row)
            graph = self._graphs.get(b)
            if graph is None:
                logits = self._run(b)
            else:
                graph.replay()
                logits = self._logits[b]
            logits = logits.clone()
            k = self._cache["k"][:, :, :, :n].clone()
            v = self._cache["v"][:, :, :, :n].clone()
            if marks is not None:
                marks.append((time.time_ns(), time.thread_time_ns()))
            host_logits = logits[0].cpu()
            c = self.counters
            c["padded_tokens"] += b
            c["prompt_tokens"] += n
            if graph is None:
                c["eager_prefills"] += 1
            else:
                c["graph_prefills"] += 1
                c["graph_flash_launches"] += self._flash_per_replay[b]
        return logits, host_logits, k, v, (0 if graph is None else b)

    def stats(self) -> Dict[str, Any]:
        """What the engine ran: ``graph_prefills`` and ``eager_prefills``;
        ``prompt_tokens`` and ``padded_tokens`` (the rows the padded
        prefills ran); ``graph_flash_launches``, the flash forwards the
        replays launched; and ``capture_s`` by bucket."""
        return {**self.counters, "capture_s": dict(self.capture_s)}

    def prefill(
        self, prompt: str, params: Optional[SamplingParams] = None
    ) -> Dict[str, Any]:
        """Run the prompt; return metadata + KV ``DeviceRef``s.

        The caller (router) hands the dict to a decode replica, which
        fetches and frees the refs: the pages live here only until that
        single consumer collects them.  With the span recorder on, one
        ``llm.prefill`` span holding ``llm.prefill.launch`` and
        ``llm.prefill.sync``."""
        if tracing.active_recorder is None:
            return self._prefill(prompt, params, None)
        with self._inflight_lock:
            self._inflight += 1
            inflight = self._inflight
        try:
            with tracing.start_span("llm.prefill",
                                    {"inflight": inflight}) as span:
                return self._prefill(prompt, params, span)
        finally:
            with self._inflight_lock:
                self._inflight -= 1

    def _prefill(self, prompt: str, params: Optional[SamplingParams],
                 span: Optional[tracing.Span]) -> Dict[str, Any]:
        marks = None if span is None else []
        t0, cpu0 = time.time_ns(), time.thread_time_ns()
        params = params or SamplingParams()
        token_ids = encode_prompt(self.tokenizer, prompt, self.cfg.max_seq_len)
        n = len(token_ids)
        logits, host_logits, k, v, bucket = self.run_ids(token_ids, marks)
        if span is not None:
            t2 = time.time_ns()
            (t1, cpu1), = marks
            span.set_attribute("tokens", n)
            span.set_attribute("bucket", bucket)
            rec = tracing.active_recorder
            if rec is not None:
                ctx = (span.trace_id, span.span_id)
                rec.add("llm.prefill.launch", t0, t1,
                        {"cpu_ns": cpu1 - cpu0}, ctx)
                rec.add("llm.prefill.sync", t1, t2, None, ctx)
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
            "k_ref": store.put(k),
            "v_ref": store.put(v),
        }


def _missing_method(e: BaseException, name: str) -> bool:
    """True iff a remote error is the executor's missing-method
    AttributeError for ``name``, matched on its exact signature: a failure
    raised inside the method also carries the method's name, and
    swallowing it would demote a batched replica to the plain path."""
    return f"has no attribute '{name}'" in str(e)


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
        """Stream an adopted request's text deltas as they decode.  Each
        stream records its TTFT and inter-token gaps
        (``deployment="llm_decode"``)."""
        tele = flight_recorder.StreamTelemetry("llm_decode", "decode")
        outcome = "ok"
        try:
            for delta in self.engine.stream_request(request_id, timeout_s):
                tele.tick()
                yield delta
        except BaseException:
            outcome = "error"
            raise
        finally:
            tele.done(outcome)


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


class DisaggRouter:
    """Routes new requests to prefill replicas and continuations to decode
    replicas (the reference's prefill_decode serving-pattern router).

    Works with actor handles (``.remote()``/``ray_tpu_torch.get``) or plain
    local instances (ducks on the presence of ``.prefill.remote``).

    **Prefix-cache-aware decode routing** (on by default): the router
    hashes the prompt into block-chain keys
    (``llm.continuous_batching.prefix_block_keys``) and routes a request
    sharing a prefix with earlier traffic to the decode replica those
    requests landed on — the replica already holding the prefix KV
    blocks.  On a full-coverage hit the decode replica admits straight
    from its prefix cache (``try_add_cached``) and the prefill hop is
    skipped entirely; router affinity decisions and engine reuse are
    accounted separately (``site="router"`` vs ``site="engine"`` on the
    ``ray_tpu_llm_prefix_cache_*`` counters)."""

    def __init__(self, prefill_replicas: List[Any], decode_replicas: List[Any],
                 prefix_routing: bool = True,
                 prefix_block_tokens: int = 16,
                 max_affinity_entries: int = 4096,
                 imbalance_factor: float = 2.0):
        if not prefill_replicas or not decode_replicas:
            raise ValueError("need at least one prefill and one decode replica")
        self.prefill_replicas = list(prefill_replicas)
        self.decode_replicas = list(decode_replicas)
        self._p_rr = itertools.cycle(range(len(self.prefill_replicas)))
        self._d_rr = itertools.cycle(range(len(self.decode_replicas)))
        self.prefix_routing = prefix_routing
        # replica id() -> supports try_add_cached (None = not yet probed).
        # Actor handles synthesize any method name, so support is probed
        # lazily per replica on first use (_try_cached); affinity routing
        # itself is safe for plain DecodeReplicas.
        self._cached_support: Dict[int, Optional[bool]] = {}
        self.prefix_block_tokens = prefix_block_tokens
        self.max_affinity_entries = max_affinity_entries
        self._tokenizer = ByteTokenizer()
        # block-chain key -> decode replica index (insertion-ordered LRU).
        # Routers live inside serve replicas where concurrent executor
        # threads route at once: the map (and its eviction iterator) is
        # lock-guarded — lookups/inserts only, never a blocking call.
        self._affinity: Dict[bytes, int] = {}
        self._affinity_lock = threading.Lock()
        # Load guard (same semantics as serve.PrefixAwareRouter): a warm
        # replica whose queue is imbalance_factor deeper than the
        # lightest replica's loses the request — a shared leading block
        # must not collapse the whole pool onto one replica.  Queue
        # loads are TTL-cached so the guard costs O(n) RPCs per interval,
        # not per request.
        self.imbalance_factor = imbalance_factor
        self._loads_ttl_s = 0.1
        self._loads_cache: tuple = (0.0, None)  # (ts, loads | None)
        self.router_hits = 0
        self.router_misses = 0

    @staticmethod
    def _is_actor(h) -> bool:
        return hasattr(getattr(h, "prefill", None), "remote") or hasattr(
            getattr(h, "add_from_kv", None), "remote"
        )

    # ------------------------------------------------- prefix-aware routing
    def _select_decode(self, prompt: str):
        """Pick the decode replica for ``prompt``: deepest block-chain
        affinity match wins (the replica already holding those KV
        blocks), round-robin otherwise.  Returns (replica, affinity_hit)
        and re-homes the prompt's chain onto the choice."""
        if not self.prefix_routing:
            return self.decode_replicas[next(self._d_rr)], False
        token_ids = self._tokenizer.encode(prompt)
        # Block chain + the exact-prompt key: short prompts (< one block)
        # produce no chain keys at all, and exact repeats are the single
        # most common serving pattern — the full key gives both affinity.
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
            # Imbalance guard (queue probes happen OUTSIDE the affinity
            # lock): a block-level match is locality ADVICE — distinct
            # prompts sharing one leading block must not collapse the
            # pool onto one replica, so an overloaded advisory target
            # loses the request.  An EXACT-prompt match is exempt: that
            # replica holds this prompt's full KV, and re-homing it
            # trades a cache hit for a prefill.
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
        flight_recorder.record_llm_prefix_lookup("router", hit)
        return self.decode_replicas[idx], hit

    def _decode_loads(self) -> Optional[List[int]]:
        """Per-decode-replica load (queued + decoding sequences) from the
        batched replicas' stats(), TTL-cached; None when unavailable
        (plain replicas / probe failure) — the guard then stands down."""
        ts, loads = self._loads_cache
        now = time.monotonic()
        if ts > 0 and now - ts < self._loads_ttl_s:
            return loads  # a cached None (plain pool) also holds for TTL
        try:
            if self._is_actor(self.decode_replicas[0]):
                stats = ray_tpu_torch.get(
                    [d.stats.remote() for d in self.decode_replicas],
                    timeout=5,
                )
            else:
                stats = [d.stats() for d in self.decode_replicas]
            loads = [
                int(s["occupancy"]) + int(s["queue_depth"]) for s in stats
            ]
        except Exception:  # noqa: BLE001 — guard degrades to affinity-only
            loads = None
        self._loads_cache = (now, loads)
        return loads

    def _try_cached(self, d, prompt: str, params, timeout_s: float):
        """Prefix-cache fast path if the replica supports it.  Actor
        handles synthesize any method name, so support is learned from
        the first call: a missing-method error marks the replica plain
        (DecodeReplica) and is never retried."""
        key = id(d)
        if self._cached_support.get(key) is False:
            return None
        if not self._is_actor(d):
            if not hasattr(d, "try_add_cached"):
                self._cached_support[key] = False
                return None
            self._cached_support[key] = True
            return d.try_add_cached(prompt, params)
        try:
            rid = ray_tpu_torch.get(
                d.try_add_cached.remote(prompt, params), timeout=timeout_s
            )
        except Exception as e:  # noqa: BLE001 — capability probe
            # Concurrent first calls may all be probing: re-raise only
            # when support was already CONFIRMED (a real failure on a
            # batched replica), not when a sibling thread just marked
            # the replica plain.
            if self._cached_support.get(key) is not True and (
                _missing_method(e, "try_add_cached")
            ):
                self._cached_support[key] = False
                return None
            raise
        self._cached_support[key] = True
        return rid

    def _admit(self, prompt: str, params, d, timeout_s: float):
        """Admit ``prompt`` on decode replica ``d``: prefix-cache fast
        path first (no prefill hop), else prefill + KV handoff.
        Returns the replica-local request id."""
        rid = self._try_cached(d, prompt, params, timeout_s)
        if rid is not None:
            return rid
        p = self.prefill_replicas[next(self._p_rr)]
        if self._is_actor(d):
            meta = ray_tpu_torch.get(
                p.prefill.remote(prompt, params), timeout=timeout_s
            )
            return ray_tpu_torch.get(d.add_from_kv.remote(meta),
                                     timeout=timeout_s)
        return d.add_from_kv(p.prefill(prompt, params))

    def _generate_on(self, d, prompt: str, params, timeout_s: float) -> dict:
        """Full generate on decode replica ``d``.  Batched actor replicas
        take the FUSED round trips (generate_cached: cached admission +
        completion in one call; run_from_kv: KV admission + completion in
        one call) so the hot repeat-prompt path costs one RPC like a
        monolithic engine call; plain replicas keep the two-phase path."""
        if not self._is_actor(d):
            rid = self._admit(prompt, params, d, timeout_s)
            return d.run(rid, timeout_s=timeout_s)
        key = id(d)
        support = self._cached_support.get(key)
        result = None
        if support is not False:
            try:
                result = ray_tpu_torch.get(
                    d.generate_cached.remote(prompt, params, timeout_s),
                    timeout=timeout_s,
                )
                self._cached_support[key] = True
            except Exception as e:  # noqa: BLE001 — capability probe
                if support is not True and _missing_method(
                    e, "generate_cached"
                ):
                    self._cached_support[key] = False
                else:
                    raise
        if result is not None:
            return result
        p = self.prefill_replicas[next(self._p_rr)]
        meta = ray_tpu_torch.get(p.prefill.remote(prompt, params),
                                 timeout=timeout_s)
        if self._cached_support.get(key):
            return ray_tpu_torch.get(
                d.run_from_kv.remote(meta, timeout_s), timeout=timeout_s
            )
        rid = ray_tpu_torch.get(d.add_from_kv.remote(meta),
                                timeout=timeout_s)
        return ray_tpu_torch.get(d.run.remote(rid), timeout=timeout_s)

    def generate(
        self,
        prompt: str,
        params: Optional[SamplingParams] = None,
        timeout_s: float = 300.0,
    ) -> dict:
        d, _ = self._select_decode(prompt)
        # One request-scoped span per generate: the prefill and decode
        # actor calls inside inherit the trace, so the router -> prefill
        # -> decode path exports as a single stitched cluster trace.
        # TTFT here is prompt-in to first-token-out (the admission hop —
        # prefill, or the prefix-cache fast path), the disaggregation
        # pattern's protected latency.
        t0 = time.perf_counter()
        ttft_s = None
        outcome = "ok"
        try:
            with tracing.start_span(
                "llm.disagg.generate", {"deployment": "llm_disagg"}
            ) as span:
                try:
                    result = self._generate_on(d, prompt, params, timeout_s)
                    # Fused round trips fold admission into completion,
                    # so router-side TTFT is whole-request latency; the
                    # decode engine records the true per-request TTFT
                    # under its own deployment tag.
                    ttft_s = time.perf_counter() - t0
                    span.set_attribute("ttft_s", ttft_s)
                except BaseException as e:
                    span.set_attribute("error", str(e))
                    raise
            return result
        except BaseException:
            outcome = "error"
            raise
        finally:
            flight_recorder.record_serve_request(
                "llm_disagg", "router", 0.0,
                ttft_s if ttft_s is not None
                else time.perf_counter() - t0,
                outcome=outcome,
            )

    def stream(self, prompt: str,
               params: Optional[SamplingParams] = None,
               timeout_s: float = 300.0):
        """Streaming generate through the disaggregated path: admit (prefix
        cache or prefill+KV handoff), then yield the decode replica's text
        deltas.  Inside a traced caller (e.g. the serve SSE path) the
        admission and decode calls inherit the active span, so one
        stitched trace covers router -> prefill -> decode.  With the span
        recorder on, the request is one ``llm.request`` span whose trace
        the prefill, the KV handoff and the queue wait join."""
        root = None
        if tracing.active_recorder is not None:
            root = tracing.detached_span(
                "llm.request",
                {"prompt_tokens": len(self._tokenizer.encode(prompt))})
        try:
            d, _ = self._select_decode(prompt)
            with tracing.span_context(root):
                rid = self._admit(prompt, params, d, timeout_s)
            if self._is_actor(d):
                gen = d.run_stream.options(num_returns="streaming").remote(
                    rid)
                for ref in gen:
                    yield ray_tpu_torch.get(ref, timeout=timeout_s)
            else:
                yield from d.run_stream(rid, timeout_s=timeout_s)
        finally:
            if root is not None:
                tracing.finish_span(root)

    def generate_many(
        self,
        prompts: List[str],
        params: Optional[SamplingParams] = None,
        timeout_s: float = 300.0,
    ) -> List[dict]:
        """Pipelined fan-out: all prefills dispatch first (spread over the
        prefill pool), continuations spread over the decode pool."""
        if not self._is_actor(self.prefill_replicas[0]):
            return [self.generate(p, params, timeout_s) for p in prompts]
        # Each prompt routes to its prefix-affine decode replica first; a
        # prefix-cache hit admits immediately (no prefill dispatched).
        # The misses' prefills all dispatch up-front (spread over the
        # prefill pool); each prompt's continuation pipeline
        # (add_from_kv -> run) starts the moment ITS prefill completes —
        # no barrier, so one slow prefill never delays the other prompts'
        # decode starts.
        deadline = time.time() + timeout_s
        run_refs: List[Any] = [None] * len(prompts)
        meta_refs: Dict[Any, tuple] = {}
        # Cached-admission probes dispatch as refs FIRST and resolve
        # overlapped — a blocking probe per prompt would serialize N
        # round trips ahead of the prefill fan-out and break its
        # all-dispatch-immediately property.
        probes: List[tuple] = []
        for i, prompt in enumerate(prompts):
            d, _ = self._select_decode(prompt)
            key = id(d)
            if self._cached_support.get(key) is False or not hasattr(
                type(d) if not self._is_actor(d) else d, "try_add_cached"
            ):
                probes.append((i, prompt, d, None))
            elif self._is_actor(d):
                probes.append(
                    (i, prompt, d, d.try_add_cached.remote(prompt, params))
                )
            else:
                probes.append(
                    (i, prompt, d, d.try_add_cached(prompt, params))
                )
        for i, prompt, d, probe in probes:
            rid = None
            if probe is not None:
                if self._is_actor(d):
                    try:
                        rid = ray_tpu_torch.get(probe, timeout=timeout_s)
                        self._cached_support[id(d)] = True
                    except Exception as e:  # noqa: BLE001 — probe
                        if self._cached_support.get(id(d)) is not True and (
                            _missing_method(e, "try_add_cached")
                        ):
                            self._cached_support[id(d)] = False
                        else:
                            raise
                else:
                    rid = probe
            if rid is not None:
                run_refs[i] = d.run.remote(rid)
            else:
                ref = self.prefill_replicas[next(self._p_rr)].prefill.remote(
                    prompt, params
                )
                meta_refs[ref] = (i, d)
        pending = list(meta_refs)
        while pending:
            ready, pending = ray_tpu_torch.wait(
                pending, num_returns=1,
                timeout=max(0.0, deadline - time.time()),
            )
            if not ready:
                raise TimeoutError("prefill fan-out timed out")
            for ref in ready:
                i, d = meta_refs[ref]
                meta = ray_tpu_torch.get(ref, timeout=timeout_s)
                rid = ray_tpu_torch.get(d.add_from_kv.remote(meta),
                                        timeout=timeout_s)
                run_refs[i] = d.run.remote(rid)
        return ray_tpu_torch.get(run_refs, timeout=timeout_s)

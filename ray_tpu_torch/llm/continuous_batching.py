"""Continuous-batching decode scheduler: one resident decode loop per
replica, admission and retirement at token boundaries.

Port of ``ray_tpu/llm/continuous_batching.py``, with its scheduling
unchanged: one owner thread steps (retire, starvation guard, admit, one
decode) and callers only enqueue and consume; admission is FIFO with a
resume queue that drains first; the batch is padded to a power-of-two
bucket that grows at once and shrinks after ``shrink_patience`` low steps,
compacting rows; the starvation guard preempts the longest-running
sequence to host and resumes it token-exact; a prefix KV cache keyed by
chained block hashes re-admits a repeated prompt with no prefill.  Greedy
outputs are token-exact across bucket shapes; raw logits are not bitwise
stable across batch shapes, so parity is defined at the sampled token.

How the JAX engine's per-bucket programs read in PyTorch:

  - **One persistent cache per bucket.**  Bucket ``b`` owns a cache
    ``[L, b, Hkv, T, D]``, allocated once, on its first use (or in
    ``compile_buckets``).  Growing and shrinking copy rows between two
    buckets' caches, as the JAX resize builds a new array; insert (the KV
    splice of an admission) and move (compaction) copy one row in place.
    These are single copies and run eagerly.
  - **One CUDA graph per bucket.**  On the card, bucket ``b``'s decode step
    (``jax.jit`` in the JAX ``_decode_fn``) is captured once into a
    ``torch.cuda.CUDAGraph`` over static ``[b]`` token and position inputs
    and a static ``[b, V]`` logits output; ``step()`` copies the inputs in
    and replays it.  Capture happens on the bucket's first use, as
    ``jax.jit`` compiles on first use, or for every bucket in
    ``compile_buckets()``, always before ``start()`` or on the stepping
    thread.  A capture or replay that fails raises: there is no eager path
    on the card.  On the CPU the same step runs eagerly through the plain
    versions of the kernels.
  - **Prefill stays eager** (its length varies per prompt) and happens
    elsewhere: ``submit_kv`` takes pages a ``disagg.PrefillEngine`` made.

Sampling: greedy is an argmax that consumes no random numbers, so batch
composition cannot change a greedy output; stochastic sampling draws from
the engine's ``torch.Generator``, on the stepping thread only.

The JAX engine's flight-recorder and serving-telemetry hooks (and the
per-request timestamps they read) wait for the metrics registry's port
(ROADMAP A3).

Locking contract: ``_lock`` guards queue and slot metadata, subscriber
queues and counters.  The caches and graphs are touched only by the
stepping thread; device work happens outside the lock, and consumers wait
on per-request events and queues, never on the engine lock.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import itertools
import logging
import queue as _queue
import threading
import time
import weakref
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models import model_family
from ..models.gpt2_decode import sample_logits
from ..ops.decode_attention import decode_attention, release_scratch
from .engine import EngineConfig, SamplingParams, encode_prompt
from .tokenizer import ByteTokenizer

# Warm-up runs before a capture.  The first builds the kernels and makes the
# decode wrapper's scratch for the capture stream, the second runs warm.
_WARMUP_STEPS = 2


@dataclasses.dataclass
class ContinuousBatchingConfig:
    """Knobs for the resident decode scheduler."""

    # Consecutive steps with occupancy <= bucket/2 before shrinking.
    shrink_patience: int = 16
    # Queue-head wait that triggers the starvation guard (only once the
    # bucket is maxed: growth always beats preemption).
    starvation_timeout_s: float = 2.0
    # A preemption victim must have generated at least this many tokens.
    preempt_min_tokens: int = 4
    # Per-sequence preemption budget: guarantees forward progress.
    max_preemptions_per_seq: int = 2
    # Prefix KV cache budget in cached prompt TOKENS (host memory).
    prefix_cache_tokens: int = 4096
    # Tokens per hash block in the prefix-cache chain.
    prefix_block_tokens: int = 16


def prefix_block_keys(token_ids: List[int], block_tokens: int) -> List[bytes]:
    """Chained block digests: key_i commits to every token in blocks
    [0, i], so two prompts share key_i iff their first (i+1) blocks match.
    The same bytes as the JAX function, so routers of either package agree
    on affinity."""
    keys: List[bytes] = []
    prev = b""
    for i in range(0, len(token_ids) - len(token_ids) % block_tokens,
                   block_tokens):
        h = hashlib.blake2b(prev, digest_size=16)
        h.update(np.asarray(token_ids[i:i + block_tokens], np.int32).tobytes())
        prev = h.digest()
        keys.append(prev)
    return keys


def full_prompt_key(token_ids: List[int], block_tokens: int) -> bytes:
    chain = prefix_block_keys(token_ids, block_tokens)
    h = hashlib.blake2b(chain[-1] if chain else b"", digest_size=16)
    tail = len(token_ids) - len(token_ids) % block_tokens
    h.update(np.asarray(token_ids[tail:], np.int32).tobytes())
    h.update(len(token_ids).to_bytes(4, "little"))
    return h.digest()


class PrefixKVCache:
    """Host-side LRU of prompt KV blocks, keyed by chained block hashes.

    An entry holds a trimmed ``[L, 1, Hkv, prompt_len, D]`` host copy of a
    prompt's KV as CPU tensors (numpy has no bf16) and its last-position
    logits; ``lookup`` returns it only on FULL coverage of the new prompt's
    tokens.  Evicts least-recently-used entries past the token budget.
    Thread-safety is the caller's (engine lock)."""

    def __init__(self, max_tokens: int, block_tokens: int):
        self.max_tokens = max_tokens
        self.block_tokens = max(1, block_tokens)
        self._entries: "collections.OrderedDict[bytes, dict]" = (
            collections.OrderedDict()
        )
        self._block_index: Dict[bytes, bytes] = {}  # block key -> entry key
        self._tokens = 0
        self.hits = 0
        self.misses = 0

    @staticmethod
    def build_entry(token_ids: List[int], k, v, logits,
                    block_tokens: int) -> dict:
        """Host copies for one prompt's KV (call OUTSIDE the engine lock:
        the copies are the expensive part).  ``k``/``v`` are tensors on any
        device, or arrays."""
        n = len(token_ids)

        def host(x):
            # Trim to the prompt span; the copy owns its memory.
            return torch.as_tensor(x)[:, :, :, :n].to(
                "cpu", copy=True, memory_format=torch.contiguous_format)

        return {
            "key": full_prompt_key(token_ids, block_tokens),
            "token_ids": list(token_ids),
            "k": host(k),
            "v": host(v),
            "logits": torch.as_tensor(logits).to(
                "cpu", torch.float32, copy=True).reshape(-1),
            "blocks": prefix_block_keys(token_ids, block_tokens),
        }

    def insert(self, entry: dict) -> None:
        if self.max_tokens <= 0 or not entry["token_ids"]:
            return
        key = entry["key"]
        if key in self._entries:
            self._entries.move_to_end(key)
            return
        self._entries[key] = entry
        for bk in entry["blocks"]:
            self._block_index[bk] = key
        self._tokens += len(entry["token_ids"])
        while self._tokens > self.max_tokens and len(self._entries) > 1:
            _, old = self._entries.popitem(last=False)
            self._tokens -= len(old["token_ids"])
            for bk in old["blocks"]:
                if self._block_index.get(bk) == old["key"]:
                    del self._block_index[bk]

    def contains(self, key: bytes) -> bool:
        """Key-presence check without LRU touch or hit/miss accounting."""
        return key in self._entries

    def lookup(self, token_ids: List[int]) -> Optional[dict]:
        key = full_prompt_key(token_ids, self.block_tokens)
        entry = self._entries.get(key)
        if entry is not None:
            self._entries.move_to_end(key)
            self.hits += 1
            return entry
        self.misses += 1
        return None

    def match_depth(self, token_ids: List[int]) -> int:
        """Longest cached block-chain prefix, in blocks (routing signal)."""
        depth = 0
        for bk in prefix_block_keys(token_ids, self.block_tokens):
            if bk not in self._block_index:
                break
            depth += 1
        return depth

    def stats(self) -> Dict[str, int]:
        return {
            "entries": len(self._entries),
            "tokens": self._tokens,
            "hits": self.hits,
            "misses": self.misses,
        }


@dataclasses.dataclass
class _Seq:
    rid: int
    prompt_len: int
    generated: List[int]
    params: SamplingParams
    done: bool = False
    cancelled: bool = False
    preemptions: int = 0

    @property
    def last_pos(self) -> int:
        return self.prompt_len + len(self.generated) - 1


def _buckets(max_batch: int) -> List[int]:
    out, b = [], 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return out


class BucketProgram:
    """One bucket's decode program: the bucket's persistent cache, static
    ``[2, b]`` int32 inputs (tokens, positions) and, on the card, the decode
    step captured in a CUDA graph whose logits output is static too.

    The program is built, and on the card captured, in its constructor, on
    the cache it has just allocated: the capture's warm-up steps run for
    real, on the capture stream, over rows that hold no sequence yet."""

    def __init__(self, engine: "ContinuousBatchingEngine", batch: int):
        fam, mcfg = engine.family, engine.cfg.model
        self.batch = batch
        self.cache = fam.init_cache(mcfg, batch, engine.cfg.max_seq_len,
                                    engine.device)
        self.inputs = torch.zeros((2, batch), dtype=torch.int32,
                                  device=engine.device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.logits: Optional[torch.Tensor] = None
        self.capture_s = 0.0
        # Kernel launches the graph holds, by wrapper, counted at capture:
        # each replay launches them again, and the wrappers' counters, which
        # tick on the host, see only the capture.
        self.launches: Dict[str, int] = {}
        self.steps = 0
        self.decode_s = 0.0

        def run():
            return fam.decode_step(engine.params, self.inputs[0],
                                   self.inputs[1], self.cache, mcfg)[0]

        self._run = run
        if engine.device.type == "cuda":
            self._capture(engine._capture_stream())

    def _capture(self, stream: torch.cuda.Stream) -> None:
        t0 = time.perf_counter()
        current = torch.cuda.current_stream(stream.device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            for _ in range(_WARMUP_STEPS):
                self._run()
        current.wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        before = decode_attention.launches
        # thread_local: client threads prefill on other streams meanwhile.
        with torch.cuda.graph(graph, stream=stream,
                              capture_error_mode="thread_local"):
            logits = self._run()
        self.launches = {"decode_attention": decode_attention.launches
                         - before}
        self.graph, self.logits = graph, logits
        torch.cuda.synchronize(stream.device)
        self.capture_s = time.perf_counter() - t0

    def decode(self, tokens: np.ndarray, pos: np.ndarray) -> torch.Tensor:
        """One decode step of the bucket: logits [b, V] f32, the cache
        updated in place.  On the card the logits are the graph's static
        output, overwritten by the next replay."""
        self.inputs.copy_(torch.from_numpy(np.stack([tokens, pos])))
        self.steps += 1
        if self.graph is None:
            return self._run()
        self.graph.replay()
        return self.logits


class ContinuousBatchingEngine:
    """Decode-role engine with a resident batched decode loop.

    Callers enqueue (``submit_kv`` / ``submit_cached``) and consume
    (``stream`` / ``result``); the owner thread (started by ``start()``)
    runs ``step()``: retire, starvation guard, admit, one decode, at every
    token boundary.  Runs on ``device`` (the card unless told ``"cpu"``)."""

    def __init__(self, cfg: Optional[EngineConfig] = None,
                 cb: Optional[ContinuousBatchingConfig] = None,
                 tokenizer=None, device: DeviceLike = None):
        self.cfg = cfg or EngineConfig()
        self.cb = cb or ContinuousBatchingConfig()
        self.device = resolve_device(device)
        self.tokenizer = tokenizer or ByteTokenizer()
        mcfg = self.cfg.model
        self.family = model_family(mcfg)
        if self.cfg.param_loader is not None:
            self.params = self.cfg.param_loader()
        else:
            gen = torch.Generator(device=self.device).manual_seed(
                self.cfg.seed)
            self.params = self.family.init(gen, mcfg, self.device)
        self._gen = torch.Generator(device=self.device).manual_seed(
            self.cfg.seed + 1
        )
        self._buckets = _buckets(self.cfg.max_batch_size)
        # Bucket -> its program, made on first use (the recompile contract:
        # at most one capture per bucket).
        self._programs: Dict[int, BucketProgram] = {}
        self._stream: Optional[torch.cuda.Stream] = None
        self.bucket = self._buckets[0]
        self.slots: List[Optional[_Seq]] = [None] * self.bucket
        # Every bucket the engine moved to, in order (bounded).
        self.bucket_trace: "collections.deque" = collections.deque(
            [self.bucket], maxlen=4096)

        self._cond = threading.Condition()
        self._lock = self._cond  # the condition IS the engine lock
        self._next_id = itertools.count()
        # Pending admissions: (rid, meta, k, v).  Preempted sequences go on
        # _resume (drained before _waiting: they already waited once),
        # except that a starvation-guard preemption hands its freed slot to
        # the starved _waiting head first.
        self._waiting: "collections.deque" = collections.deque()
        self._resume: "collections.deque" = collections.deque()
        self._admit_waiting_first = False
        self._finished: Dict[int, dict] = {}
        self._subs: Dict[int, _queue.SimpleQueue] = {}
        self._events: Dict[int, threading.Event] = {}
        # compile_buckets() calls handed to the running loop.
        self._jobs: "collections.deque" = collections.deque()
        self.prefix_cache = PrefixKVCache(
            self.cb.prefix_cache_tokens, self.cb.prefix_block_tokens
        )
        self._starved_since: Optional[float] = None
        self._low_occupancy_steps = 0
        self.counters = {
            "admitted": 0, "retired": 0, "preempted": 0, "steps": 0,
            "max_occupancy": 0,
        }
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._fail_count = 0
        self._dead = False
        self.decode_program(self.bucket)

    # ------------------------------------------------------------ programs
    @property
    def cache(self) -> Dict[str, torch.Tensor]:
        """The current bucket's cache."""
        return self._programs[self.bucket].cache

    def _capture_stream(self) -> torch.cuda.Stream:
        """The engine's own stream for warm-ups and captures, so its graphs'
        decode scratch is its own (``ops/decode_attention.py:_scratch``),
        and is dropped with the engine."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            weakref.finalize(self, release_scratch, self._stream.cuda_stream)
        return self._stream

    def decode_program(self, b: int) -> BucketProgram:
        """Bucket ``b``'s program, made (cache allocated, decode captured on
        the card) on first use.  Stepping thread only, or a stopped
        engine."""
        prog = self._programs.get(b)
        if prog is None:
            prog = BucketProgram(self, b)
            with self._lock:  # stats() reads _programs from other threads
                self._programs[b] = prog
        return prog

    def compile_buckets(self) -> Dict[int, float]:
        """Make every bucket's program up front (cache allocated and, on the
        card, decode captured), so no capture lands inside serving and
        masquerades as an inter-token stall.  Returns each bucket's capture
        seconds (0.0 on the CPU, or for a bucket made earlier).  On a running
        engine the work is handed to the loop thread and this call waits."""
        t = self._thread
        if (t is None or not t.is_alive()
                or t is threading.current_thread()):
            return self._compile_all()
        job = {"done": threading.Event()}
        with self._lock:
            self._jobs.append(job)
            self._cond.notify_all()
        while not job["done"].wait(timeout=0.1):
            if t.is_alive():
                continue
            with self._lock:  # the loop ended: take the job back if queued
                queued = job in self._jobs
                if queued:
                    self._jobs.remove(job)
            if queued:
                return self._compile_all()
            if not job["done"].is_set():
                raise RuntimeError("the decode loop ended while compiling")
        if "error" in job:
            raise job["error"]
        return job["result"]

    def _compile_all(self) -> Dict[int, float]:
        times = {}
        for b in self._buckets:
            fresh = b not in self._programs
            prog = self.decode_program(b)
            times[b] = prog.capture_s if fresh else 0.0
        return times

    def _run_jobs(self) -> None:
        with self._lock:
            jobs = list(self._jobs)
            self._jobs.clear()
        for job in jobs:
            try:
                job["result"] = self._compile_all()
            except Exception as e:  # noqa: BLE001 — re-raised by the caller
                job["error"] = e
            job["done"].set()

    # ----------------------------------------------------------- admission
    def submit_kv(self, meta: Dict[str, Any], k, v) -> int:
        """Enqueue a prefilled request (disaggregated admission).  ``meta``
        carries prompt_len / first_token / sampling / logits / token_ids
        (see ``disagg.PrefillEngine.prefill``); ``k``/``v`` are the
        [L, 1, Hkv, S, D] prompt KV pages (S <= max_seq_len), CUDA tensors
        that stay on the card until they are spliced, or host tensors or
        arrays.  Also feeds the prefix cache so future identical prompts
        skip prefill."""
        if self._dead:
            raise RuntimeError("decode engine failed; replica is dead")
        k = torch.as_tensor(k)
        v = torch.as_tensor(v)
        token_ids = meta.get("token_ids")
        entry = None
        if token_ids and meta.get("logits") is not None:
            # Cheap key check before the expensive host copies.
            key = full_prompt_key(token_ids, self.cb.prefix_block_tokens)
            with self._lock:
                known = self.prefix_cache.contains(key)
            if not known:
                entry = PrefixKVCache.build_entry(
                    token_ids, k, v, meta["logits"],
                    self.cb.prefix_block_tokens,
                )
        with self._lock:
            rid = next(self._next_id)
            if entry is not None:
                self.prefix_cache.insert(entry)
            self._enqueue_locked(rid, dict(meta), k, v)
            return rid

    def submit_cached(self, prompt: str,
                      params: Optional[SamplingParams] = None
                      ) -> Optional[int]:
        """Prefix-cache admission: if the prompt's full token sequence is
        cached, enqueue straight from the cached KV (no prefill anywhere)
        and return a rid; else None (the caller falls back to a prefill
        replica, and the miss is accounted)."""
        if self._dead:
            raise RuntimeError("decode engine failed; replica is dead")
        params = params or SamplingParams()
        token_ids = encode_prompt(
            self.tokenizer, prompt, self.cfg.max_seq_len
        )
        with self._lock:
            cached = self.prefix_cache.lookup(token_ids)
        if cached is None:
            return None
        # The first token is NOT sampled here: sampling may draw from the
        # engine generator, which belongs to the stepping thread alone; the
        # admission samples from the cached logits at the token boundary.
        # The pages span the prompt only: the splice writes rows [0, n).
        meta = {
            "prompt_len": len(token_ids),
            "first_logits": cached["logits"],
            "sampling": params,
            "token_ids": token_ids,
        }
        with self._lock:
            rid = next(self._next_id)
            self._enqueue_locked(rid, meta, cached["k"], cached["v"])
            return rid

    def _enqueue_locked(self, rid: int, meta: dict, k, v) -> None:
        self._waiting.append((rid, meta, k, v))
        self._subs.setdefault(rid, _queue.SimpleQueue())
        self._events.setdefault(rid, threading.Event())
        self._cond.notify_all()

    def prefix_match_depth(self, prompt: str) -> int:
        token_ids = encode_prompt(self.tokenizer, prompt, self.cfg.max_seq_len)
        with self._lock:
            return self.prefix_cache.match_depth(token_ids)

    def _sample(self, logits: torch.Tensor, params: SamplingParams) -> int:
        """Sample one token from ``logits`` [1, V] (any device).  Greedy is
        a pure argmax (no random numbers consumed: batch composition cannot
        perturb the generator, the parity contract); stochastic params draw
        from the engine generator.  Stepping thread only."""
        if params.temperature == 0.0:
            return int(torch.argmax(logits))
        return int(sample_logits(
            logits.to(self.device), self._gen, params.temperature,
            params.top_k, params.top_p,
        )[0])

    # ----------------------------------------------------- lifecycle/loop
    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="llm-cb-decode", daemon=True
        )
        self._thread.start()

    def stop(self, timeout_s: float = 10.0) -> None:
        self._stop.set()
        with self._lock:
            self._cond.notify_all()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=timeout_s)

    def _loop(self) -> None:
        while not self._stop.is_set():
            self._run_jobs()
            with self._lock:
                has_work = (
                    self._waiting or self._resume
                    or any(s is not None for s in self.slots)
                )
                if not has_work:
                    # Bounded idle wait; woken by submissions.
                    self._cond.wait(timeout=0.05)
                    continue
            try:
                self.step()
            except Exception:  # noqa: BLE001 — fail every waiter, loudly
                logging.getLogger(__name__).exception(
                    "continuous-batching step failed")
                self._fail_all()

    def _fail_all(self) -> None:
        with self._lock:
            seqs = [s for s in self.slots if s is not None]
            pend = list(self._resume) + list(self._waiting)
            self._resume.clear()
            self._waiting.clear()
            for i in range(len(self.slots)):
                self.slots[i] = None
            for s in seqs:
                self._finish_locked(s, error="decode loop failed")
            for rid, _meta, _k, _v in pend:
                self._finish_rid_locked(rid, error="decode loop failed")
        # Recover: back to the smallest bucket with every slot free (the
        # caches persist; a free row's stale contents are never read).
        # Repeated failures mark the engine dead instead (crash loop:
        # surface, don't mask).
        self._fail_count += 1
        if self._fail_count >= 3:
            self._dead = True
            self._stop.set()
            return
        try:
            self.decode_program(self._buckets[0])
            with self._lock:
                self._set_bucket_locked(self._buckets[0])
                self.slots = [None] * self.bucket
                self._low_occupancy_steps = 0
        except Exception:  # noqa: BLE001 — can't recover: go dead
            logging.getLogger(__name__).exception(
                "continuous-batching recovery failed")
            self._dead = True
            self._stop.set()

    @property
    def healthy(self) -> bool:
        return not self._dead

    # ----------------------------------------------------------- stepping
    def step(self) -> None:
        """One token boundary + one decode step for the active set."""
        self._token_boundary()
        active = self._decode_once()
        with self._lock:
            self.counters["steps"] += 1
            self.counters["max_occupancy"] = max(
                self.counters["max_occupancy"], active
            )
            if active and active * 2 <= self.bucket:
                self._low_occupancy_steps += 1
            else:
                self._low_occupancy_steps = 0
        self._maybe_shrink()

    def _token_boundary(self) -> Tuple[int, int]:
        """Retire finished, run the starvation guard, admit waiters.
        Returns (admissions, retirements)."""
        retired = self._retire()
        self._starvation_guard()
        return self._admit(), retired

    def _retire(self) -> int:
        with self._lock:
            done = [
                (i, s) for i, s in enumerate(self.slots)
                if s is not None and (s.done or s.cancelled)
            ]
            for i, s in done:
                self.slots[i] = None
                if not s.cancelled:
                    self._finish_locked(s)
                    self.counters["retired"] += 1
                else:
                    self._finish_rid_locked(s.rid, cancelled=True)
        return sum(1 for _, s in done if not s.cancelled)

    def _stop_token(self, s: _Seq) -> Optional[int]:
        return (s.params.stop_token if s.params.stop_token is not None
                else getattr(self.tokenizer, "EOS", None))

    def _finish_locked(self, s: _Seq, error: Optional[str] = None) -> None:
        if s.rid not in self._subs and s.rid not in self._events:
            return  # consumer already released; storing would leak
        gen = s.generated
        stop = self._stop_token(s)
        if stop is not None and gen and gen[-1] == stop:
            gen = gen[:-1]
        result = {
            "request_id": s.rid,
            "token_ids": gen,
            "text": self.tokenizer.decode(gen),
            "num_generated": len(s.generated),
        }
        if error:
            result["error"] = error
        self._finished[s.rid] = result
        self._signal_locked(s.rid)

    def _finish_rid_locked(self, rid: int, error: Optional[str] = None,
                           cancelled: bool = False) -> None:
        if cancelled and rid not in self._subs and rid not in self._events:
            return  # consumer already released; storing would leak
        result = {"request_id": rid, "token_ids": [], "text": "",
                  "num_generated": 0}
        if error:
            result["error"] = error
        if cancelled:
            result["cancelled"] = True
        self._finished[rid] = result
        self._signal_locked(rid)

    def _signal_locked(self, rid: int) -> None:
        q = self._subs.get(rid)
        if q is not None:
            q.put(None)  # stream sentinel
        ev = self._events.get(rid)
        if ev is not None:
            ev.set()

    def _starvation_guard(self) -> None:
        with self._lock:
            if not self._waiting and not self._resume:
                self._starved_since = None
                return
            free = any(s is None for s in self.slots)
            if free or self.bucket < self.cfg.max_batch_size:
                self._starved_since = None
                return
            now = time.monotonic()
            if self._starved_since is None:
                self._starved_since = now
                return
            if now - self._starved_since < self.cb.starvation_timeout_s:
                return
            victims = [
                (len(s.generated), i, s)
                for i, s in enumerate(self.slots)
                if s is not None and not s.done and not s.cancelled
                and len(s.generated) >= self.cb.preempt_min_tokens
                and s.preemptions < self.cb.max_preemptions_per_seq
            ]
            if not victims:
                self._starved_since = now  # re-arm; nothing eligible yet
                return
            _, idx, victim = max(victims, key=lambda t: (t[0], -t[1]))
            self.slots[idx] = None
            self._starved_since = None
            victim.preemptions += 1
            self.counters["preempted"] += 1
        # KV extraction outside the lock: one D2H of the victim's written
        # rows, [0, last_pos) (the last token's k/v are written by its next
        # decode step, after the resume).
        # A copy even on a CPU engine, where the slot is reused meanwhile.
        n = victim.last_pos
        kh = self.cache["k"][:, idx:idx + 1, :, :n].to("cpu", copy=True)
        vh = self.cache["v"][:, idx:idx + 1, :, :n].to("cpu", copy=True)
        meta = {
            "prompt_len": victim.prompt_len,
            "sampling": victim.params,
            "resume_seq": victim,
        }
        with self._lock:
            self._resume.appendleft((victim.rid, meta, kh, vh))
            # The freed slot belongs to the starved head, not the victim.
            self._admit_waiting_first = True

    def _admit(self) -> int:
        """Drain pending admissions into free slots, growing the bucket
        (adjacent steps) while demand remains.  Splices happen outside the
        lock; slot metadata commits under it."""
        admitted = 0
        while True:
            with self._lock:
                pending = len(self._waiting) + len(self._resume)
                if pending == 0:
                    return admitted
                idx = next(
                    (i for i, s in enumerate(self.slots) if s is None), None
                )
                if idx is None and self.bucket >= self.cfg.max_batch_size:
                    return admitted
                entry = None
                if idx is not None:
                    if self._admit_waiting_first and self._waiting:
                        source = self._waiting
                    else:
                        source = self._resume if self._resume else self._waiting
                    self._admit_waiting_first = False
                    entry = source.popleft()
                    rid = entry[0]
                    if rid in self._finished:  # cancelled while queued
                        continue
            if entry is None:
                self._grow()
                continue
            rid, meta, k, v = entry
            self._insert(idx, k, v)
            first = meta.get("first_token")
            if first is None and meta.get("resume_seq") is None:
                # Prefix-cache admission: the first token is sampled HERE
                # (the stepping thread owns the generator) from the cached
                # last-position logits.
                first = self._sample(meta["first_logits"][None],
                                     meta["sampling"])
            with self._lock:
                if rid in self._finished or (
                    rid not in self._subs and rid not in self._events
                ):
                    # Cancelled/released while we were splicing: don't
                    # commit the slot (the spliced row is garbage in a FREE
                    # slot, overwritten by the next admission).
                    continue
                seq = meta.get("resume_seq")
                if seq is None:
                    seq = _Seq(
                        rid=rid,
                        prompt_len=meta["prompt_len"],
                        generated=[first],
                        params=meta["sampling"],
                    )
                    self.counters["admitted"] += 1
                    self._push_delta_locked(seq, [first])
                    self._check_done_locked(seq)
                self.slots[idx] = seq
                admitted += 1

    def _insert(self, idx: int, k: torch.Tensor, v: torch.Tensor) -> None:
        """Splice [L, 1, Hkv, S, D] pages into rows [0, S) of slot ``idx``
        (one copy each, host-to-device where the pages are on the host)."""
        s = k.shape[3]
        self.cache["k"][:, idx:idx + 1, :, :s].copy_(k)
        self.cache["v"][:, idx:idx + 1, :, :s].copy_(v)

    def _set_bucket_locked(self, b: int) -> None:
        self.bucket = b
        self.bucket_trace.append(b)

    def _resize(self, old: int, new: int) -> None:
        """Move to bucket ``new``: rows [0, min(old, new)) of the current
        cache copy into ``new``'s persistent cache."""
        dst = self.decode_program(new).cache
        rows = min(old, new)
        for name in ("k", "v"):
            dst[name][:, :rows].copy_(self.cache[name][:, :rows])

    def _grow(self) -> None:
        new = self._buckets[self._buckets.index(self.bucket) + 1]
        self._resize(self.bucket, new)
        with self._lock:
            self.slots.extend([None] * (new - self.bucket))
            self._set_bucket_locked(new)

    def _maybe_shrink(self) -> None:
        with self._lock:
            if self.bucket == self._buckets[0]:
                return
            if self._low_occupancy_steps < self.cb.shrink_patience:
                return
            old = self.bucket
            new = self._buckets[self._buckets.index(old) - 1]
            # Plan compaction: every OCCUPIED slot >= new moves to a free
            # low slot.  Slots can also hold cancelled-not-yet-retired
            # sequences: if the free low slots don't cover the high
            # occupants, skip this round (the next boundary retires them).
            moves = []
            free_low = [i for i in range(new) if self.slots[i] is None]
            for i in range(new, old):
                if self.slots[i] is not None:
                    if not free_low:
                        self._low_occupancy_steps = 0
                        return
                    moves.append((i, free_low.pop(0)))
        for src, dst in moves:
            for name in ("k", "v"):
                self.cache[name][:, dst].copy_(self.cache[name][:, src])
        with self._lock:
            for src, dst in moves:
                self.slots[dst] = self.slots[src]
                self.slots[src] = None
        self._resize(old, new)
        with self._lock:
            self.slots = self.slots[:new]
            self._set_bucket_locked(new)
            self._low_occupancy_steps = 0

    def _decode_once(self) -> int:
        with self._lock:
            active = [
                (i, s) for i, s in enumerate(self.slots)
                if s is not None and not s.done and not s.cancelled
            ]
            if not active:
                return 0
            # Free rows decode token 0 at position 0: they attend to nothing
            # and their row is rewritten by the next admission's splice.
            tokens = np.zeros(self.bucket, np.int32)
            pos = np.zeros(self.bucket, np.int32)
            for i, s in active:
                tokens[i] = s.generated[-1]
                pos[i] = s.last_pos
            bucket = self.bucket
        t0 = time.perf_counter()
        prog = self.decode_program(bucket)
        logits = prog.decode(tokens, pos)
        # Sampling outside the lock; one device argmax serves every greedy
        # row, and the copy to the host waits for the step.
        greedy = torch.argmax(logits, dim=-1).tolist()
        sampled = [
            (i, s, greedy[i] if s.params.temperature == 0.0
             else self._sample(logits[i:i + 1], s.params))
            for i, s in active
        ]
        prog.decode_s += time.perf_counter() - t0
        with self._lock:
            for i, s, token in sampled:
                if self.slots[i] is not s:  # retired/preempted mid-decode
                    continue
                s.generated.append(token)
                self._push_delta_locked(s, [token])
                self._check_done_locked(s)
        return len(active)

    def _push_delta_locked(self, s: _Seq, token_ids: List[int]) -> None:
        q = self._subs.get(s.rid)
        if q is not None:
            q.put(list(token_ids))

    def _check_done_locked(self, s: _Seq) -> None:
        stop = self._stop_token(s)
        token = s.generated[-1]
        total_len = s.prompt_len + len(s.generated)
        if (
            (stop is not None and token == stop)
            or len(s.generated) >= s.params.max_tokens
            or total_len >= self.cfg.max_seq_len - 1
        ):
            s.done = True

    # --------------------------------------------------------- consumption
    def result(self, rid: int, timeout_s: float = 300.0) -> dict:
        ev = self._events.get(rid)
        if ev is None:
            with self._lock:
                done = self._finished.pop(rid, None)
            if done is not None:
                return done
            raise KeyError(f"unknown request {rid}")
        if not ev.wait(timeout=timeout_s):
            self.cancel(rid)
            with self._lock:  # drop delivery state; nobody will consume
                self._subs.pop(rid, None)
                self._events.pop(rid, None)
                self._finished.pop(rid, None)
            raise TimeoutError(f"request {rid} timed out")
        with self._lock:
            done = self._finished.pop(rid)
            self._events.pop(rid, None)
            self._subs.pop(rid, None)
        if done.get("error"):
            raise RuntimeError(done["error"])
        return done

    def stream(self, rid: int, timeout_s: float = 300.0):
        """Yield text deltas for ``rid`` as tokens land (token-boundary
        granularity).  The consumer never steps the engine."""
        q = self._subs.get(rid)
        if q is None:
            raise KeyError(f"unknown request {rid}")
        deadline = time.monotonic() + timeout_s
        emitted = 0
        try:
            while True:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(f"stream of request {rid} timed out")
                try:
                    item = q.get(timeout=min(remaining, 1.0))
                except _queue.Empty:
                    continue
                if item is None:
                    with self._lock:
                        done = self._finished.get(rid, {})
                    if done.get("error"):
                        raise RuntimeError(done["error"])
                    # Flush the tail: stop-token trimming can shorten the
                    # final text against the streamed ids.
                    tail = self.tokenizer.decode(
                        done.get("token_ids", [])[emitted:]
                    )
                    if tail:
                        yield tail
                    return
                emitted += len(item)
                text = self.tokenizer.decode(item)
                if text:
                    yield text
        finally:
            self._release(rid)

    def _release(self, rid: int) -> None:
        with self._lock:
            finished = rid in self._finished
            self._finished.pop(rid, None)
            self._subs.pop(rid, None)
            self._events.pop(rid, None)
        if not finished:
            self.cancel(rid)

    def cancel(self, rid: int) -> None:
        with self._lock:
            self._waiting = collections.deque(
                w for w in self._waiting if w[0] != rid
            )
            self._resume = collections.deque(
                w for w in self._resume if w[0] != rid
            )
            for s in self.slots:
                if s is not None and s.rid == rid:
                    s.cancelled = True  # loop frees the slot at boundary
                    return
            if rid not in self._finished:
                self._finish_rid_locked(rid, cancelled=True)

    # -------------------------------------------------------------- stats
    def has_unfinished(self) -> bool:
        with self._lock:
            return bool(self._waiting) or bool(self._resume) or any(
                s is not None for s in self.slots
            )

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            occupancy = sum(1 for s in self.slots if s is not None)
            return {
                "bucket": self.bucket,
                "occupancy": occupancy,
                "queue_depth": len(self._waiting) + len(self._resume),
                "prefix_cache": self.prefix_cache.stats(),
                **dict(self.counters),
                "programs": {
                    b: {"steps": p.steps, "decode_s": p.decode_s,
                        "capture_s": p.capture_s,
                        "graph": p.graph is not None,
                        "launches_per_step": dict(p.launches)}
                    for b, p in sorted(self._programs.items())
                },
            }


class BatchedDecodeReplica:
    """Decode replica over the resident scheduler: the continuous-batching
    successor of ``disagg.DecodeReplica``.  ``add_from_kv``/``run``/
    ``run_stream`` only enqueue and wait; the owner thread decodes."""

    def __init__(self, engine_cfg: Optional[EngineConfig] = None,
                 cb_cfg: Optional[ContinuousBatchingConfig] = None,
                 warm: bool = False, device: DeviceLike = None):
        self.engine = ContinuousBatchingEngine(
            engine_cfg or EngineConfig(), cb_cfg, device=device
        )
        if warm:
            self.engine.compile_buckets()
        self.engine.start()

    def warm(self) -> bool:
        """Make every bucket's program (serving deployments call this once
        so no capture lands inside a live request); on the running replica
        the loop thread captures and this call waits."""
        self.engine.compile_buckets()
        return True

    def add_from_kv(self, meta: Dict[str, Any]) -> int:
        """Fetch the KV pages from the prefill owner and enqueue (token-
        boundary admission into the running batch)."""
        from .disagg import fetch_prefill_kv

        k, v = fetch_prefill_kv(meta)
        return self.engine.submit_kv(meta, k, v)

    def try_add_cached(self, prompt: str,
                       params: Optional[SamplingParams] = None
                       ) -> Optional[int]:
        return self.engine.submit_cached(prompt, params)

    def generate_cached(self, prompt: str,
                        params: Optional[SamplingParams] = None,
                        timeout_s: float = 300.0) -> Optional[dict]:
        """Prefix-cache fast path: admission + completion in one call (None
        on a cache miss)."""
        rid = self.engine.submit_cached(prompt, params)
        if rid is None:
            return None
        return self.engine.result(rid, timeout_s)

    def run_from_kv(self, meta: Dict[str, Any],
                    timeout_s: float = 300.0) -> dict:
        """Disaggregated admission + completion in one call."""
        from .disagg import fetch_prefill_kv

        k, v = fetch_prefill_kv(meta)
        rid = self.engine.submit_kv(meta, k, v)
        return self.engine.result(rid, timeout_s)

    def prefix_match_depth(self, prompt: str) -> int:
        return self.engine.prefix_match_depth(prompt)

    def run(self, request_id: int, timeout_s: float = 300.0) -> dict:
        return self.engine.result(request_id, timeout_s)

    def run_stream(self, request_id: int, timeout_s: float = 300.0):
        yield from self.engine.stream(request_id, timeout_s)

    def cancel(self, request_id: int) -> None:
        self.engine.cancel(request_id)

    def stats(self) -> Dict[str, Any]:
        return self.engine.stats()

    def health_check(self) -> bool:
        if not self.engine.healthy:
            raise RuntimeError(
                "continuous-batching engine failed repeatedly; replica "
                "needs replacement"
            )
        return True

    def close(self) -> None:
        self.engine.stop()

"""PyTorch LLM engine: slot-based continuous batching over a KV cache.

Port of ``ray_tpu/llm/engine.py`` (``JaxLLMEngine``).  A fixed pool of batch
slots shares one stacked KV cache; requests join and leave the batch at
token granularity.  Model-agnostic through the ``ModelFamily`` registry.

What differs from the JAX engine, and why it computes the same thing:
  - the donated jitted programs become in-place updates of one cache;
  - a request is prefilled over its prompt's own length, not padded to
    ``max_seq_len``: causal attention gives the same values at positions
    below the length, and decode never reads a cache row before it writes
    it, so the stale rows past a new prompt are never seen;
  - sampling draws from a ``torch.Generator`` seeded from ``seed + 1``:
    greedy output is the JAX engine's, sampled output matches it only in
    distribution.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models import GPT2Config, model_family
from ..models.gpt2_decode import sample_logits
from .tokenizer import ByteTokenizer


@dataclasses.dataclass
class SamplingParams:
    max_tokens: int = 64
    temperature: float = 0.0  # 0 → greedy
    top_k: int = 0
    top_p: float = 1.0
    stop_token: Optional[int] = None  # default: tokenizer EOS


@dataclasses.dataclass
class EngineConfig:
    # Any config with a registered ModelFamily (GPT2Config, LlamaConfig, …).
    model: Any = dataclasses.field(
        default_factory=lambda: GPT2Config.tiny(vocab_size=384)
    )
    max_batch_size: int = 8
    max_seq_len: int = 128
    seed: int = 0
    # Optional: callable returning the params (a ParamTree on the engine's
    # device, e.g. from convert.params_from_jax); default random init.
    param_loader: Optional[Callable[[], Any]] = None


@dataclasses.dataclass
class EngineStats:
    """What the engine did, for throughput and step-time reports.  Each
    interval ends where the step's tokens reach the host, which waits for
    the device, so the host clock measures device work too."""

    prefills: int = 0
    prefill_s: float = 0.0
    decode_steps: int = 0
    decode_s: float = 0.0
    tokens: int = 0  # tokens generated, first tokens included


def encode_prompt(tokenizer, prompt: str, max_seq_len: int) -> List[int]:
    """Tokenize + left-truncate to the cache budget."""
    token_ids = tokenizer.encode(prompt)
    return token_ids[-(max_seq_len - 1):]


@dataclasses.dataclass
class _Slot:
    request_id: int
    prompt_len: int
    generated: List[int]
    params: SamplingParams
    done: bool = False

    @property
    def last_pos(self) -> int:
        """Cache position of the most recent token."""
        return self.prompt_len + len(self.generated) - 1


class TorchLLMEngine:
    def __init__(self, cfg: EngineConfig, tokenizer=None,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.tokenizer = tokenizer or ByteTokenizer()
        mcfg = cfg.model
        self.family = model_family(mcfg)
        if cfg.param_loader is not None:
            self.params = cfg.param_loader()
        else:
            gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
            self.params = self.family.init(gen, mcfg, self.device)
        self._gen = torch.Generator(device=self.device).manual_seed(
            cfg.seed + 1
        )
        self.cache = self.family.init_cache(
            mcfg, cfg.max_batch_size, cfg.max_seq_len, self.device
        )
        self.stats = EngineStats()
        # Per-slot state; None = free.
        self.slots: List[Optional[_Slot]] = [None] * cfg.max_batch_size
        self._next_id = itertools.count()
        self._waiting: List[tuple] = []  # (request_id, token_ids, params)
        self._waiting_kv: List[tuple] = []  # (rid, meta, k, v)
        self._finished: Dict[int, dict] = {}
        # ALL engine-state mutation serializes on this lock (see the JAX
        # engine); reentrant: generate/generate_stream hold it across
        # pop+step.
        self._step_lock = threading.RLock()

    # ----------------------------------------------------------------- queue
    def add_request(
        self, prompt: str, params: Optional[SamplingParams] = None
    ) -> int:
        params = params or SamplingParams()
        token_ids = encode_prompt(self.tokenizer, prompt, self.cfg.max_seq_len)
        with self._step_lock:
            request_id = next(self._next_id)
            self._waiting.append((request_id, token_ids, params))
        return request_id

    def add_request_from_kv(self, meta: dict, k, v) -> int:
        """Disaggregated admission: enqueue a request whose prompt was
        prefilled elsewhere.  ``meta`` carries prompt_len / first_token /
        sampling; ``k``/``v`` are the [L, 1, Hkv, S, D] KV pages of the
        prompt (S <= max_seq_len), as arrays or tensors."""
        k = torch.as_tensor(k).to(self.device, self.cache["k"].dtype)
        v = torch.as_tensor(v).to(self.device, self.cache["v"].dtype)
        with self._step_lock:
            request_id = next(self._next_id)
            self._waiting_kv.append((request_id, meta, k, v))
            return request_id

    def _free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    def _admit_kv(self):
        """Drain adopted-KV requests into free slots (no local prefill)."""
        while self._waiting_kv:
            idx = self._free_slot()
            if idx is None:
                return
            request_id, meta, k, v = self._waiting_kv.pop(0)
            s = k.shape[3]
            self.cache["k"][:, idx:idx + 1, :, :s] = k
            self.cache["v"][:, idx:idx + 1, :, :s] = v
            slot = _Slot(
                request_id=request_id,
                prompt_len=meta["prompt_len"],
                generated=[meta["first_token"]],
                params=meta["sampling"],
            )
            self.slots[idx] = slot
            self._check_done(slot, meta["first_token"])

    def _admit(self):
        self._admit_kv()
        while self._waiting:
            idx = self._free_slot()
            if idx is None:
                return
            request_id, token_ids, params = self._waiting.pop(0)
            t0 = time.perf_counter()
            tokens = torch.tensor([token_ids], dtype=torch.long,
                                  device=self.device)
            lengths = torch.tensor([len(token_ids)], device=self.device)
            # A view of row ``idx``: prefill writes the slot in place.
            row = {n: c[:, idx:idx + 1] for n, c in self.cache.items()}
            logits, _ = self.family.prefill(
                self.params, tokens, lengths, row, self.cfg.model
            )
            first = self._sample(logits, params)[0]
            self.stats.prefills += 1
            self.stats.prefill_s += time.perf_counter() - t0
            self.stats.tokens += 1
            slot = _Slot(
                request_id=request_id,
                prompt_len=len(token_ids),
                generated=[first],
                params=params,
            )
            self.slots[idx] = slot
            self._check_done(slot, first)

    def _sample(self, logits, params: SamplingParams) -> List[int]:
        out = sample_logits(logits, self._gen, params.temperature,
                            params.top_k, params.top_p)
        return out.tolist()

    def _check_done(self, slot: _Slot, token: int):
        stop = (
            slot.params.stop_token
            if slot.params.stop_token is not None
            else getattr(self.tokenizer, "EOS", None)
        )
        total_len = slot.prompt_len + len(slot.generated)
        if (
            (stop is not None and token == stop)
            or len(slot.generated) >= slot.params.max_tokens
            or total_len >= self.cfg.max_seq_len - 1
        ):
            slot.done = True

    # ------------------------------------------------------------------ step
    def step(self) -> List[dict]:
        """Admit waiting requests, run ONE decode step for all active slots,
        retire finished requests.  Returns newly finished outputs.
        Thread-safe (serialized on the engine lock)."""
        with self._step_lock:
            return self._step_locked()

    def _step_locked(self) -> List[dict]:
        self._admit()
        finished = self._retire()  # requests that finished at admission
        active = [
            (i, s) for i, s in enumerate(self.slots)
            if s is not None and not s.done
        ]
        if active:
            t0 = time.perf_counter()
            n = self.cfg.max_batch_size
            tokens = np.zeros(n, np.int64)
            pos = np.zeros(n, np.int32)
            for i, s in active:
                tokens[i] = s.generated[-1]
                pos[i] = s.last_pos
            logits, _ = self.family.decode_step(
                self.params,
                torch.from_numpy(tokens).to(self.device),
                torch.from_numpy(pos).to(self.device),
                self.cache,
                self.cfg.model,
            )
            # One sampling call per distinct sampling config, not per slot.
            groups: Dict[tuple, list] = {}
            for i, s in active:
                key = (s.params.temperature, s.params.top_k, s.params.top_p)
                groups.setdefault(key, []).append((i, s))
            for members in groups.values():
                rows = torch.tensor([i for i, _ in members],
                                    device=self.device)
                picked = self._sample(logits[rows], members[0][1].params)
                for (_, s), token in zip(members, picked):
                    s.generated.append(token)
                    self._check_done(s, token)
            self.stats.decode_steps += 1
            self.stats.decode_s += time.perf_counter() - t0
            self.stats.tokens += len(active)
        finished.extend(self._retire())
        return finished

    def _retire(self) -> List[dict]:
        out = []
        for i, s in enumerate(self.slots):
            if s is not None and s.done:
                gen = s.generated
                stop = (
                    s.params.stop_token
                    if s.params.stop_token is not None
                    else getattr(self.tokenizer, "EOS", None)
                )
                if stop is not None and gen and gen[-1] == stop:
                    gen = gen[:-1]
                result = {
                    "request_id": s.request_id,
                    "token_ids": gen,
                    "text": self.tokenizer.decode(gen),
                    "num_generated": len(s.generated),
                }
                self._finished[s.request_id] = result
                out.append(result)
                self.slots[i] = None
        return out

    def has_unfinished(self) -> bool:
        with self._step_lock:
            return bool(self._waiting) or bool(self._waiting_kv) or any(
                s is not None for s in self.slots
            )

    # ------------------------------------------------------------- generate
    def cancel_request(self, request_id: int) -> None:
        """Drop a request wherever it is (queue, slot, finished results)."""
        with self._step_lock:
            self._waiting = [
                w for w in self._waiting if w[0] != request_id
            ]
            self._waiting_kv = [
                w for w in self._waiting_kv if w[0] != request_id
            ]
            for i, slot in enumerate(self.slots):
                if slot is not None and slot.request_id == request_id:
                    self.slots[i] = None
            self._finished.pop(request_id, None)

    def generate_stream(self, prompt: str,
                        params: Optional[SamplingParams] = None,
                        timeout_s: float = 300.0):
        """Incremental generation: yields the text delta after every decode
        step for this request.  Concurrent streams share the slot pool —
        every state access holds the engine lock; only the yields happen
        outside it."""
        yield from self.stream_request(
            self.add_request(prompt, params), timeout_s
        )

    def stream_request(self, request_id: int, timeout_s: float = 300.0):
        """Stream an ALREADY-QUEUED request's deltas."""
        emitted = 0
        deadline = time.monotonic() + timeout_s
        try:
            while True:
                if time.monotonic() > deadline:
                    raise TimeoutError("generation exceeded timeout")
                delta_tokens: list = []
                with self._step_lock:
                    done = self._finished.pop(request_id, None)
                    if done is None:
                        self.step()
                        done = self._finished.pop(request_id, None)
                    if done is None:
                        slot = next(
                            (s for s in self.slots
                             if s is not None
                             and s.request_id == request_id),
                            None,
                        )
                        if slot is not None and len(slot.generated) > emitted:
                            delta_tokens = list(slot.generated[emitted:])
                            emitted += len(delta_tokens)
                if done is not None:
                    tail = self.tokenizer.decode(done["token_ids"][emitted:])
                    if tail:
                        yield tail
                    return
                if delta_tokens:
                    text = self.tokenizer.decode(delta_tokens)
                    if text:
                        yield text
        finally:
            # Timeout or abandoned consumer: release the slot/queue entry.
            self.cancel_request(request_id)

    def generate(
        self,
        prompts: List[str],
        params: Optional[SamplingParams] = None,
        timeout_s: float = 300.0,
    ) -> List[dict]:
        """Blocking batch generation; returns as soon as THIS call's
        requests are done."""
        ids = [self.add_request(p, params) for p in prompts]
        deadline = time.monotonic() + timeout_s
        while True:
            with self._step_lock:
                if all(i in self._finished for i in ids):
                    return [self._finished.pop(i) for i in ids]
                self.step()
            if time.monotonic() > deadline:
                raise TimeoutError("generation exceeded timeout")

"""OpenAI-compatible LLM serving on top of ``ray_tpu_torch.serve``: port
of ``ray_tpu/llm/serve_app.py``.

Reference: ray ``python/ray/llm/_internal/serve/core/server/`` (the
OpenAI-compatible router over vLLM deployments) and ``serve/llm``'s
``build_openai_app``.  The deployment holds one ``TorchLLMEngine`` per
replica (a card, or a fraction of one, each via ``num_gpus``: the lease
sets the replica's ``CUDA_VISIBLE_DEVICES``); ``@serve.batch`` coalesces
concurrent single-prompt calls so they enter the engine's continuous batch
together.  Endpoints: ``/v1/completions`` and ``/v1/chat/completions``
via the serve HTTP proxy (the raw JSON body arrives as the call's single
argument).

Every engine runs on the card unless ``device`` names another device
(``"cpu"`` in tests); with no card and no ``device``, building an engine
raises.
"""

from __future__ import annotations

import os
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

from .. import serve
from ..device import DeviceLike
from .engine import EngineConfig, SamplingParams, TorchLLMEngine


def _sampling_from_request(body: Dict[str, Any]) -> SamplingParams:
    return SamplingParams(
        max_tokens=int(body.get("max_tokens", 64)),
        temperature=float(body.get("temperature", 0.0)),
        top_p=float(body.get("top_p", 1.0)),
    )


@serve.deployment(name="LLMServer", ray_actor_options={"num_cpus": 1})
class LLMServer:
    """One engine per replica; requests batch dynamically."""

    def __init__(self, engine_cfg: Optional[EngineConfig] = None,
                 model_name: str = "ray-tpu-gpt2",
                 device: DeviceLike = None):
        self.engine = TorchLLMEngine(engine_cfg or EngineConfig(),
                                     device=device)
        self.model_name = model_name

    @serve.batch(max_batch_size=8, batch_wait_timeout_s=0.02)
    async def _generate_batch(self, requests: List[tuple]):
        """requests: [(prompt, SamplingParams)] — one engine pass serves
        them all (the engine's slot pool IS the batch).  All engine-state
        access holds the engine lock: SSE streams may be stepping the same
        engine from replica threads concurrently."""
        ids = [
            self.engine.add_request(prompt, params)
            for prompt, params in requests
        ]
        while True:
            with self.engine._step_lock:
                if all(i in self.engine._finished for i in ids):
                    return [self.engine._finished.pop(i) for i in ids]
                self.engine.step()

    async def __call__(self, body: Dict[str, Any]):
        """OpenAI completions-ish: dispatch on request shape.  With
        ``"stream": true`` the proxy calls this through the streaming path
        and SSE-frames each yielded chunk (OpenAI ``stream`` semantics)."""
        if body.get("stream") is True:
            return self.stream_chunks(body)
        if "messages" in body:
            return await self.chat(body)
        return await self.completions(body)

    def stream_chunks(self, body: Dict[str, Any]):
        """Sync generator of OpenAI-style streaming chunks (per decode
        step).  Runs on a replica thread via handle_request_streaming."""
        yield from _stream_openai_chunks(
            self.engine.generate_stream(
                _prompt_from_body(body), _sampling_from_request(body)
            ),
            body, self.model_name,
        )

    async def completions(self, body: Dict[str, Any]) -> Dict[str, Any]:
        prompt = body.get("prompt", "")
        out = await self._generate_batch((prompt, _sampling_from_request(body)))
        return _unary_response(
            body, out, self.model_name, chat=False,
            prompt_tokens=len(self.engine.tokenizer.encode(prompt)),
        )

    async def chat(self, body: Dict[str, Any]) -> Dict[str, Any]:
        prompt = _prompt_from_body(body)
        out = await self._generate_batch((prompt, _sampling_from_request(body)))
        return _unary_response(
            body, out, self.model_name, chat=True,
            prompt_tokens=len(self.engine.tokenizer.encode(prompt)),
        )


# How often a disaggregated app's prefill and decode actors look for their
# replica among the cluster's live actors.
OWNER_POLL_S = 1.0


def _current_actor_id() -> Optional[str]:
    """The id (hex) of the actor this code runs in, or None."""
    from ..core.core_worker import try_global_worker

    spec = getattr(try_global_worker(), "actor_spec", None)
    return None if spec is None else spec.actor_id.hex()


def _exit_with(owner_id: Optional[str]) -> None:
    """Start a daemon thread that ends this process once actor
    ``owner_id`` is dead or gone from the cluster's state.  The serve
    controller kills a deleted replica without a teardown call, and an
    actor shares its fate with its job only, so the replica's children
    end themselves; the node agent then returns their leases."""
    if owner_id is None:
        return

    def watch():
        from ..util.state import get_actor

        while True:
            time.sleep(OWNER_POLL_S)
            try:
                row = get_actor(owner_id)
            except Exception:  # noqa: BLE001 — control plane busy: next poll
                continue
            if row is None or row.get("state") == "DEAD":
                os._exit(0)

    threading.Thread(target=watch, name="owner-watch", daemon=True).start()


class _OwnedByReplica:
    """Mixin of the disaggregated app's prefill and decode actors:
    ``exit_with(owner_id)`` makes the actor exit once the replica whose
    actor id that is has died (``_exit_with``)."""

    def exit_with(self, owner_id: Optional[str]) -> None:
        _exit_with(owner_id)


def _hand_over(children) -> None:
    """Tell ``children`` this replica's actor id once it has one: the
    worker records an actor's id only after its constructor returns, so
    a thread waits for it (a minute at most: outside an actor there is
    none, and nothing to watch)."""

    def run():
        deadline = time.monotonic() + 60.0
        while (owner := _current_actor_id()) is None:
            if time.monotonic() > deadline:
                return
            time.sleep(0.05)
        for child in children:
            child.exit_with.remote(owner)

    threading.Thread(target=run, name="hand-over", daemon=True).start()


@serve.deployment(name="LLMDisaggServer", ray_actor_options={"num_cpus": 0})
class LLMDisaggServer:
    """OpenAI endpoints over the disaggregated continuous-batching path.

    One replica of this deployment owns a prefill pool + a
    continuous-batching decode pool (``llm.continuous_batching.
    BatchedDecodeReplica``), the pools' actors leasing equal shares of one
    card, and routes through ``DisaggRouter`` with
    prefix-cache-aware decode routing.  Streaming requests flow proxy →
    this replica (``serve.request.stream`` span) → prefill actor → decode
    actor, each hop inheriting the request's trace context, so one
    stitched cluster trace (returned in ``x-ray-tpu-trace-id``) covers
    the whole batched streaming request.  The actors end themselves once
    this replica is dead (``_OwnedByReplica``), so deleting the app frees
    their leases."""

    def __init__(self, engine_cfg: Optional[EngineConfig] = None,
                 model_name: str = "ray-tpu-gpt2",
                 num_prefill: int = 1, num_decode: int = 1,
                 cb_cfg=None, num_cpus_per_replica: float = 0.0,
                 device: DeviceLike = None):
        import ray_tpu_torch
        from .continuous_batching import BatchedDecodeReplica
        from .disagg import DisaggRouter, PrefillReplica

        from .tokenizer import ByteTokenizer

        engine_cfg = engine_cfg or EngineConfig()
        self.model_name = model_name
        # Same default tokenizer the replica engines use — usage token
        # accounting must match the monolithic server's.
        self._tokenizer = ByteTokenizer()
        # Both pools share one card, each actor an equal share of it.
        gpu_share = 1.0 / (num_prefill + num_decode)
        Pre = ray_tpu_torch.remote(
            num_cpus=num_cpus_per_replica, num_gpus=gpu_share
        )(type("OwnedPrefillReplica", (_OwnedByReplica, PrefillReplica), {}))
        # max_concurrency is load-bearing: run()/run_stream() calls park
        # on per-request events while the resident loop decodes; a slot-
        # starved decode actor would serialize its clients.
        Dec = ray_tpu_torch.remote(
            num_cpus=num_cpus_per_replica, num_gpus=gpu_share,
            max_concurrency=64,
        )(type("OwnedBatchedDecodeReplica",
               (_OwnedByReplica, BatchedDecodeReplica), {}))
        self._prefill = [
            Pre.remote(engine_cfg, device=device) for _ in range(num_prefill)
        ]
        self._decode = [
            Dec.remote(engine_cfg, cb_cfg, device=device)
            for _ in range(num_decode)
        ]
        _hand_over(self._prefill + self._decode)
        # Fire-and-forget bucket pre-compile: on a loaded box the full
        # warm can take minutes, and blocking THIS replica's constructor
        # or health checks on it makes the serve reconciler strike out a
        # merely-compiling replica (kill → fresh children → more compile
        # load — a death spiral).  Early requests may pay an on-demand
        # bucket compile instead; the refs are kept so the work isn't
        # cancelled.
        self._warm_refs = [d.warm.remote() for d in self._decode]
        self.router = DisaggRouter(self._prefill, self._decode)

    def __call__(self, body: Dict[str, Any]):
        # Deliberately sync: the router blocks on actor round trips, so
        # the replica runs this on an executor thread (RTL005 — blocking
        # work must stay off the replica event loop); the streaming case
        # returns a sync generator the streaming path pulls on a thread.
        if body.get("stream") is True:
            return self.stream_chunks(body)
        prompt = _prompt_from_body(body)
        out = self.router.generate(prompt, _sampling_from_request(body))
        return _unary_response(
            body, out, self.model_name, chat="messages" in body,
            prompt_tokens=len(self._tokenizer.encode(prompt)),
        )

    def stream_chunks(self, body: Dict[str, Any]):
        """Sync generator of OpenAI streaming chunks over the router's
        disaggregated stream (runs on a replica thread; actor hops inside
        inherit the serve.request.stream trace context)."""
        yield from _stream_openai_chunks(
            self.router.stream(
                _prompt_from_body(body), _sampling_from_request(body)
            ),
            body, self.model_name,
        )

    def stats(self) -> Dict[str, Any]:
        import ray_tpu_torch

        return {
            "router": {"hits": self.router.router_hits,
                       "misses": self.router.router_misses},
            "decode": [
                ray_tpu_torch.get(d.stats.remote(), timeout=30)
                for d in self._decode
            ],
        }

    def check_health(self):
        # Deliberately does NOT round-trip to the child actors: a decode
        # replica busy with a bucket compile holds its executor for tens
        # of seconds, and a blocking probe here would convert "compiling"
        # into health strikes against THIS replica (the reconciler would
        # kill it and orphan the children).  Child failures surface as
        # request errors instead.
        return True


def _prompt_from_body(body: Dict[str, Any]) -> str:
    if "messages" in body:
        return "\n".join(
            f"{m.get('role', 'user')}: {m.get('content', '')}"
            for m in body.get("messages", [])
        ) + "\nassistant:"
    return body.get("prompt", "")


def _chunk_framer(body: Dict[str, Any], model_name: str, chat: bool):
    cid = f"{'chatcmpl' if chat else 'cmpl'}-{uuid.uuid4().hex[:12]}"
    created = int(time.time())
    obj = "chat.completion.chunk" if chat else "text_completion"

    def frame(choice):
        return {
            "id": cid,
            "object": obj,
            "created": created,
            "model": body.get("model", model_name),
            "choices": [choice],
        }

    return frame


def _stream_openai_chunks(deltas, body: Dict[str, Any], model_name: str):
    """Frame an engine/router delta stream as OpenAI streaming chunks —
    the ONE chunk shape both serve deployments emit.  The terminal
    finish_reason chunk is always yielded (OpenAI semantics), which also
    keeps the stream observable when every generated token decodes to
    empty text (the byte tokenizer drops ids outside its range) — SSE
    consumers never see a bare [DONE] with zero chunks."""
    chat = "messages" in body
    frame = _chunk_framer(body, model_name, chat)
    for delta in deltas:
        if chat:
            yield frame({"index": 0, "delta": {"content": delta},
                         "finish_reason": None})
        else:
            yield frame({"index": 0, "text": delta, "finish_reason": None})
    if chat:
        yield frame({"index": 0, "delta": {}, "finish_reason": "stop"})
    else:
        yield frame({"index": 0, "text": "", "finish_reason": "stop"})


def _unary_response(body: Dict[str, Any], out: Dict[str, Any],
                    model_name: str, chat: bool,
                    prompt_tokens: int = 0) -> Dict[str, Any]:
    usage = {
        "completion_tokens": out["num_generated"],
        "prompt_tokens": prompt_tokens,
        "total_tokens": prompt_tokens + out["num_generated"],
    }
    if chat:
        return {
            "id": f"chatcmpl-{uuid.uuid4().hex[:12]}",
            "object": "chat.completion",
            "created": int(time.time()),
            "model": body.get("model", model_name),
            "choices": [
                {
                    "index": 0,
                    "message": {"role": "assistant", "content": out["text"]},
                    "finish_reason": "stop",
                }
            ],
            "usage": usage,
        }
    return {
        "id": f"cmpl-{uuid.uuid4().hex[:12]}",
        "object": "text_completion",
        "created": int(time.time()),
        "model": body.get("model", model_name),
        "choices": [
            {"index": 0, "text": out["text"], "finish_reason": "stop"}
        ],
        "usage": usage,
    }


def build_disagg_openai_app(
    engine_cfg: Optional[EngineConfig] = None,
    model_name: str = "ray-tpu-gpt2",
    num_prefill: int = 1,
    num_decode: int = 1,
    cb_cfg=None,
    device: DeviceLike = None,
):
    """OpenAI app over the prefill/decode + continuous-batching path;
    expose via ``serve.run`` + ``serve.start_http_proxy`` like
    ``build_openai_app`` (same ``/v1`` endpoints, ``stream: true``
    SSE included).  The prefill and decode actors share one card equally."""
    d = LLMDisaggServer.options(route_prefix="/v1")
    return d.bind(engine_cfg, model_name, num_prefill, num_decode, cb_cfg,
                  device=device)


def build_openai_app(
    engine_cfg: Optional[EngineConfig] = None,
    model_name: str = "ray-tpu-gpt2",
    num_replicas: int = 1,
    num_gpus: float = 0,
    device: DeviceLike = None,
):
    """Build the Serve application; run with ``serve.run(app)`` and expose
    via ``serve.start_http_proxy()`` — then POST to ``/v1/completions`` or
    ``/v1/chat/completions``.  ``num_gpus`` leases each replica a card or
    a fraction of one; a replica with no lease sees no card."""
    opts: Dict[str, Any] = {"num_cpus": 1}
    if num_gpus:
        opts = {"num_cpus": 0, "num_gpus": num_gpus}
    d = LLMServer.options(
        num_replicas=num_replicas,
        ray_actor_options=opts,
        route_prefix="/v1",
    )
    return d.bind(engine_cfg, model_name, device=device)

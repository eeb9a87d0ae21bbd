"""The port's OpenAI apps and the actor routes of disaggregated serving,
against the JAX package, on the CPU in f32.

- The OpenAI app (``build_openai_app``) runs in a JAX cluster, which then
  shuts down, and in a port cluster, on the same weights (the JAX engine's,
  through ``params_from_jax``, shipped by value in the engine config).
  Completions, chat and SSE, through the handle and through the HTTP
  proxy: the port's responses, with ``id`` and ``created`` set aside,
  equal the JAX app's, and so do the disaggregated app's
  (``build_disagg_openai_app``), whose streamed request's trace spans at
  least 3 processes.
- ``DisaggRouter`` over prefill and decode actors (2 prefill + 2 decode,
  plain and batched decode replicas), both model families:
  ``generate_many``, ``generate`` and ``stream`` give the JAX monolithic
  engine's greedy tokens and text exactly, and a decode actor's
  ``run_stream`` deltas join to its text.
- GPU leases: ``build_openai_app(num_gpus=1)`` places its replica under
  ``CUDA_VISIBLE_DEVICES="0"`` and the disaggregated app's two actors take
  half a card each (the cluster declares one GPU; no card is present).
"""

import dataclasses
import json
import time
import urllib.request

import jax
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu.llm as jllm
import ray_tpu.models as jm
import ray_tpu.serve as jserve
import ray_tpu_torch
import ray_tpu_torch.serve as tserve
from ray_tpu_torch import models as tm
from ray_tpu_torch.convert import params_from_jax
from ray_tpu_torch.llm import (
    BatchedDecodeReplica,
    ByteTokenizer,
    DecodeReplica,
    DisaggRouter,
    EngineConfig,
    PrefillReplica,
    SamplingParams,
    build_disagg_openai_app,
    build_openai_app,
)
from ray_tpu_torch.llm import serve_app
from ray_tpu_torch.util import obs, tracing

TIMEOUT = 120
MAX_SEQ = 64
FAMILIES = ["gpt2", "llama"]
PROMPTS = ["hello world", "jax on tpu", "disaggregate me", "one more prompt"]
BODIES = {
    "completion": {"prompt": "hello world", "max_tokens": 8},
    "chat": {"messages": [{"role": "system", "content": "be brief"},
                          {"role": "user", "content": "hi there"}],
             "max_tokens": 8},
    "completion_stream": {"prompt": "stream me", "max_tokens": 8,
                          "stream": True},
    "chat_stream": {"messages": [{"role": "user", "content": "go"}],
                    "max_tokens": 8, "stream": True},
}


def free_port() -> int:
    """A port no other process holds now: bound to port 0, then closed."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def wait_for(pred, timeout=90.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        value = pred()
        if value:
            return value
        time.sleep(0.1)
    raise AssertionError(f"timed out waiting for {what}")


def _model_cfgs(name):
    if name == "gpt2":
        return (jm.GPT2Config.tiny(vocab_size=384, max_seq=MAX_SEQ,
                                   dtype="float32"),
                tm.GPT2Config.tiny(vocab_size=384, max_seq=MAX_SEQ,
                                   dtype="float32"))
    return (jm.LlamaConfig.tiny(vocab_size=384, dtype="float32"),
            tm.LlamaConfig.tiny(vocab_size=384, dtype="float32"))


class Family:
    """One family's JAX monolithic engine and a port engine config over
    its weights."""

    def __init__(self, name):
        self.jcfg, self.tcfg = _model_cfgs(name)
        self.jax_engine = jllm.JaxLLMEngine(jllm.EngineConfig(
            model=self.jcfg, max_batch_size=4, max_seq_len=MAX_SEQ, seed=0))
        self.tree = jax.tree.map(np.asarray, self.jax_engine.params)

    def cfg(self, max_batch_size=4):
        params = params_from_jax(self.tree, self.tcfg, device="cpu")
        return EngineConfig(model=self.tcfg, max_batch_size=max_batch_size,
                            max_seq_len=MAX_SEQ, seed=0,
                            param_loader=lambda: params)

    def mono(self, prompts, max_tokens):
        return self.jax_engine.generate(
            prompts, jllm.SamplingParams(max_tokens=max_tokens))


@pytest.fixture(scope="module")
def families():
    return {name: Family(name) for name in FAMILIES}


# ------------------------------------------------------------ the apps
def _sans_ids(x):
    """An OpenAI response or chunk without the fields that differ from
    call to call."""
    return {k: v for k, v in x.items() if k not in ("id", "created")}


def _joined(chunks):
    choices = [c["choices"][0] for c in chunks]
    return "".join(ch["text"] if "text" in ch
                   else ch["delta"].get("content", "") for ch in choices)


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=TIMEOUT)


def _sse(resp):
    frames = [line[len("data: "):] for line in resp.read().decode().splitlines()
              if line.startswith("data: ")]
    assert frames[-1] == "[DONE]", frames
    return [json.loads(f) for f in frames[:-1]]


def _drive_app(serve, handle, route):
    """Every body through the handle and through the proxy; responses
    without their ids.  Returns (results, a streamed request's trace id)."""
    out = {}
    for name, body in BODIES.items():
        if body.get("stream"):
            out[f"handle/{name}"] = [
                _sans_ids(c) for c in handle.options(stream=True).remote(body)]
        else:
            out[f"handle/{name}"] = _sans_ids(
                handle.remote(body).result(timeout=TIMEOUT))
    url = serve.start_http_proxy(port=free_port())
    trace_id = None
    try:
        for name, body in BODIES.items():
            path = url + route + ("/chat/completions" if "messages" in body
                                  else "/completions")
            with _post(path, body) as resp:
                if body.get("stream"):
                    trace_id = resp.headers["x-ray-tpu-trace-id"]
                    out[f"http/{name}"] = [_sans_ids(c) for c in _sse(resp)]
                else:
                    out[f"http/{name}"] = _sans_ids(
                        json.loads(resp.read())["result"])
    finally:
        serve.stop_http_proxy()
    return out, trace_id


@pytest.fixture(scope="module")
def jax_apps(families):
    """The JAX package's two OpenAI apps' answers, on the JAX engine's own
    weights."""
    cfg = jllm.EngineConfig(model=families["gpt2"].jcfg, max_batch_size=4,
                            max_seq_len=MAX_SEQ, seed=0)
    ray_tpu.init(num_cpus=8)
    try:
        out = {}
        for name, build in (("LLMServer", jllm.build_openai_app),
                            ("LLMDisaggServer", jllm.build_disagg_openai_app)):
            out[name] = _drive_app(jserve, jserve.run(build(cfg)), "/v1")[0]
            jserve.delete(name)
        return out
    finally:
        jserve.shutdown()
        ray_tpu.shutdown()


@pytest.fixture(scope="module")
def port(jax_apps):
    """The port's cluster, with one GPU declared (no card is present), once
    the JAX one is down."""
    ray_tpu_torch.init(num_cpus=8, resources={"GPU": 1})
    yield ray_tpu_torch
    tserve.shutdown()
    ray_tpu_torch.shutdown()


def test_openai_app_answers_as_the_jax_app(families, jax_apps, port):
    handle = tserve.run(build_openai_app(families["gpt2"].cfg(),
                                         device="cpu"))
    got, _ = _drive_app(tserve, handle, "/v1")
    tserve.delete("LLMServer")
    assert got == jax_apps["LLMServer"]
    unary = got["handle/completion"]
    assert unary["object"] == "text_completion"
    n_prompt = len(ByteTokenizer().encode("hello world"))
    assert unary["usage"] == {"completion_tokens": 8,
                              "prompt_tokens": n_prompt,
                              "total_tokens": 8 + n_prompt}
    assert got["handle/chat"]["object"] == "chat.completion"
    for name in ("completion_stream", "chat_stream"):
        chunks = got[f"handle/{name}"]
        assert chunks[-1]["choices"][0]["finish_reason"] == "stop"
        assert all(c["choices"][0]["finish_reason"] is None
                   for c in chunks[:-1])


def test_gpu_lease_places_the_replica_on_card_0(families, port):
    """``num_gpus=1`` leases the replica the one declared card; the
    replica's engine still runs where ``device`` says."""

    class Probe(serve_app.LLMServer.func_or_class):
        def placement(self):
            import os

            return (os.environ.get("CUDA_VISIBLE_DEVICES"),
                    str(self.engine.device))

    app = build_openai_app(families["gpt2"].cfg(), num_gpus=1, device="cpu")
    app = dataclasses.replace(app, deployment=dataclasses.replace(
        app.deployment, func_or_class=Probe))
    assert app.deployment.ray_actor_options == {"num_cpus": 0,
                                                "num_gpus": 1}
    handle = tserve.run(app)
    try:
        assert handle.placement.remote().result(timeout=TIMEOUT) == ("0",
                                                                     "cpu")
        # The resource view is refreshed on a period, which a loaded host
        # stretches: wait for the lease to show rather than read it once.
        wait_for(lambda: port.available_resources().get("GPU", 0.0) == 0.0,
                 what="the replica's GPU lease in available_resources()")
    finally:
        tserve.delete("LLMServer")


def test_engines_need_a_card_unless_told_cpu(families, port, monkeypatch):
    """With no card and no ``device``, the app's engines raise: in the
    replica's constructor, and in the disaggregated app's actors, whose
    failure reaches the request."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_app.LLMServer.func_or_class(families["gpt2"].cfg())
    handle = tserve.run(build_disagg_openai_app(families["gpt2"].cfg()))
    try:
        with pytest.raises(Exception, match="device='cpu'"):
            handle.remote(BODIES["completion"]).result(timeout=TIMEOUT)
    finally:
        tserve.delete("LLMDisaggServer")


def test_disagg_app_answers_as_the_jax_app(families, jax_apps, port):
    """Runs last of the apps: deleting the app leaves its two actors (and
    their leases) alive until the job ends, as in the JAX package, where
    an actor shares its fate with its job only."""
    handle = tserve.run(build_disagg_openai_app(families["gpt2"].cfg(),
                                                device="cpu"))
    try:
        # The prefill and the decode actor hold half a card each.
        wait_for(lambda: port.available_resources().get("GPU", 0.0) == 0.0,
                 what="the two actors' GPU leases")
        got, trace_id = _drive_app(tserve, handle, "/v1")
        stats = handle.stats.remote().result(timeout=TIMEOUT)
        # proxy -> server replica -> prefill and decode actors: one trace,
        # whose replica spans flush after the stream ends.
        wait_for(lambda: len(obs.trace_processes(trace_id)) >= 3
                 and {"serve.http.stream", "serve.request.stream"} <= {
                     s["name"] for s in tracing.get_trace(trace_id,
                                                          timeout=30)},
                 what="a stitched trace over 3 processes")
    finally:
        tserve.delete("LLMDisaggServer")
    assert got == jax_apps["LLMDisaggServer"]
    # Greedy, so the same text as the monolithic app; the streams' deltas
    # come per token here and per engine step there.
    mono = jax_apps["LLMServer"]
    for key, want in mono.items():
        if key.endswith("_stream"):
            assert _joined(got[key]) == _joined(want), key
        else:
            assert got[key] == want, key
    assert stats["router"]["hits"] + stats["router"]["misses"] == 8
    assert stats["decode"][0]["retired"] >= 4


# ------------------------------------------------- actor routes, 2P2D
@pytest.mark.parametrize("name", FAMILIES)
def test_actor_disagg_matches_monolithic(families, port, name):
    fam = families[name]
    mono = fam.mono(PROMPTS, 12)
    sp = SamplingParams(max_tokens=12, temperature=0.0)
    cfg = fam.cfg()
    Pre = port.remote(num_cpus=0)(PrefillReplica)
    Dec = port.remote(num_cpus=0, max_concurrency=4)(DecodeReplica)
    Batched = port.remote(num_cpus=0, max_concurrency=64)(
        BatchedDecodeReplica)
    prefill = [Pre.remote(cfg, device="cpu") for _ in range(2)]
    plain = [Dec.remote(cfg, device="cpu") for _ in range(2)]
    batched = [Batched.remote(cfg, device="cpu") for _ in range(2)]
    try:
        for decode in (plain, batched):
            router = DisaggRouter(prefill, decode)
            outs = router.generate_many(PROMPTS, sp, timeout_s=TIMEOUT)
            assert [o["token_ids"] for o in outs] == [
                m["token_ids"] for m in mono]
            assert [o["text"] for o in outs] == [m["text"] for m in mono]
            for prompt, want in zip(PROMPTS[:2], mono):
                got = router.generate(prompt, sp, timeout_s=TIMEOUT)
                assert got["token_ids"] == want["token_ids"], prompt
            assert "".join(router.stream(PROMPTS[2], sp,
                                         timeout_s=TIMEOUT)) == mono[2]["text"]
            assert router.router_hits == 3 and router.router_misses == 4
        # The batched replicas admitted the repeats from their prefix
        # caches: the fused cached round trip, no prefill.
        hits = sum(port.get(d.stats.remote(), timeout=TIMEOUT)[
            "prefix_cache"]["hits"] for d in batched)
        assert hits == 3
        # A decode actor streams deltas that join to the request's text.
        meta = port.get(prefill[0].prefill.remote(PROMPTS[0], sp),
                        timeout=TIMEOUT)
        rid = port.get(plain[0].add_from_kv.remote(meta), timeout=TIMEOUT)
        gen = plain[0].run_stream.options(num_returns="streaming").remote(rid)
        deltas = [port.get(ref, timeout=TIMEOUT) for ref in gen]
        assert len(deltas) >= 2 and "".join(deltas) == mono[0]["text"]
    finally:
        for actor in prefill + plain + batched:
            port.kill(actor)

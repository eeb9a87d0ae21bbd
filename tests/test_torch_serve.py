"""The port's Serve layer against the JAX package's, on the CPU.

The same serve programs (a deployment and its handle, ``@serve.batch``,
multiplexing, local testing mode, a long-poll push of replicas and routes,
the HTTP proxy with SSE, a health-check replacement, and the remediation
scale-up) run through ``ray_tpu.serve`` and through
``ray_tpu_torch.serve``: one cluster per package for the module, never
both at once, the JAX one shut down before the port's starts.  Results
must be equal, and equal to what the programs expect.  No program bounds
a wall-clock time.

Then the serving path's flight-recorder hooks: a continuous-batching step,
prefix lookups on the engine and on the router, a preemption and a stream
record the same series in both packages' metric registries.
"""

import importlib
import json
import os
import socket
import time
import urllib.error
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
from ray_tpu.llm import continuous_batching as jcb
from ray_tpu.llm import disagg as jdisagg
from ray_tpu.util import metrics as jmetrics
from ray_tpu_torch import models as tm
from ray_tpu_torch.convert import params_from_jax
from ray_tpu_torch.llm import continuous_batching as tcb
from ray_tpu_torch.llm import disagg as tdisagg
from ray_tpu_torch.llm import engine as tengine
from ray_tpu_torch.llm.engine import EngineConfig, SamplingParams
from ray_tpu_torch.util import metrics as tmetrics

TIMEOUT = 60
# A replica whose health check times out 3 times in a row is replaced; one
# that raises is replaced at once (serve/controller.py:_check_health).
SYSTEM_CONFIG = {"serve_health_check_timeout_s": 0.5,
                 "serve_health_failure_threshold": 3}


def free_port() -> int:
    """A port no other process holds now: bound to port 0, then closed
    (``start_http_proxy(port=0)`` would report port 0 in its URL)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def wait_for(pred, timeout=60.0, what="condition"):
    """Poll ``pred`` until it is true; the deadline guards a hang only."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        value = pred()
        if value:
            return value
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
        return resp.read().decode()


# ------------------------------------------------------------ the programs
# Each takes the package, its serve module and a scratch directory, and
# deletes what it deploys.  Deployments defined here travel to the
# replicas by value.
def prog_deployment(rt, serve, tmp):
    @serve.deployment
    def doubler(x):
        return x * 2

    @serve.deployment(name="adder")
    class Adder:
        def __init__(self, base):
            self.base = base

        def __call__(self, x):
            return self.base + x

        def peek(self):
            return self.base

    doubled = serve.run(doubler.bind()).remote(21).result(timeout=TIMEOUT)
    adder = serve.run(Adder.bind(100))
    out = {"doubled": doubled,
           "added": adder.remote(1).result(timeout=TIMEOUT),
           "peek": adder.peek.remote().result(timeout=TIMEOUT)}
    st = serve.status()
    out["replicas"] = {k: st[k]["num_replicas"] for k in ("doubler", "adder")}
    out["deleted"] = [serve.delete("doubler"), serve.delete("adder")]
    out["left"] = sorted(serve.status())
    return out


def prog_batch(rt, serve, tmp):
    @serve.deployment(name="batched", max_ongoing_requests=32)
    class Batched:
        def __init__(self):
            self.sizes = []

        @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.05)
        async def __call__(self, xs):
            self.sizes.append(len(xs))
            return [x * 10 for x in xs]

        def seen(self):
            return self.sizes

    handle = serve.run(Batched.bind())
    responses = [handle.remote(i) for i in range(8)]
    values = [r.result(timeout=TIMEOUT) for r in responses]
    sizes = handle.seen.remote().result(timeout=TIMEOUT)
    serve.delete("batched")
    return {"values": values, "batched": max(sizes) > 1,
            "within_max": max(sizes) <= 4, "total": sum(sizes)}


def prog_multiplex(rt, serve, tmp):
    @serve.deployment(name="MultiModel", ray_actor_options={"num_cpus": 0})
    class MultiModel:
        def __init__(self):
            self.loads = []

        @serve.multiplexed(max_num_models_per_replica=2)
        async def get_model(self, model_id: str):
            self.loads.append(model_id)
            return {"id": model_id}

        async def __call__(self, x):
            model = await self.get_model(serve.get_multiplexed_model_id())
            return f"{model['id']}:{x}"

        def loaded(self):
            return self.loads

    handle = serve.run(MultiModel.bind())
    ha = handle.options(multiplexed_model_id="ma")
    hb = handle.options(multiplexed_model_id="mb")
    calls = [ha.remote(1).result(timeout=TIMEOUT),
             hb.remote(2).result(timeout=TIMEOUT),
             ha.remote(3).result(timeout=TIMEOUT)]
    loads = serve.get_handle("MultiModel").loaded.remote().result(
        timeout=TIMEOUT)
    serve.delete("MultiModel")
    return {"calls": calls, "loads": loads}


def prog_local_mode(rt, serve, tmp):
    local_mode = importlib.import_module(serve.__name__ + ".local_mode")

    @serve.deployment
    class Counter:
        def __init__(self):
            self.v = 0

        def __call__(self):
            self.v += 1
            return self.v

    @serve.deployment
    class Model:
        def __call__(self, x):
            return x + 1

    @serve.deployment
    class Pipeline:
        def __init__(self, model):
            self.model = model

        def __call__(self, x):
            return self.model.remote(x).result() * 10

    try:
        counter = serve.run(Counter.bind(), local_testing_mode=True)
        counts = [counter.remote().result() for _ in range(3)]
        pipeline = serve.run(Pipeline.bind(Model.bind()),
                             local_testing_mode=True)
        return {"counts": counts, "composed": pipeline.remote(1).result()}
    finally:
        local_mode.shutdown_local()


def prog_long_poll(rt, serve, tmp):
    long_poll = importlib.import_module(serve.__name__ + ".long_poll")

    @serve.deployment(name="Echo")
    class Echo:
        def __call__(self, x):
            return x

    # A fresh client: the process's client may be parked in a listen on
    # the keys of earlier programs' deleted deployments, and takes a new
    # key only when that listen returns (up to LISTEN_TIMEOUT_S).
    long_poll.reset_client()
    handle = serve.run(Echo.options(num_replicas=1).bind())
    first = handle.remote("a").result(timeout=TIMEOUT)
    lp = long_poll.long_poll_client()
    lp.register(("routes",))
    serve.run(Echo.options(num_replicas=2).bind())
    pushed = wait_for(lambda: len(lp.get(("replicas", "Echo")) or []) == 2
                      and lp.get(("replicas", "Echo")), what="replica push")
    routes = wait_for(lambda: "/Echo" in (lp.get(("routes",)) or {})
                      and lp.get(("routes",)), what="route push")
    handle._refresh()
    out = {"first": first, "pushed_replicas": len(pushed),
           "handle_replicas": len(handle._replicas),
           "route": routes["/Echo"],
           "after_push": handle.remote("b").result(timeout=TIMEOUT)}
    serve.delete("Echo")
    wait_for(lambda: "/Echo" not in lp.get(("routes",)),
             what="route removal push")
    return out


def prog_http_proxy(rt, serve, tmp):
    @serve.deployment(name="httpd", route_prefix="/compute")
    def compute(x):
        return {"y": x["a"] + x["b"]}

    @serve.deployment(name="Ticker", ray_actor_options={"num_cpus": 0})
    class Ticker:
        async def __call__(self, body):
            if body.get("stream") is True:
                def gen():
                    for i in range(3):
                        yield {"tick": i}

                return gen()
            return {"all": 3}

    serve.run(compute.bind())
    serve.run(Ticker.bind(), route_prefix="/tick")
    url = serve.start_http_proxy(port=free_port())
    try:
        out = {"compute": json.loads(post(url + "/compute",
                                          {"a": 2, "b": 3}))}
        try:
            post(url + "/nope", {})
            out["unknown"] = None
        except urllib.error.HTTPError as e:
            out["unknown"] = e.code
        raw = post(url + "/tick", {"stream": True})
        out["sse"] = [line[len("data: "):] for line in raw.splitlines()
                      if line.startswith("data: ")]
        out["unary"] = json.loads(post(url + "/tick", {}))
    finally:
        serve.stop_http_proxy()
    serve.delete("httpd")
    serve.delete("Ticker")
    return out


def prog_health(rt, serve, tmp):
    born = os.path.join(tmp, "born")

    @serve.deployment(name="Sick", ray_actor_options={"num_cpus": 0})
    class Sick:
        """Its first incarnation fails every health check."""

        def __init__(self, born):
            import os

            self.first = not os.path.exists(born)
            with open(born, "a") as f:
                f.write(f"{os.getpid()}\n")

        def check_health(self):
            if self.first:
                raise RuntimeError("unhealthy")

        def pid(self):
            import os

            return os.getpid()

    serve.run(Sick.bind(born))

    def births():
        if not os.path.exists(born):
            return []
        with open(born) as f:
            return [int(p) for p in f.read().split()]

    wait_for(lambda: len(births()) >= 2, what="replacement replica")
    pid = serve.get_handle("Sick").pid.remote().result(timeout=TIMEOUT)
    out = {"replaced": pid != births()[0], "serves": pid in births()[1:],
           "replicas": serve.status()["Sick"]["num_replicas"]}
    serve.delete("Sick")
    return out


def prog_remediation(rt, serve, tmp):
    remediation = importlib.import_module(rt.__name__ + ".util.remediation")

    @serve.deployment(name="Scaled", ray_actor_options={"num_cpus": 0})
    def scaled():
        return 1

    serve.run(scaled.bind())
    detail = remediation._builtin_serve_scale_up("Scaled", None)
    out = {"detail": detail,
           "replicas": serve.status()["Scaled"]["num_replicas"]}
    try:
        remediation._builtin_serve_scale_up("nope", None)
        out["unknown"] = None
    except remediation.RemediationSkipped as e:
        out["unknown"] = str(e)
    serve.delete("Scaled")
    return out


PROGRAMS = {f.__name__[len("prog_"):]: f for f in (
    prog_deployment, prog_batch, prog_multiplex, prog_local_mode,
    prog_long_poll, prog_http_proxy, prog_health, prog_remediation)}

EXPECTED = {  # what both packages must give, beside giving the same
    "deployment": {"doubled": 42, "added": 101, "peek": 100,
                   "replicas": {"doubler": 1, "adder": 1},
                   "deleted": [True, True], "left": []},
    "batch": {"values": [i * 10 for i in range(8)], "batched": True,
              "within_max": True, "total": 8},
    "multiplex": {"calls": ["ma:1", "mb:2", "ma:3"], "loads": ["ma", "mb"]},
    "local_mode": {"counts": [1, 2, 3], "composed": 20},
    "long_poll": {"first": "a", "pushed_replicas": 2, "handle_replicas": 2,
                  "route": "Echo", "after_push": "b"},
    "http_proxy": {"compute": {"result": {"y": 5}}, "unknown": 404,
                   "sse": ['{"tick": 0}', '{"tick": 1}', '{"tick": 2}',
                           "[DONE]"],
                   "unary": {"result": {"all": 3}}},
    "health": {"replaced": True, "serves": True, "replicas": 1},
    "remediation": {"detail": "deployment Scaled: replicas -> 2",
                    "replicas": 2,
                    "unknown": "unknown deployment 'nope'"},
}


def _run_all(rt, serve, tmp):
    out = {}
    for name, prog in PROGRAMS.items():
        d = os.path.join(tmp, name)
        os.makedirs(d)
        out[name] = prog(rt, serve, d)
    return out


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    ray_tpu.init(num_cpus=8, _system_config=SYSTEM_CONFIG)
    try:
        return _run_all(ray_tpu, jserve, str(tmp_path_factory.mktemp("jax")))
    finally:
        jserve.shutdown()
        ray_tpu.shutdown()


@pytest.fixture(scope="module")
def port_results(jax_results, tmp_path_factory):
    """The port's cluster, started only once the JAX one is down."""
    ray_tpu_torch.init(num_cpus=8, _system_config=SYSTEM_CONFIG)
    try:
        return _run_all(ray_tpu_torch, tserve,
                        str(tmp_path_factory.mktemp("port")))
    finally:
        tserve.shutdown()
        ray_tpu_torch.shutdown()


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_same_results_as_the_jax_package(name, jax_results, port_results):
    assert port_results[name] == jax_results[name], (
        port_results[name], jax_results[name])
    assert port_results[name] == EXPECTED[name], port_results[name]


# ------------------------------------------------------------------ hooks
MAX_SEQ = 64


def _series(metrics):
    """A metric registry's samples, by (name, tags): a counter's total, a
    gauge's last value, a histogram's count of samples (its values are
    timings)."""
    with metrics._lock:
        return {key: (ent["kind"], ent["count"] if ent["kind"] == "histogram"
                      else ent["value"])
                for key, ent in metrics._local.items()}


def _drive_hooks(cb, disagg, engine_cfg, cb_cfg, sp):
    """A preemption, prefix lookups on the engine (a miss, then a hit) and
    on the router (a miss, then a hit), a router generate and a stream
    through a decode replica, with every step by hand."""
    engine = cb.ContinuousBatchingEngine(engine_cfg, cb_cfg)
    pre = disagg.PrefillEngine(engine_cfg)

    def submit(prompt, params):
        meta = pre.prefill(prompt, params)
        k, v = disagg.fetch_prefill_kv(meta)
        return engine.submit_kv(meta, k, v)

    def drain():
        while engine.has_unfinished():
            engine.step()

    long_sp = type(sp)(max_tokens=12, temperature=0.0, stop_token=-1)
    rids = [submit("long a", long_sp), submit("long b", long_sp)]
    for _ in range(4):
        engine.step()
    rids.append(submit("starved", sp))
    drain()
    assert engine.submit_cached("hot prompt", sp) is None
    rids.append(submit("hot prompt", sp))
    drain()
    rids.append(engine.submit_cached("hot prompt", sp))
    drain()
    results = [engine.result(r)["token_ids"] for r in rids]
    router = disagg.DisaggRouter([disagg.PrefillReplica(engine_cfg)],
                                 [disagg.DecodeReplica(engine_cfg)])
    results.append(router.generate("routed", sp)["token_ids"])
    results.append("".join(router.stream("routed", sp)))
    return results, engine.counters["preempted"]


def test_hooks_record_the_same_series_as_the_jax_package(monkeypatch):
    jcfg = jm.GPT2Config.tiny(vocab_size=384, max_seq=MAX_SEQ,
                              dtype="float32")
    tcfg = tm.GPT2Config.tiny(vocab_size=384, max_seq=MAX_SEQ,
                              dtype="float32")
    jparams = jm.gpt2_init(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    knobs = dict(starvation_timeout_s=0.0, preempt_min_tokens=2)
    sp = dict(max_tokens=4, temperature=0.0)

    # Each package's registry starts empty for its run (the process's
    # earlier tests recorded into them).
    monkeypatch.setattr(jmetrics, "_local", {})
    jout, jpreempted = _drive_hooks(
        jcb, jdisagg,
        jllm.EngineConfig(model=jcfg, max_batch_size=2, max_seq_len=MAX_SEQ,
                          seed=0, param_loader=lambda: jparams),
        jcb.ContinuousBatchingConfig(**knobs), jllm.SamplingParams(**sp))
    jseries = _series(jmetrics)

    # The port's engines take ``device`` (the card unless told otherwise);
    # the JAX ones have no such argument, so the same driver asks for none.
    for module in (tcb, tdisagg, tengine):
        monkeypatch.setattr(module, "resolve_device",
                            lambda device=None: torch.device("cpu"))
    monkeypatch.setattr(tmetrics, "_local", {})
    tout, tpreempted = _drive_hooks(
        tcb, tdisagg,
        EngineConfig(model=tcfg, max_batch_size=2, max_seq_len=MAX_SEQ,
                     seed=0, param_loader=lambda: tparams),
        tcb.ContinuousBatchingConfig(**knobs), SamplingParams(**sp))
    tseries = _series(tmetrics)

    assert tout == jout
    assert tpreempted == jpreempted >= 1
    assert tseries == jseries
    names = {name for name, _ in tseries}
    for name in ("ray_tpu_llm_decode_steps_total",
                 "ray_tpu_llm_preemptions_total",
                 "ray_tpu_llm_prefix_cache_hits_total",
                 "ray_tpu_llm_prefix_cache_misses_total",
                 "ray_tpu_serve_ttft_s"):
        assert name in names, sorted(names)
    sites = {dict(tags).get("site") for name, tags in tseries
             if name.startswith("ray_tpu_llm_prefix_cache")}
    deployments = {dict(tags).get("deployment") for _, tags in tseries}
    assert sites == {"engine", "router"}
    assert {"llm_batched", "llm_decode", "llm_disagg"} <= deployments

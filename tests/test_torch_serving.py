"""The port's serving stack (continuous batching, disaggregated prefill and
decode, the device-object store, multi-step decode) against the JAX
package, on the CPU.

Both packages run the same weights in f32 (the JAX engine's, converted by
``params_from_jax``); the expected tokens are solo ``JaxLLMEngine`` runs,
one request at a time, as ``tests/test_continuous_batching.py`` takes
them.  Greedy tokens must be identical.  Every test that depends on
scheduling steps the engine by hand (``starvation_timeout_s=0.0`` where the
guard must fire), so no test races a clock; one test runs the loop thread.
"""

import dataclasses
import importlib
import pickle
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu.llm as jllm
import ray_tpu.models as jm
from ray_tpu.llm import continuous_batching as jcb
from ray_tpu.models.gpt2_decode import gpt2_decode_multi as jax_decode_multi
from ray_tpu_torch import models as tm
from ray_tpu_torch.collective import (
    DeviceObjectStore,
    RemoteDeviceObjectError,
    device_object_store,
)
from ray_tpu_torch.convert import params_from_jax
from ray_tpu_torch.llm import (
    BatchedDecodeReplica,
    ContinuousBatchingConfig,
    ContinuousBatchingEngine,
    DecodeReplica,
    DisaggRouter,
    EngineConfig,
    PrefillEngine,
    PrefillReplica,
    SamplingParams,
)
from ray_tpu_torch.llm import continuous_batching as tcb
from ray_tpu_torch.llm.disagg import fetch_prefill_kv

MAX_SEQ = 64
FAMILIES = ["gpt2", "llama"]


def _model_cfgs(name):
    if name == "gpt2":
        return (jm.GPT2Config.tiny(vocab_size=384, max_seq=MAX_SEQ,
                                   dtype="float32"),
                tm.GPT2Config.tiny(vocab_size=384, max_seq=MAX_SEQ,
                                   dtype="float32"))
    return (jm.LlamaConfig.tiny(vocab_size=384, dtype="float32"),
            tm.LlamaConfig.tiny(vocab_size=384, dtype="float32"))


class Family:
    """One family's JAX solo engine, its weights in the port, and the port
    engine config that shares them."""

    def __init__(self, name):
        jcfg, self.tcfg = _model_cfgs(name)
        self.jax_engine = jllm.JaxLLMEngine(jllm.EngineConfig(
            model=jcfg, max_batch_size=1, max_seq_len=MAX_SEQ, seed=0))
        tree = jax.tree.map(np.asarray, self.jax_engine.params)
        self.params = params_from_jax(tree, self.tcfg, device="cpu")
        self._solo = {}

    def cfg(self, max_batch_size=4):
        params = self.params
        return EngineConfig(model=self.tcfg, max_batch_size=max_batch_size,
                            max_seq_len=MAX_SEQ, seed=0,
                            param_loader=lambda: params)

    def solo(self, prompt, sp: SamplingParams) -> dict:
        """The JAX engine's output for ``prompt`` run alone."""
        key = (prompt, sp.max_tokens, sp.stop_token)
        if key not in self._solo:
            [self._solo[key]] = self.jax_engine.generate(
                [prompt], jllm.SamplingParams(max_tokens=sp.max_tokens,
                                              stop_token=sp.stop_token))
        return self._solo[key]


@pytest.fixture(scope="module")
def families():
    return {name: Family(name) for name in FAMILIES}


def _engine(fam, cb=None, max_batch_size=4):
    cfg = fam.cfg(max_batch_size)
    return (ContinuousBatchingEngine(cfg, cb, device="cpu"),
            PrefillEngine(cfg, device="cpu"))


def _submit(engine, pre, prompt, sp):
    """Prefill on ``pre`` and hand the pages over, as a router does."""
    meta = pre.prefill(prompt, sp)
    k, v = fetch_prefill_kv(meta)
    return engine.submit_kv(meta, k, v)


def _drain(engine, limit=2000):
    for _ in range(limit):
        if not engine.has_unfinished():
            return
        engine.step()
    raise AssertionError("engine did not drain")


def _greedy(n, stop_token=None):
    return SamplingParams(max_tokens=n, temperature=0.0,
                          stop_token=stop_token)


# ---------------------------------------------------------------- prefix keys
@pytest.mark.parametrize("block", [1, 4, 16])
def test_prefix_keys_equal_jax_bytes(block):
    rng = np.random.default_rng(block)
    for n in (0, 1, 3, 15, 16, 17, 40, 64):
        ids = [int(x) for x in rng.integers(0, 258, n)]
        assert tcb.prefix_block_keys(ids, block) == \
            jcb.prefix_block_keys(ids, block)
        assert tcb.full_prompt_key(ids, block) == \
            jcb.full_prompt_key(ids, block)


def test_block_chain_keys():
    a = tcb.prefix_block_keys(list(range(40)), 16)
    b = tcb.prefix_block_keys(list(range(32)) + [99, 98], 16)
    assert len(a) == 2 and len(b) == 2
    assert a[:2] == b[:2]  # same first two full blocks
    c = tcb.prefix_block_keys([7] + list(range(1, 40)), 16)
    assert c[0] != a[0]  # first-token divergence changes every key


def test_lru_eviction_by_token_budget():
    cache = tcb.PrefixKVCache(max_tokens=8, block_tokens=4)

    def entry(ids):
        z = torch.zeros((1, 1, 1, len(ids), 1))
        return tcb.PrefixKVCache.build_entry(ids, z, z, torch.zeros(4), 4)

    cache.insert(entry([1, 2, 3, 4]))
    cache.insert(entry([5, 6, 7, 8]))
    assert cache.lookup([1, 2, 3, 4]) is not None  # refresh LRU
    cache.insert(entry([9, 10, 11, 12]))  # evicts [5,6,7,8]
    assert cache.lookup([5, 6, 7, 8]) is None
    assert cache.lookup([1, 2, 3, 4]) is not None
    assert cache.match_depth([1, 2, 3, 4, 5]) == 1
    assert cache.stats() == {"entries": 2, "tokens": 8, "hits": 2,
                             "misses": 1}


def test_prefix_entry_is_a_trimmed_host_copy():
    k = torch.arange(2 * 3 * 10 * 2, dtype=torch.float32).reshape(
        2, 1, 3, 10, 2)
    e = tcb.PrefixKVCache.build_entry([5, 6, 7], k, k.numpy(),
                                      np.ones(6, np.float32), 4)
    assert e["k"].shape == (2, 1, 3, 3, 2) and e["k"].is_contiguous()
    assert torch.equal(e["k"], k[:, :, :, :3]) and torch.equal(e["v"], e["k"])
    k.zero_()  # the entry owns its memory
    assert e["k"].abs().sum() > 0
    assert e["logits"].dtype == torch.float32 and e["logits"].shape == (6,)


# -------------------------------------------------------- token-boundary parity
@pytest.mark.parametrize("name", FAMILIES)
def test_staggered_admission_across_buckets(families, name):
    """Requests admitted at token boundaries while others decode give the
    JAX solo engine's greedy tokens, across bucket growth 1 -> 2 -> 4 and
    the shrink after the burst."""
    fam = families[name]
    engine, pre = _engine(fam, ContinuousBatchingConfig(shrink_patience=3))
    sp = _greedy(10)
    prompts = ["hello world", "jax on tpu", "disaggregate me", "mid", "z"]
    rids = {}
    for p in prompts:  # each joins a running batch
        rids[p] = _submit(engine, pre, p, sp)
        engine.step()
        engine.step()
    _drain(engine)
    for p, rid in rids.items():
        assert engine.result(rid)["token_ids"] == fam.solo(p, sp)["token_ids"]
    st = engine.stats()
    assert st["max_occupancy"] > 2  # they really shared decode steps
    assert st["admitted"] == st["retired"] == len(prompts)
    trace = list(engine.bucket_trace)
    assert trace[:3] == [1, 2, 4] and trace[-1] < 4, trace
    assert set(st["programs"]) == {1, 2, 4}
    assert all(not p["graph"] for p in st["programs"].values())  # CPU: eager


@pytest.mark.parametrize("name", FAMILIES)
def test_grow_then_shrink_compacts_without_perturbing_survivor(families,
                                                                name):
    fam = families[name]
    engine, pre = _engine(fam, ContinuousBatchingConfig(shrink_patience=3))
    long_sp = _greedy(40, stop_token=-1)
    short = [_submit(engine, pre, f"s{i}", _greedy(4)) for i in range(3)]
    rid = _submit(engine, pre, "survivor", long_sp)
    engine.step()
    assert engine.bucket == 4 and engine.slots[3].rid == rid
    assert engine.cache is engine.decode_program(4).cache
    _drain(engine)
    assert engine.cache is engine.decode_program(engine.bucket).cache
    for r in short:
        assert engine.result(r)["num_generated"] <= 4
    assert engine.result(rid)["token_ids"] == \
        fam.solo("survivor", long_sp)["token_ids"]
    trace = list(engine.bucket_trace)
    assert trace == [1, 2, 4, 2, 1], trace  # compacted from slot 3 to 0


@pytest.mark.parametrize("name", FAMILIES)
def test_starvation_guard_preempts_and_resumes_exact(families, name):
    """With the bucket full and a request waiting, the guard preempts the
    longest-running sequence (its KV to host), the waiter takes the slot,
    and the preempted sequence resumes to a token-exact result."""
    fam = families[name]
    engine, pre = _engine(
        fam, ContinuousBatchingConfig(starvation_timeout_s=0.0,
                                      preempt_min_tokens=2),
        max_batch_size=2)
    long_sp = _greedy(30, stop_token=-1)
    short_sp = _greedy(4)
    la = _submit(engine, pre, "long a", long_sp)
    lb = _submit(engine, pre, "long b", long_sp)
    for _ in range(4):
        engine.step()
    sv = _submit(engine, pre, "starved", short_sp)
    _drain(engine)
    assert engine.stats()["preempted"] >= 1  # the guard really fired
    assert engine.result(sv)["token_ids"] == \
        fam.solo("starved", short_sp)["token_ids"]
    for prompt, rid in (("long a", la), ("long b", lb)):
        assert engine.result(rid)["token_ids"] == \
            fam.solo(prompt, long_sp)["token_ids"]


@pytest.mark.parametrize("name", FAMILIES)
def test_prefix_hit_is_exact_and_accounted(families, name):
    """submit_cached admits a repeated prompt straight from the cached KV
    (no prefill anywhere) with the JAX solo tokens."""
    fam = families[name]
    engine, pre = _engine(fam)
    sp = _greedy(8)
    assert engine.submit_cached("hot prompt", sp) is None  # cold
    rid = _submit(engine, pre, "hot prompt", sp)
    _drain(engine)
    engine.result(rid)
    assert engine.prefix_match_depth("hot prompt") == 0  # < one block
    rid2 = engine.submit_cached("hot prompt", sp)
    assert rid2 is not None  # full-coverage hit
    _drain(engine)
    assert engine.result(rid2)["token_ids"] == \
        fam.solo("hot prompt", sp)["token_ids"]
    pc = engine.stats()["prefix_cache"]
    assert pc["hits"] == 1 and pc["misses"] == 1


def test_cancel_frees_a_running_and_a_queued_slot(families):
    fam = families["gpt2"]
    engine, pre = _engine(fam, max_batch_size=1)
    running = _submit(engine, pre, "cancel me", _greedy(60, stop_token=-1))
    queued = _submit(engine, pre, "queued", _greedy(5))
    engine.step()
    assert engine.stats()["occupancy"] == 1
    engine.cancel(queued)
    engine.cancel(running)
    engine.step()
    st = engine.stats()
    assert st["occupancy"] == 0 and st["queue_depth"] == 0
    assert not engine.has_unfinished()
    for rid in (running, queued):
        assert engine.result(rid)["cancelled"]


def test_sampling_draws_from_the_engine_generator(families):
    """Stochastic sampling is reproducible from the engine seed and stays
    in the vocabulary; greedy rows beside it are unchanged."""
    fam = families["llama"]
    sp = SamplingParams(max_tokens=6, temperature=1.0, top_k=20, top_p=0.9,
                        stop_token=-1)
    runs = []
    for _ in range(2):
        engine, pre = _engine(fam)
        rids = [_submit(engine, pre, p, sp) for p in ("a", "bb")]
        greedy = _submit(engine, pre, "greedy", _greedy(6))
        _drain(engine)
        runs.append([engine.result(r)["token_ids"] for r in rids])
        assert engine.result(greedy)["token_ids"] == \
            fam.solo("greedy", _greedy(6))["token_ids"]
    assert runs[0] == runs[1]
    assert all(0 <= t < 384 for r in runs[0] for t in r)


# ------------------------------------------------------------ the loop thread
def test_loop_thread_stream_equals_result_and_compiles_on_the_loop(families):
    """The resident loop: a stream's deltas join to the solo text,
    ``compile_buckets`` on the running engine is done by the loop, and a
    step that raises fails its requests, recovers, and after 3 failures
    marks the engine dead."""
    fam = families["llama"]
    engine, pre = _engine(fam)
    engine.start()
    try:
        assert engine.compile_buckets() == {1: 0.0, 2: 0.0, 4: 0.0}
        assert set(engine.stats()["programs"]) == {1, 2, 4}
        sp = _greedy(8)
        rid = _submit(engine, pre, "stream me", sp)
        deltas = list(engine.stream(rid, timeout_s=60))
        assert len(deltas) >= 2  # incremental, not one blob
        assert "".join(deltas) == fam.solo("stream me", sp)["text"]

        def broken():
            raise RuntimeError("injected")

        engine._decode_once = broken
        for _ in range(3):
            rid = _submit(engine, pre, "fail", sp)
            with pytest.raises(RuntimeError, match="decode loop failed"):
                engine.result(rid, timeout_s=60)
        engine._thread.join(timeout=60)
        assert not engine._thread.is_alive()
        assert not engine.healthy
        with pytest.raises(RuntimeError, match="dead"):
            engine.submit_cached("x")
    finally:
        engine.stop()


def test_stats_from_another_thread_while_buckets_are_made(families):
    """``stats()`` on a client thread never races the stepping thread
    publishing a bucket's program."""
    engine, _pre = _engine(families["gpt2"], max_batch_size=8)
    errors, done = [], threading.Event()

    def poll():
        while not done.is_set():
            try:
                engine.stats()
            except Exception as e:  # noqa: BLE001 — asserted below
                errors.append(e)
                return

    t = threading.Thread(target=poll)
    t.start()
    try:
        for b in (2, 4, 8):  # as the stepping thread makes them, lazily
            engine.decode_program(b)
    finally:
        done.set()
        t.join()
    assert not errors
    assert set(engine.stats()["programs"]) == {1, 2, 4, 8}


def test_decode_scratch_is_per_stream_and_released_with_it():
    """The decode wrapper's scratch is reused on its own stream, never
    shared across streams, and dropped by ``release_scratch``."""
    da = importlib.import_module("ray_tpu_torch.ops.decode_attention")
    cpu = torch.device("cpu")
    a = da._scratch(cpu, 101, 4, 2, 8)
    assert da._scratch(cpu, 101, 4, 2, 8) is a
    b = da._scratch(cpu, 102, 4, 2, 8)
    assert b[0].data_ptr() != a[0].data_ptr()
    da._scratch(cpu, 101, 2, 1, 8)  # another shape on the same stream
    da.release_scratch(101)
    assert not any(key[1] == 101 for key in da._SCRATCH)
    assert da._scratch(cpu, 102, 4, 2, 8) is b
    da.release_scratch(102)
    assert not any(key[1] == 102 for key in da._SCRATCH)


# ------------------------------------------------------------------- disagg
def test_device_object_refcounts():
    store = DeviceObjectStore()
    t = torch.arange(6.0).reshape(2, 3)
    ref = store.put(t)
    assert ref.shape == (2, 3) and ref.dtype == "torch.float32"
    assert store.contains(ref) and store.refcount(ref) == 1 and len(store) == 1
    assert store.fetch(ref) is t and store.last_transfer_path == "local"
    assert store.retain(ref) == 2
    assert store.free(ref) is False and store.refcount(ref) == 1
    assert store.free(ref) is True and not store.contains(ref)
    assert pickle.loads(pickle.dumps(ref)) == ref
    other = store.put(t)
    assert other.object_id != ref.object_id
    # Not resident and no owner to ask (made outside a runtime process).
    for call in (store.fetch, store.retain, store.refcount):
        with pytest.raises(RemoteDeviceObjectError, match="no owner address"):
            call(ref)
    assert store.free(ref) is False  # nothing left to release: JAX's answer
    with pytest.raises(KeyError):
        store.get_local(ref)
    assert device_object_store() is device_object_store()


def test_prefill_pages_are_handed_over_and_freed(families):
    fam = families["llama"]
    pre = PrefillEngine(fam.cfg(), device="cpu")
    sp = _greedy(4)
    meta = pre.prefill("handoff", sp)
    n = len("handoff") + 1  # BOS
    cfg = fam.tcfg
    assert meta["k_ref"].shape == (cfg.n_layer, 1, cfg.n_kv_head, n,
                                   cfg.head_dim)
    assert meta["prompt_len"] == n and len(meta["token_ids"]) == n
    assert meta["first_token"] == fam.solo("handoff", sp)["token_ids"][0]
    assert meta["logits"].shape == (cfg.vocab_size,)
    k, v = fetch_prefill_kv(meta)
    assert k.shape == v.shape == meta["k_ref"].shape
    store = device_object_store()
    assert not store.contains(meta["k_ref"])
    assert not store.contains(meta["v_ref"])


@pytest.mark.parametrize("decode", ["plain", "batched"])
def test_local_router_matches_monolithic(families, decode):
    """The router over local replicas gives the JAX monolithic engine's
    outputs; a repeated prompt is routed back to its replica and, on the
    batched replica, admitted from the prefix cache."""
    fam = families["gpt2"]
    prompts = ["hello world", "jax on tpu", "disaggregate me",
               "one more prompt"]
    sp = _greedy(12)
    jcfg, _ = _model_cfgs("gpt2")
    mono = jllm.JaxLLMEngine(jllm.EngineConfig(
        model=jcfg, max_batch_size=4, max_seq_len=MAX_SEQ, seed=0,
        param_loader=lambda: fam.jax_engine.params,
    )).generate(prompts, jllm.SamplingParams(max_tokens=12))
    cfg = fam.cfg()
    dec = (DecodeReplica(cfg, device="cpu") if decode == "plain"
           else BatchedDecodeReplica(cfg, device="cpu"))
    router = DisaggRouter([PrefillReplica(cfg, device="cpu")], [dec])
    try:
        for prompt, want in zip(prompts, mono):
            got = router.generate(prompt, sp, timeout_s=120)
            assert got["token_ids"] == want["token_ids"], prompt
            assert got["text"] == want["text"]
        again = router.generate_many(prompts[:1], sp, timeout_s=120)
        assert again[0]["token_ids"] == mono[0]["token_ids"]
        assert "".join(router.stream(prompts[1], sp, timeout_s=120)) == \
            mono[1]["text"]
        assert router.router_hits == 2 and router.router_misses == 4
        if decode == "batched":
            assert dec.stats()["prefix_cache"]["hits"] == 2
    finally:
        if decode == "batched":
            dec.close()


def test_router_refuses_actor_handles():
    """Actor handles are taken and told from local instances by their
    ``.remote`` methods (tests/test_torch_serve.py drives them); only an
    empty pool is refused."""
    class Remote:
        def remote(self, *a):
            raise AssertionError("never called")

    class Actor:
        prefill = Remote()
        add_from_kv = Remote()

    router = DisaggRouter([Actor()], [Actor()])
    assert router._is_actor(router.prefill_replicas[0])
    assert not router._is_actor(PrefillReplica.__new__(PrefillReplica))
    with pytest.raises(ValueError):
        DisaggRouter([], [object()])


# -------------------------------------------------------------- multi-step
def test_multi_step_matches_single_step_and_jax():
    """gpt2_decode_multi (argmax on the device, no host sync between steps)
    gives exactly the greedy single-step sequence, and the JAX function's
    tokens, on the same weights."""
    jcfg = jm.GPT2Config.tiny(dtype="float32")
    tcfg = tm.GPT2Config.tiny(dtype="float32")
    B, T, K = 2, 32, 5
    jparams = jm.gpt2_init(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                             device="cpu")
    tokens = torch.tensor([3, 7], dtype=torch.int32)
    pos = torch.tensor([4, 9], dtype=torch.int32)
    cache = tm.gpt2_init_cache(tcfg, B, T, device="cpu")
    single, t, p = [], tokens, pos
    for _ in range(K):
        logits, cache = tm.gpt2_decode_step(params, t, p, cache, tcfg)
        t = torch.argmax(logits, -1).to(torch.int32)
        p = p + 1
        single.append(t)
    cache2 = tm.gpt2_init_cache(tcfg, B, T, device="cpu")
    out, nxt, npos, cache2 = tm.gpt2_decode_multi(params, tokens, pos,
                                                  cache2, tcfg, K)
    assert out.dtype == torch.int32 and out.shape == (K, B)
    assert torch.equal(out, torch.stack(single))
    assert torch.equal(nxt, single[-1])
    assert npos.tolist() == [4 + K, 9 + K]
    torch.testing.assert_close(cache2["k"], cache["k"])
    jout, jnxt, jpos, _ = jax_decode_multi(
        jparams, jnp.array([3, 7], jnp.int32), jnp.array([4, 9], jnp.int32),
        jm.gpt2_init_cache(jcfg, B, T), jcfg, K)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(npos.numpy(), np.asarray(jpos))


# ---------------------------------------------------------------- devices
@pytest.mark.parametrize("entry", [
    "ContinuousBatchingEngine", "BatchedDecodeReplica", "PrefillEngine",
    "PrefillReplica", "DecodeReplica",
])
def test_new_entry_points_need_a_gpu_unless_told_cpu(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = EngineConfig(model=tm.GPT2Config.tiny(vocab_size=384,
                                                dtype="float32"))
    make = {
        "ContinuousBatchingEngine": lambda **kw: ContinuousBatchingEngine(
            cfg, **kw),
        "BatchedDecodeReplica": lambda **kw: BatchedDecodeReplica(cfg, **kw),
        "PrefillEngine": lambda **kw: PrefillEngine(cfg, **kw),
        "PrefillReplica": lambda **kw: PrefillReplica(cfg, **kw),
        "DecodeReplica": lambda **kw: DecodeReplica(cfg, **kw),
    }[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()
    made = make(device="cpu")
    if entry == "BatchedDecodeReplica":
        made.close()
    engine = getattr(made, "engine", made)
    assert engine.device == torch.device("cpu")


def test_config_mirrors_the_jax_scheduler_knobs():
    """Every knob of the JAX config, with its default (the telemetry
    deployment tag included)."""
    jfields = {f.name: f.default
               for f in dataclasses.fields(jcb.ContinuousBatchingConfig)}
    tfields = {f.name: f.default
               for f in dataclasses.fields(ContinuousBatchingConfig)}
    assert tfields == jfields
    assert tcb._buckets(8) == jcb._buckets(8) == [1, 2, 4, 8]
    assert tcb._buckets(6) == jcb._buckets(6)

"""``PrefillEngine``'s bucketed prefill on the CPU: a prompt padded to its
bucket over the static inputs and cache gives the logits and K/V rows of
an unpadded prefill over a cache of its own length, for both families; the
bookkeeping of a replay is driven by a stand-in graph (the CPU has no CUDA
graphs); threads sharing one engine each get their own pages."""

import threading

import pytest
import torch

from ray_tpu_torch import models as tm
from ray_tpu_torch.llm import EngineConfig, PrefillEngine, SamplingParams
from ray_tpu_torch.llm.disagg import fetch_prefill_kv, prefill_buckets
from ray_tpu_torch.llm.tokenizer import ByteTokenizer
from ray_tpu_torch.util import tracing

MAX_SEQ = 256
FAMILIES = {
    "gpt2": lambda: tm.GPT2Config.tiny(vocab_size=384, max_seq=MAX_SEQ,
                                       dtype="float32"),
    "llama": lambda: tm.LlamaConfig.tiny(vocab_size=384, dtype="float32"),
}


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def engine(request):
    cfg = EngineConfig(model=FAMILIES[request.param](), max_batch_size=4,
                       max_seq_len=MAX_SEQ, seed=0)
    return PrefillEngine(cfg, device="cpu")


def _ids(n, seed):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, 384, (n,), generator=gen).tolist()


def _unpadded(eng, ids):
    """The prefill as it ran before buckets: the prompt's own length, a
    fresh cache of that length."""
    fam, mcfg, n = eng.family, eng.cfg.model, len(ids)
    cache = fam.init_cache(mcfg, 1, n, eng.device)
    logits, cache = fam.prefill(eng.params, torch.tensor([ids]),
                                torch.tensor([n]), cache, mcfg)
    return logits, cache["k"], cache["v"]


class _StandInGraph:
    """What a captured bucket does on replay, run eagerly: the padded
    prefill over the static inputs, its logits into the static output."""

    def __init__(self, eng, bucket):
        self.eng, self.bucket = eng, bucket

    def replay(self):
        self.eng._logits[self.bucket].copy_(self.eng._run(self.bucket))


def _stand_in(eng, bucket):
    eng._graphs[bucket] = _StandInGraph(eng, bucket)
    eng._logits[bucket] = torch.full((1, eng.cfg.model.vocab_size),
                                     float("nan"))
    eng._flash_per_replay[bucket] = eng.cfg.model.n_layer


def test_buckets_cover_every_length_at_most_twice_over():
    assert prefill_buckets(1024) == [64, 128, 256, 512, 768, 1024]
    assert prefill_buckets(2048) == [64, 128, 256, 512, 768, 1024, 2048]
    assert prefill_buckets(1000) == [64, 128, 256, 512, 768, 1000]
    assert prefill_buckets(100) == [64, 100]
    assert prefill_buckets(32) == [32]
    for top in (32, 100, 1024, 3000):
        buckets = prefill_buckets(top)
        assert buckets == sorted(set(buckets)) and buckets[-1] == top
        for n in range(1, top + 1):
            b = next(b for b in buckets if b >= n)
            assert b <= max(2 * n, buckets[0])


@pytest.mark.parametrize("n", [1, 63, 64, 65, 128, MAX_SEQ])
def test_padded_prefill_equals_the_unpadded_one(engine, n):
    ids = _ids(n, n)
    logits, host, k, v, bucket = engine.run_ids(ids)
    want_logits, want_k, want_v = _unpadded(engine, ids)
    mcfg = engine.cfg.model
    heads = getattr(mcfg, "n_kv_head", mcfg.n_head)
    assert k.shape == v.shape == (mcfg.n_layer, 1, heads, n, mcfg.head_dim)
    assert k.is_contiguous() and v.is_contiguous()
    assert bucket == 0  # no graph on the CPU
    torch.testing.assert_close(logits, want_logits)
    torch.testing.assert_close(host, want_logits[0])
    torch.testing.assert_close(k, want_k)
    torch.testing.assert_close(v, want_v)
    # The pages are the caller's own: the next prefill leaves them be.
    kept = k.clone()
    engine.run_ids(_ids(n, n + 1))
    torch.testing.assert_close(k, kept, rtol=0, atol=0)


def test_a_replay_clones_its_outputs_and_is_counted(engine):
    eng = PrefillEngine(engine.cfg, device="cpu")
    _stand_in(eng, 128)
    ids = _ids(100, 7)
    logits, host, k, v, bucket = eng.run_ids(ids)
    assert bucket == 128
    want_logits, want_k, want_v = _unpadded(eng, ids)
    torch.testing.assert_close(logits, want_logits)
    torch.testing.assert_close(k, want_k)
    torch.testing.assert_close(v, want_v)
    assert logits.data_ptr() != eng._logits[128].data_ptr()
    eng.run_ids(_ids(20, 8))  # bucket 64 has no graph: eager
    st = eng.stats()
    assert st == {"graph_prefills": 1, "eager_prefills": 1,
                  "prompt_tokens": 120, "padded_tokens": 128 + 64,
                  "graph_flash_launches": eng.cfg.model.n_layer,
                  "capture_s": {}}


def test_prefill_returns_pages_of_the_prompt_and_counts(engine):
    eng = PrefillEngine(engine.cfg, device="cpu")
    prompts = ["a", "x" * 70, "y" * 200]
    sp = SamplingParams(max_tokens=4, temperature=0.0)
    tok = ByteTokenizer()
    for p in prompts:
        ids = tok.encode(p)
        meta = eng.prefill(p, sp)
        k, v = fetch_prefill_kv(meta)
        want_logits, want_k, want_v = _unpadded(eng, ids)
        assert meta["prompt_len"] == len(ids) and meta["token_ids"] == ids
        assert meta["first_token"] == int(torch.argmax(want_logits[0]))
        torch.testing.assert_close(meta["logits"], want_logits[0])
        torch.testing.assert_close(k, want_k)
        torch.testing.assert_close(v, want_v)
    n = [len(tok.encode(p)) for p in prompts]
    assert eng.stats() == {
        "graph_prefills": 0, "eager_prefills": 3,
        "prompt_tokens": sum(n),
        "padded_tokens": sum(eng.bucket_of(x) for x in n),
        "graph_flash_launches": 0, "capture_s": {}}


def test_threads_sharing_an_engine_get_their_own_pages(engine):
    eng = PrefillEngine(engine.cfg, device="cpu")
    _stand_in(eng, 64)
    prompts = [f"prompt {i} " + "z" * (9 * i) for i in range(8)]
    sp = SamplingParams(max_tokens=4, temperature=0.0)
    start = threading.Barrier(len(prompts))
    got = [None] * len(prompts)

    def client(i):
        start.wait()
        meta = eng.prefill(prompts[i], sp)
        got[i] = (meta, *fetch_prefill_kv(meta))

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    tok = ByteTokenizer()
    for p, (meta, k, v) in zip(prompts, got):
        want_logits, want_k, want_v = _unpadded(eng, tok.encode(p))
        assert meta["first_token"] == int(torch.argmax(want_logits[0]))
        torch.testing.assert_close(k, want_k)
        torch.testing.assert_close(v, want_v)
    st = eng.stats()
    assert st["graph_prefills"] + st["eager_prefills"] == len(prompts)
    assert st["graph_prefills"] == sum(
        eng.bucket_of(len(tok.encode(p))) == 64 for p in prompts) > 0


def test_the_prefill_span_names_its_bucket(engine):
    eng = PrefillEngine(engine.cfg, device="cpu")
    _stand_in(eng, 128)
    sp = SamplingParams(max_tokens=4, temperature=0.0)
    with tracing.recording() as rec:
        eng.prefill("short", sp)
        eng.prefill("w" * 100, sp)
    spans = [s for s in rec.spans() if s.name == "llm.prefill"]
    assert [(s.attrs["tokens"], s.attrs["bucket"]) for s in spans] == [
        (len(ByteTokenizer().encode("short")), 0),
        (len(ByteTokenizer().encode("w" * 100)), 128)]


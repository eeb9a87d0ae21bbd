"""The port's batch inference and load bench against the JAX package's, on
the CPU in f32.

- ``build_llm_processor`` over a Dataset of prompts: the JAX processor runs
  in a JAX cluster, which then shuts down, and the port's in a port cluster
  that declares one GPU (no card is present), its two data actors leasing
  half of it each (``num_gpus=0.5``) and running their engines on
  ``device="cpu"``, on the JAX engine's weights (``params_from_jax``,
  shipped by value in ``EngineConfig.param_loader``).  Both families: the
  ``generated`` columns are equal row by row.
- The port's stage, built with no ``device`` on a machine with no card,
  raises rather than run on the CPU.
- ``bench_llm.bench_load(quick=True)`` gives the rows the JAX bench gives,
  metric for metric and key for key, with real batching (occupancy above
  1) and its in-bench asserts active.
"""

import time

import jax
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu.data as jdata
import ray_tpu.llm as jllm
import ray_tpu.models as jm
import ray_tpu_torch
import ray_tpu_torch.data as tdata
from ray_tpu.llm import bench_llm as jbench
from ray_tpu_torch import models as tm
from ray_tpu_torch.convert import params_from_jax
from ray_tpu_torch.llm import EngineConfig, SamplingParams, build_llm_processor
from ray_tpu_torch.llm import batch as tbatch
from ray_tpu_torch.llm import bench_llm as tbench

MAX_SEQ = 64
FAMILIES = ["gpt2", "llama"]
# vocab 258 is the byte tokenizer's whole id space, so every id a random
# model picks decodes to text.
VOCAB = 258
PROMPTS = [f"prompt {i}: " + "abcdefgh"[: 1 + i % 8] for i in range(8)]
MAX_TOKENS = 8


def _model_cfgs(name):
    if name == "gpt2":
        return (jm.GPT2Config.tiny(vocab_size=VOCAB, max_seq=MAX_SEQ,
                                   dtype="float32"),
                tm.GPT2Config.tiny(vocab_size=VOCAB, max_seq=MAX_SEQ,
                                   dtype="float32"))
    return (jm.LlamaConfig.tiny(vocab_size=VOCAB, dtype="float32"),
            tm.LlamaConfig.tiny(vocab_size=VOCAB, dtype="float32"))


def _jax_cfg(name):
    return jllm.EngineConfig(model=_model_cfgs(name)[0], max_batch_size=4,
                             max_seq_len=MAX_SEQ, seed=0)


def _port_cfg(name):
    """The port's engine config on the JAX engine's weights (its random
    init from the same seed)."""
    jcfg, tcfg = _model_cfgs(name)
    engine = jllm.JaxLLMEngine(_jax_cfg(name))
    params = params_from_jax(jax.tree.map(np.asarray, engine.params), tcfg,
                             device="cpu")
    return EngineConfig(model=tcfg, max_batch_size=4, max_seq_len=MAX_SEQ,
                        seed=0, param_loader=lambda: params)


def _rows():
    return [{"id": i, "prompt": p} for i, p in enumerate(PROMPTS)]


@pytest.fixture(scope="module")
def jax_outputs():
    ray_tpu.init(num_cpus=4)
    try:
        sp = jllm.SamplingParams(max_tokens=MAX_TOKENS, temperature=0.0)
        return {name: jllm.build_llm_processor(_jax_cfg(name), sp)(
                    jdata.from_items(_rows(), parallelism=4)).take_all()
                for name in FAMILIES}
    finally:
        ray_tpu.shutdown()


@pytest.fixture(scope="module")
def port(jax_outputs):
    """The port's cluster, once the JAX one is down, with one GPU
    declared."""
    ray_tpu_torch.init(num_cpus=4, resources={"GPU": 1})
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


@pytest.mark.parametrize("name", FAMILIES)
def test_processor_generates_the_jax_text(name, jax_outputs, port):
    sp = SamplingParams(max_tokens=MAX_TOKENS, temperature=0.0)
    process = build_llm_processor(_port_cfg(name), sp, concurrency=2,
                                  num_gpus=0.5, device="cpu")
    got = process(tdata.from_items(_rows(), parallelism=4)).take_all()
    want = jax_outputs[name]
    assert [r["id"] for r in got] == list(range(len(PROMPTS)))
    assert [(r["prompt"], r["generated"]) for r in got] == [
        (r["prompt"], r["generated"]) for r in want]
    assert all(isinstance(r["generated"], str) for r in got)
    assert sum(bool(r["generated"]) for r in got) >= len(PROMPTS) // 2
    # Both data actors are gone with the pool: their half cards are back.
    deadline = time.monotonic() + 30
    while port.available_resources().get("GPU", 0.0) < 1.0:
        assert time.monotonic() < deadline, "the pool's leases are held"
        time.sleep(0.1)


def test_processor_leases_half_a_card_per_actor():
    from ray_tpu_torch.data import ActorPoolStrategy

    process = build_llm_processor(concurrency=2, num_gpus=0.5, device="cpu")
    stage = process(tdata.from_items(_rows()))._stages[-1]
    assert isinstance(stage.compute, ActorPoolStrategy)
    assert (stage.compute.size, stage.compute.num_gpus,
            stage.compute.num_cpus) == (2, 0.5, 0)
    cpu_only = build_llm_processor()(tdata.from_items(_rows()))._stages[-1]
    assert (cpu_only.compute.num_gpus, cpu_only.compute.num_cpus) == (0, 1)


def test_stage_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = EngineConfig(model=_model_cfgs("gpt2")[1], max_seq_len=MAX_SEQ)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbatch._LLMStage(cfg, None, "prompt", "generated")
    stage = tbatch._LLMStage(cfg, SamplingParams(max_tokens=2), "prompt",
                             "generated", device="cpu")
    assert stage.engine.device == torch.device("cpu")
    [row] = stage([{"prompt": "hi", "id": 7}])
    assert row["id"] == 7 and isinstance(row["generated"], str)


def _shape(rows):
    """Each row's metric and its keys (values differ by engine and box)."""
    return {r["metric"]: sorted(r) for r in rows}


def test_bench_load_quick_gives_the_jax_rows():
    want = jbench.bench_load(quick=True)
    got = tbench.bench_load(quick=True, device="cpu")
    assert _shape(got) == _shape(want)
    by_metric = {r["metric"]: r for r in got}
    assert by_metric["llm_load_batch_occupancy_max"]["value"] > 1
    assert by_metric["llm_load_requests_per_s"]["value"] > 0
    assert by_metric["llm_load_p99_inter_token_s"]["n"] > 0


def test_actor_stages_lease_shares_of_one_card(port):
    """The two actor stages on the CPU, their engine actors (seven, then
    four) each leasing an equal share of the one declared card: every
    row of the JAX stages, the repeats served from the decode replicas'
    prefix caches."""
    rows = tbench.bench_disagg_ab(quick=True, device="cpu")
    assert [r["metric"] for r in rows] == [
        "llm_mono_batched_load_s", "llm_disagg_plain_load_s",
        "llm_disagg_batched_load_s", "llm_disagg_vs_mono_speedup",
        "llm_batched_vs_plain_disagg_speedup"]
    assert rows[3]["prefix_cache_hits"] > 0
    rows = tbench.bench_interference(quick=True, device="cpu")
    assert [r["metric"] for r in rows] == [
        "llm_mono_stream_max_stall_s", "llm_disagg_stream_max_stall_s",
        "llm_disagg_stream_stall_speedup"]
    assert all(np.isfinite(r["value"]) for r in rows)

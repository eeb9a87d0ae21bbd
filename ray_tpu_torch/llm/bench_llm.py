"""Continuous-batching LLM serving stages.

Port of ``ray_tpu/llm/bench_llm.py``.  Run as ``python -m
ray_tpu_torch.llm.bench_llm [--quick]``; each stage prints one
``{"llm": {...}}`` JSON line, the rows the JAX package's ``bench.py
llm_load`` re-emits into its summary.  Every engine runs on ``device``
(the card unless the caller names another, as the tests name the CPU);
the engines the stages put in actors each lease an equal share of one
card (``num_gpus``), so a cluster with one GPU holds them all.

Stages:

- ``llm_disagg_vs_mono_speedup`` (+ ``llm_batched_vs_plain_disagg_
  speedup``) — three serving patterns under the same concurrent batched
  load: monolithic single-engine actor, plain prefill/decode
  disaggregation (caller-stepped decode), and continuous-batching
  decode replicas with prefix routing.  All arms ALTERNATE back-to-back
  inside ONE window (this box swings ~2x window-to-window; the PR-8/9
  interleaving pattern makes the ratios trustworthy even when the
  absolute rates are not).  Best-of-N per arm with per-arm spread
  recorded.
- ``llm_load`` — the high-QPS load harness: thousands of concurrent
  streaming clients against one continuous-batching decode engine
  (the admission queue IS the concurrency; per-request TTFT /
  inter-token / queue-wait land in the PR-10 serving histograms
  engine-side, so no per-client consumer threads are needed).  Asserts
  IN-BENCH: p99 inter-token stall under a bound, and decode batch
  occupancy > 1.
- ``llm_disagg_stream_stall_speedup`` — the interference regime carried
  over from the retired core-suite stage: worst inter-token gap of a
  live stream while a long-prompt burst prefills, mono vs batched
  decode, arms alternating.

``--quick`` shrinks both to a smoke — the path tier-1 pins via
tests/test_continuous_batching.py.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from typing import Any, Dict, List

from ..device import DeviceLike


def _emit(row: Dict[str, Any]) -> Dict[str, Any]:
    print(json.dumps({"llm": row}), flush=True)
    return row


# Each actor's share of the one card: bench_disagg_ab starts seven engine
# actors and bench_interference four (shares that sum exactly in binary).
DISAGG_AB_GPU_SHARE = 1 / 8
INTERFERENCE_GPU_SHARE = 1 / 4


def _kernel_heads(model):
    """``model`` with its width split into heads of 64, the narrowest head
    the flash kernel takes (D = 64 or 128).  The JAX package's stage
    models split it into heads of 16 or 32; every weight keeps its shape."""
    return dataclasses.replace(model, n_head=model.d_model // 64)


def _tiny_engine_cfg(max_batch: int = 8, seed: int = 3):
    from ray_tpu_torch.models.gpt2 import GPT2Config

    from .engine import EngineConfig

    return EngineConfig(
        model=_kernel_heads(GPT2Config.tiny(vocab_size=384, max_seq=64,
                                            dtype="float32")),
        max_batch_size=max_batch, max_seq_len=64, seed=seed,
    )


# ------------------------------------------------------- disagg A/B stage
def _drive_concurrent(fn, prompts: List[str], clients: int,
                      timeout_s: float) -> float:
    """Wall time for ``clients`` threads to push ``prompts`` through
    ``fn(prompt)`` (each client takes its share round-robin)."""
    errors: List[BaseException] = []

    def worker(idx: int):
        try:
            for p in prompts[idx::clients]:
                fn(p)
        except BaseException as e:  # noqa: BLE001 — surface after join
            errors.append(e)

    threads = [
        threading.Thread(target=worker, args=(i,), name=f"llm-client-{i}",
                         daemon=True)
        for i in range(clients)
    ]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout_s)
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in threads):
        raise TimeoutError("load clients did not finish in time")
    return time.perf_counter() - t0


def bench_disagg_ab(quick: bool = False,
                    device: DeviceLike = None) -> List[Dict[str, Any]]:
    """Three serving patterns under the same concurrent load, ALL
    alternating back-to-back in one window (requires a running cluster):
    mono (one engine actor), disagg-plain (prefill/decode pools, callers
    step the decode engine), disagg-batched (continuous-batching decode
    replicas + prefix routing)."""
    import ray_tpu_torch

    from .continuous_batching import BatchedDecodeReplica
    from .disagg import DecodeReplica, DisaggRouter, PrefillReplica
    from .engine import TorchLLMEngine, SamplingParams

    cfg = _tiny_engine_cfg()
    sampling = SamplingParams(max_tokens=6 if quick else 16, temperature=0.0)
    n_templates = 4 if quick else 8
    repeats = 2 if quick else 6
    clients = 4 if quick else 8
    trials = 1 if quick else 5
    # Serving-shaped request stream: a fixed template set, each repeated
    # (the regime prefix caching exists for).  The SAME stream drives
    # both arms; only the disagg arm can exploit the repeats.
    templates = [
        f"request template {i} " + "x" * (3 + i % 7)
        for i in range(n_templates)
    ]
    prompts = [templates[(j * 5 + i) % n_templates]
               for j in range(repeats) for i in range(n_templates)]

    share = DISAGG_AB_GPU_SHARE
    actors = []
    try:
        Mono = ray_tpu_torch.remote(num_cpus=0, num_gpus=share,
                                    max_concurrency=32)(TorchLLMEngine)
        mono = Mono.remote(cfg, device=device)
        actors.append(mono)

        Pre = ray_tpu_torch.remote(num_cpus=0, num_gpus=share)(PrefillReplica)
        Dec = ray_tpu_torch.remote(num_cpus=0, num_gpus=share,
                                   max_concurrency=64)(BatchedDecodeReplica)
        PlainDec = ray_tpu_torch.remote(num_cpus=0, num_gpus=share,
                                        max_concurrency=16)(DecodeReplica)
        pre = [Pre.remote(cfg, device=device) for _ in range(2)]
        dec = [Dec.remote(cfg, device=device) for _ in range(2)]
        plain = [PlainDec.remote(cfg, device=device) for _ in range(2)]
        actors.extend(pre + dec + plain)
        router = DisaggRouter(pre, dec)
        plain_router = DisaggRouter(pre, plain, prefix_routing=False)

        def mono_gen(p):
            ray_tpu_torch.get(mono.generate.remote([p], sampling), timeout=300)

        def disagg_gen(p):
            router.generate(p, sampling, timeout_s=300)

        def plain_gen(p):
            plain_router.generate(p, sampling, timeout_s=300)

        # Warmup: capture every decode bucket on every replica, then one
        # full untimed pass per arm (kernel builds and first launches +
        # disagg steady state: prefix cache hot).  Without this, the
        # one-time work lands inside the first measured window and
        # masquerades as serving cost.
        ray_tpu_torch.get([d.warm.remote() for d in dec], timeout=600)
        _drive_concurrent(mono_gen, prompts, clients, 600)
        _drive_concurrent(plain_gen, prompts, clients, 600)
        _drive_concurrent(disagg_gen, prompts, clients, 600)

        # ONE window, the three arms alternating back-to-back.  The gate
        # ratios are PAIRED per trial (each trial's arms run adjacent in
        # time, so box drift hits both sides) and reported as the median
        # pair ratio — a single lucky window for one arm cannot flip the
        # gate the way best-of-per-arm can on a box with ~2x swings.
        import statistics

        mono_walls, plain_walls, disagg_walls = [], [], []
        for _ in range(trials):
            mono_walls.append(
                _drive_concurrent(mono_gen, prompts, clients, 600)
            )
            plain_walls.append(
                _drive_concurrent(plain_gen, prompts, clients, 600)
            )
            disagg_walls.append(
                _drive_concurrent(disagg_gen, prompts, clients, 600)
            )
        mono_best = min(mono_walls)
        plain_best = min(plain_walls)
        disagg_best = min(disagg_walls)
        mono_ratios = sorted(
            m / d for m, d in zip(mono_walls, disagg_walls)
        )
        plain_ratios = sorted(
            p / d for p, d in zip(plain_walls, disagg_walls)
        )

        def spread(vals):
            return round((max(vals) - min(vals)) / max(vals), 3) if vals else 0

        dec_stats = [ray_tpu_torch.get(d.stats.remote(), timeout=60)
                     for d in dec]
        max_occ = max(s["max_occupancy"] for s in dec_stats)
        cache_hits = sum(
            s["prefix_cache"]["hits"] for s in dec_stats
        )
        n_prompts = len(prompts)
        rows = [
            _emit({
                "metric": "llm_mono_batched_load_s",
                "value": round(mono_best, 4),
                "spread": spread(mono_walls),
                "prompts": n_prompts, "templates": n_templates,
                "clients": clients, "trials": trials,
            }),
            _emit({
                "metric": "llm_disagg_plain_load_s",
                "value": round(plain_best, 4),
                "spread": spread(plain_walls),
                "prompts": n_prompts, "templates": n_templates,
                "clients": clients, "trials": trials,
            }),
            _emit({
                "metric": "llm_disagg_batched_load_s",
                "value": round(disagg_best, 4),
                "spread": spread(disagg_walls),
                "prompts": n_prompts, "templates": n_templates,
                "clients": clients, "trials": trials,
            }),
            _emit({
                "metric": "llm_disagg_vs_mono_speedup",
                "value": round(statistics.median(mono_ratios), 4),
                "interleaved": True,
                "paired": "median of per-trial mono/batched ratios",
                "trials": trials,
                "ratio_min": round(mono_ratios[0], 3),
                "ratio_max": round(mono_ratios[-1], 3),
                "spread_mono": spread(mono_walls),
                "spread_disagg": spread(disagg_walls),
                "decode_max_occupancy": max_occ,
                "prefix_cache_hits": cache_hits,
                "router_hits": router.router_hits,
            }),
            _emit({
                "metric": "llm_batched_vs_plain_disagg_speedup",
                "value": round(statistics.median(plain_ratios), 4),
                "interleaved": True,
                "paired": "median of per-trial plain/batched ratios",
                "ratio_min": round(plain_ratios[0], 3),
                "ratio_max": round(plain_ratios[-1], 3),
                "spread_plain": spread(plain_walls),
                "spread_batched": spread(disagg_walls),
            }),
        ]
        if not quick and max_occ <= 1:
            raise AssertionError(
                f"decode replicas never batched (max occupancy {max_occ})"
            )
        return rows
    finally:
        for a in actors:
            try:
                ray_tpu_torch.kill(a)
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass


# ---------------------------------------------------- interference stage
def bench_interference(quick: bool = False,
                       device: DeviceLike = None) -> List[Dict[str, Any]]:
    """Stream-stall protection A/B (the property disaggregation exists
    for, carried over from the retired core-suite stage): a live token
    stream must not freeze while a burst of long prompts prefills.  Mono
    runs prefill programs inside its decode loop — every in-flight
    stream stalls for whole prefill durations; the batched decode
    replica never compiles or runs prefill, so the burst only ADDS
    sequences to its running batch.  Arms alternate back-to-back;
    worst inter-token gap per arm, best-of-trials."""
    import threading

    import ray_tpu_torch
    from ray_tpu_torch.models.gpt2 import GPT2Config

    from .continuous_batching import BatchedDecodeReplica
    from .disagg import DisaggRouter, PrefillReplica
    from .engine import EngineConfig, TorchLLMEngine, SamplingParams

    # vocab_size=258 == the byte tokenizer's full id space (256 bytes +
    # BOS/EOS): a random-init model's greedy argmax can otherwise fixate
    # on an undecodable id, and a stream of empty text deltas measures
    # nothing.
    if quick:
        model = GPT2Config.tiny(vocab_size=258, max_seq=64, dtype="float32")
        seq_len, stream_tokens, n_burst, trials = 64, 24, 3, 1
    else:
        model = GPT2Config(
            n_layer=4, n_head=8, d_model=256, vocab_size=258, max_seq=256
        )
        seq_len, stream_tokens, n_burst, trials = 256, 100, 8, 2
    cfg = EngineConfig(
        model=_kernel_heads(model), max_batch_size=4, max_seq_len=seq_len,
        seed=3
    )
    # stop_token=-1: the stream must live its full token budget to be a
    # stall instrument — a random-init model's greedy EOS (or a run of
    # undecodable byte-tokenizer ids) would end/empty the stream and
    # leave no gaps to measure.
    stream_s = SamplingParams(max_tokens=stream_tokens, temperature=0.0,
                              stop_token=-1)
    burst_s = SamplingParams(max_tokens=4, temperature=0.0, stop_token=-1)
    burst_prompts = [
        ("load-" + "y" * (seq_len - 40) + f"-{i}") for i in range(n_burst)
    ]

    def max_gap(ts):
        return max((b - a for a, b in zip(ts, ts[1:])), default=0.0)

    share = INTERFERENCE_GPU_SHARE
    actors = []
    try:
        Mono = ray_tpu_torch.remote(num_cpus=0, num_gpus=share,
                                    max_concurrency=16)(TorchLLMEngine)
        mono = Mono.remote(cfg, device=device)
        Pre = ray_tpu_torch.remote(num_cpus=0, num_gpus=share)(PrefillReplica)
        Dec = ray_tpu_torch.remote(num_cpus=0, num_gpus=share,
                                   max_concurrency=32)(BatchedDecodeReplica)
        pre = [Pre.remote(cfg, device=device) for _ in range(2)]
        dec = [Dec.remote(cfg, device=device)]
        actors.extend([mono] + pre + dec)
        router = DisaggRouter(pre, dec)
        ray_tpu_torch.get(dec[0].warm.remote(), timeout=600)
        ray_tpu_torch.get(mono.generate.remote(["warm"], burst_s), timeout=600)
        router.generate("warm", burst_s, timeout_s=600)

        def run_arm(stream_fn, burst_fn):
            ts: List[float] = []

            def stream():
                for _ in stream_fn():
                    ts.append(time.perf_counter())

            st = threading.Thread(target=stream, daemon=True,
                                  name="llm-itf-stream")
            st.start()
            time.sleep(0.3)
            burst = [
                threading.Thread(target=burst_fn, args=(p,), daemon=True,
                                 name="llm-itf-burst")
                for p in burst_prompts
            ]
            for t in burst:
                t.start()
            for t in burst:
                t.join(timeout=600)
            st.join(timeout=600)
            return max_gap(ts)

        def mono_stream():
            return mono.generate_stream.options(
                num_returns="streaming"
            ).remote("the stream", stream_s)

        def mono_burst(p):
            ray_tpu_torch.get(mono.generate.remote([p], burst_s), timeout=600)

        def dis_stream():
            return router.stream("the stream", stream_s, timeout_s=600)

        def dis_burst(p):
            router.generate(p, burst_s, timeout_s=600)

        mono_stalls, dis_stalls = [], []
        for _ in range(trials):  # arms alternate back-to-back
            mono_stalls.append(run_arm(mono_stream, mono_burst))
            dis_stalls.append(run_arm(dis_stream, dis_burst))
        mono_stall = min(mono_stalls)
        dis_stall = min(dis_stalls)
        return [
            _emit({
                "metric": "llm_mono_stream_max_stall_s",
                "value": round(mono_stall, 4), "trials": trials,
            }),
            _emit({
                "metric": "llm_disagg_stream_max_stall_s",
                "value": round(dis_stall, 4), "trials": trials,
            }),
            _emit({
                "metric": "llm_disagg_stream_stall_speedup",
                "value": round(mono_stall / max(dis_stall, 1e-4), 4),
                "interleaved": True,
            }),
        ]
    finally:
        for a in actors:
            try:
                ray_tpu_torch.kill(a)
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass


# ------------------------------------------------------------ load stage
def bench_load(quick: bool = False,
               device: DeviceLike = None) -> List[Dict[str, Any]]:
    """Thousands of concurrent streaming clients against one continuous-
    batching engine (in-process: the admission queue carries the
    concurrency; serving telemetry is recorded engine-side per request).
    Asserts the p99 inter-token stall bound and occupancy > 1."""
    from ray_tpu_torch.util import metrics as _metrics
    from ray_tpu_torch.util import obs as _obs

    from .continuous_batching import (
        ContinuousBatchingConfig,
        ContinuousBatchingEngine,
    )
    from .disagg import PrefillEngine
    from .engine import SamplingParams

    n_clients = 32 if quick else 2000
    max_tokens = 4 if quick else 12
    stall_bound_s = 5.0 if quick else 1.0
    feeders = 2
    deployment = "llm_load"

    cfg = _tiny_engine_cfg()
    # Warmup requests record under a separate deployment tag so their
    # compile-time stalls can't pollute the asserted load histograms.
    cb = ContinuousBatchingConfig(
        starvation_timeout_s=5.0, deployment=deployment + "_warmup",
        prefix_cache_tokens=8192,
    )
    engine = ContinuousBatchingEngine(cfg, cb, device=device)
    engine.start()
    pre = PrefillEngine(cfg, device=device)
    sampling = SamplingParams(max_tokens=max_tokens, temperature=0.0)

    # 4 hot prompts (shared-prefix traffic) + cold uniques: ~70% of
    # clients hit the prefix cache full-coverage fast path, the rest pay
    # a prefill — the hot/cold mix the prefix router exists for.
    hot = [f"system prompt {i}: you are a helpful bench" for i in range(4)]
    # Seed the prefix cache AND pre-warm every bucket's compiled programs
    # (submitting max_batch_size requests back-to-back drives the bucket
    # to its max, so no decode/insert compile lands inside the measured
    # window — compile gaps would masquerade as inter-token stalls).
    warm = hot + [f"warm pad {i}" for i in range(cfg.max_batch_size - len(hot))]
    try:
        engine.compile_buckets()
        for p in warm:
            meta = pre.prefill(p, sampling)
            _load_admit_local(engine, meta)
        while engine.has_unfinished():
            time.sleep(0.02)
        engine.cb.deployment = deployment

        lock = threading.Lock()
        stats = {"hot": 0, "cold": 0, "submitted": 0}

        def feed(idx: int):
            for i in range(idx, n_clients, feeders):
                if i % 10 < 7:
                    p = hot[i % len(hot)]
                    rid = engine.submit_cached(p, sampling)
                    if rid is None:  # evicted: repave via prefill
                        _load_admit_local(engine, pre.prefill(p, sampling))
                        kind = "cold"
                    else:
                        kind = "hot"
                else:
                    p = f"cold client {i} " + "y" * (i % 11)
                    _load_admit_local(engine, pre.prefill(p, sampling))
                    kind = "cold"
                with lock:
                    stats[kind] += 1
                    stats["submitted"] += 1

        t0 = time.perf_counter()
        threads = [
            threading.Thread(target=feed, args=(i,), name=f"llm-feeder-{i}",
                             daemon=True)
            for i in range(feeders)
        ]
        for t in threads:
            t.start()
        # Deadlines must fire INSIDE a caller's 600s subprocess cap: an
        # in-bench TimeoutError exits nonzero (rows printed so far are
        # salvaged), while a subprocess-level TimeoutExpired loses every
        # row of the stage.
        for t in threads:
            t.join(timeout=240)
        if any(t.is_alive() for t in threads):
            raise TimeoutError("llm_load feeders hung")
        deadline = time.monotonic() + 240
        while engine.has_unfinished():
            if time.monotonic() > deadline:
                raise TimeoutError("llm_load drain timed out")
            time.sleep(0.05)
        wall = time.perf_counter() - t0

        est = engine.stats()
        serving = _obs.serving_stats(
            snapshot=_metrics.payload_snapshot() or {}
        ).get(deployment, {})
        itl = serving.get("inter_token") or {}
        ttft = serving.get("ttft") or {}
        total_requests = n_clients + len(warm)
        mean_occ = (
            (total_requests * max_tokens - total_requests) / est["steps"]
            if est["steps"] else 0.0
        )
        rows = [
            _emit({
                "metric": "llm_load_requests_per_s",
                "value": round(n_clients / wall, 2),
                "clients": n_clients,
                "wall_s": round(wall, 2),
                "hot": stats["hot"], "cold": stats["cold"],
                "prefix_cache": est["prefix_cache"],
                "preemptions": est["preempted"],
            }),
            _emit({
                "metric": "llm_load_batch_occupancy_max",
                "value": est["max_occupancy"],
                "mean_occupancy": round(mean_occ, 2),
                "decode_steps": est["steps"],
                "bucket_final": est["bucket"],
            }),
            _emit({
                "metric": "llm_load_p99_inter_token_s",
                "value": round(itl.get("p99_s", 0.0), 4),
                "mean_s": round(itl.get("mean_s", 0.0), 5),
                "n": itl.get("count", 0),
                "bound_s": stall_bound_s,
            }),
            _emit({
                "metric": "llm_load_p99_ttft_s",
                "value": round(ttft.get("p99_s", 0.0), 4),
                "p50_s": round(ttft.get("p50_s", 0.0), 4),
                "mean_s": round(ttft.get("mean_s", 0.0), 4),
                "note": "closed-burst arrivals: TTFT includes queue wait "
                        "by design",
            }),
        ]
        # In-bench acceptance: the stall bound and real batching.
        if est["max_occupancy"] <= 1:
            raise AssertionError(
                f"decode never batched (max occupancy {est['max_occupancy']})"
            )
        if itl.get("count") and itl["p99_s"] > stall_bound_s:
            raise AssertionError(
                f"p99 inter-token stall {itl['p99_s']:.3f}s exceeds the "
                f"{stall_bound_s}s bound"
            )
        if not quick and stats["hot"] == 0:
            raise AssertionError("prefix-cache fast path never hit")
        return rows
    finally:
        engine.stop()


def _load_admit_local(engine, meta) -> int:
    """Local (same-process) KV handoff into the batching engine — same
    consumer protocol as the decode replicas (`disagg.fetch_prefill_kv`)
    so the bench measures the admission path serving uses."""
    from .disagg import fetch_prefill_kv

    k, v = fetch_prefill_kv(meta)
    return engine.submit_kv(meta, k, v)


def main(argv=None) -> int:
    import sys

    quick = "--quick" in (argv if argv is not None else sys.argv[1:])
    bench_load(quick)

    import ray_tpu_torch

    ray_tpu_torch.init(num_cpus=4)
    try:
        bench_disagg_ab(quick)
        bench_interference(quick)
    finally:
        ray_tpu_torch.shutdown()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())

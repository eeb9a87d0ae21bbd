#!/usr/bin/env python3
"""Drive ray_tpu_torch's serving path on one NVIDIA GPU and check it.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (none is caught: any failure exits non-zero):
  1. setup: the card's name and power limit; build the CUDA kernels from
     ray_tpu_torch/csrc/ into build/ray_tpu_torch/;
  2. each kernel against its plain PyTorch version on the card, at the
     serving shapes of both families (TinyLlama-1.1B: 4 query heads per kv
     head; GPT-2 small: one, on strided slices of the fused qkv), in bf16
     at tolerance 2e-2 and in f32 at 1e-4, with its time, the plain
     version's time, one PyTorch library call of the same function
     (F.scaled_dot_product_attention, a yardstick the port never calls) and
     the least time the card could take (bound);
  3. serving at full width: a TinyLlama-1.1B-shaped engine and a GPT-2-small
     engine (random weights from a seed) each answer 12 requests that join
     slots mid-run, and the launch counters show every prefill and decode
     layer went through the kernels;
  4. path parity: one prefill and 4 decode steps of each family at 2
     layers, through the kernels and through the plain versions, logits
     compared (f32 at 1e-4, bf16 at 2e-2).

Prints the kernels' JSON line on the line before the last, and as the last
line {"ok": true, "device": {...}}.  Exits non-zero with no result when no
GPU is present.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from ray_tpu_torch.llm import (  # noqa: E402
    EngineConfig,
    EngineStats,
    SamplingParams,
    TorchLLMEngine,
)
from ray_tpu_torch.models import (  # noqa: E402
    GPT2Config,
    LlamaConfig,
    gpt2_decode,
    llama_decode,
    model_family,
)
from ray_tpu_torch.ops import _build  # noqa: E402
from ray_tpu_torch.ops.attention import (  # noqa: E402
    _flash_fwd,
    flash_attention,
    reference_attention,
    reference_lse,
)
from ray_tpu_torch.ops.decode_attention import (  # noqa: E402
    decode_attention,
    reference_decode_attention,
)

TOL = 2e-2  # bf16 tolerance of tests/test_llama_kernels.py:199-200
# f32: the kernels and the plain versions differ only in summation order.
TOL_F32 = 1e-4
# Decode shapes of the serving runs of phase 3: layers, slots, query heads,
# kv heads, head dim.
TINYLLAMA_DECODE = (22, 8, 32, 8, 64)
GPT2_DECODE = (12, 8, 12, 12, 64)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOPS = 989e12  # H100 SXM dense bf16 data sheet
SEED = 0


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of one call, from CUDA events around ``iters``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def assert_close(got, want, what: str, tol: float = TOL) -> float:
    err = max_err(got, want)
    if not torch.allclose(got.float(), want.float(), atol=tol, rtol=tol):
        raise AssertionError(f"{what}: kernel disagrees, max abs err {err} "
                             f"(tolerance {tol})")
    return err


# ------------------------------------------------------------------ phase 2
def check_decode(gen, shape, t_max: int, pos_list, dtype=torch.bfloat16,
                 tol: float = TOL, timed: bool = False):
    """Decode attention at a serving shape ``(L, B, H, Hkv, D)`` with
    ragged pos; both forms."""
    n_layer, b, h, hkv, d = shape
    tag = f"decode H={h} Hkv={hkv} T={t_max} {str(dtype)[6:]}"

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    q = rand(b, h, d)
    kc, vc = rand(n_layer, b, hkv, t_max, d), rand(n_layer, b, hkv, t_max, d)
    ks, vs = rand(b, hkv, d), rand(b, hkv, d)
    pos = torch.tensor(pos_list, dtype=torch.int32, device="cuda")
    rec = {}
    for form, k_self, v_self in (("self", ks, vs), ("no_self", None, None)):
        layer = n_layer - 1
        got = decode_attention(q, kc, vc, pos, layer, k_self=k_self,
                               v_self=v_self)
        want = reference_decode_attention(q, kc, vc, pos, layer, k_self,
                                          v_self)
        err = assert_close(got, want, f"{tag} {form}", tol)
        print(f"{tag} {form}: max_abs_err {err}", flush=True)
        rec[form] = {"max_abs_err": err}
        if not timed:
            continue
        # Cycle through the layers so each launch finds its prefix cold in
        # L2, as a decode step does (the layers' prefixes together exceed
        # the 50 MB L2).
        layers = itertools.cycle(range(n_layer))
        ms = cuda_ms(lambda: decode_attention(
            q, kc, vc, pos, next(layers), k_self=k_self, v_self=v_self), 100)
        plain_ms = cuda_ms(lambda: reference_decode_attention(
            q, kc, vc, pos, next(layers), k_self, v_self), 20)
        live = [p if k_self is not None else p + 1 for p in pos_list]
        item = q.element_size()
        nbytes = 2 * sum(live) * hkv * d * item  # K and V prefix
        nbytes += 2 * q.numel() * item + pos.numel() * 4  # q and out
        if k_self is not None:
            nbytes += 2 * ks.numel() * item
        rec[form].update(ms=ms, plain_ms=plain_ms,
                         bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                         bound_by="bytes", bytes=nbytes)
    if not timed:
        return rec
    # Library yardstick: one SDPA call computing the no-self form (the same
    # live prefix plus the current row, read from the cache) over one layer.
    idx = torch.arange(t_max, device="cuda")
    mask = (idx[None, :] <= pos[:, None].long())[:, None, None, :]
    q4 = q[:, :, None, :]

    def sdpa(layer):
        return F.scaled_dot_product_attention(
            q4, kc[layer], vc[layer], attn_mask=mask, enable_gqa=True)

    rec["library_err_vs_plain"] = max_err(
        sdpa(0)[:, :, 0], reference_decode_attention(q, kc, vc, pos, 0))
    layers = itertools.cycle(range(n_layer))
    rec["library_ms"] = cuda_ms(lambda: sdpa(next(layers)), 100)
    return rec


def check_flash(gen, s: int, causal: bool, h: int = 32,
                dtype=torch.bfloat16, tol: float = TOL, timed: bool = False):
    """Flash forward at a prefill shape: B=1, H=h (32 for TinyLlama, 12 for
    GPT-2 small), D=64."""
    b, d = 1, 64
    tag = f"flash H={h} S={s} causal={causal} {str(dtype)[6:]}"

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    # GPT-2 hands the kernel strided slices of its fused qkv; Llama hands it
    # contiguous tensors.  Check both layouts.
    qkv = rand(b, s, 3, h, d)
    layouts = {
        "strided": (qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]),
        "contiguous": tuple(qkv[:, :, i].contiguous() for i in range(3)),
    }
    rec = {"H": h, "S": s, "causal": causal}
    for name, (q, k, v) in layouts.items():
        out, lse = _flash_fwd(q, k, v, causal)
        err = assert_close(out, reference_attention(q, k, v, causal=causal),
                           f"{tag} {name}", tol)
        lse_err = assert_close(lse, reference_lse(q, k, causal=causal),
                               f"{tag} lse {name}", tol)
        print(f"{tag} {name}: max_abs_err {err} lse_err {lse_err}",
              flush=True)
        rec["max_abs_err"] = max(err, rec.get("max_abs_err", 0.0))
    if timed:
        q, k, v = layouts["contiguous"]
        rec["ms"] = cuda_ms(lambda: flash_attention(q, k, v, causal=causal),
                            20)
        rec["plain_ms"] = cuda_ms(
            lambda: reference_attention(q, k, v, causal=causal), 5)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        rec["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal), 20)
        pairs = s * (s + 1) // 2 if causal else s * s
        flops = 4 * b * h * d * pairs  # QK^T and PV over the live pairs
        nbytes = 4 * b * s * h * d * 2 + b * h * s * 4  # q,k,v,out + lse
        rec.update(flops=flops, bytes=nbytes,
                   bound_ms=max(flops / BF16_FLOPS,
                                nbytes / HBM_BYTES_PER_S) * 1e3,
                   bound_by=("operations" if flops / BF16_FLOPS
                             > nbytes / HBM_BYTES_PER_S else "bytes"))
    return rec


# ------------------------------------------------------------------ phase 3
def make_prompts(n: int, lo: int, hi: int, seed: int):
    rng = np.random.default_rng(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz     .,"))
    return ["".join(rng.choice(letters, int(length)))
            for length in rng.integers(lo, hi + 1, n)]


def reset_counters():
    decode_attention.launches = 0
    flash_attention.launches = 0


def profile_decode(engine, prompts, steps: int):
    """Where a full-batch decode step's time goes: host wall time per step
    (unprofiled), and device kernel time per step from torch.profiler over
    the same number of steps right after."""
    from torch.profiler import ProfilerActivity, profile

    sp = SamplingParams(max_tokens=2 * steps + 4, temperature=0.0)
    ids = [engine.add_request(p, sp) for p in prompts]
    engine.step()  # admit and prefill every request
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        engine.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
    for rid in ids:
        engine.cancel_request(rid)
    # Kernel entries only: a CPU op's entry repeats its kernels' time.
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3 / steps
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:6]
    return {
        "batch": len(prompts), "steps": steps,
        "wall_ms_per_step": wall_ms,
        "device_ms_per_step": device_ms if device_ms > 0 else None,
        "device_busy_share": device_ms / wall_ms if device_ms > 0 else None,
        "kernel_launches_per_step": sum(e.count for e in events) / steps,
        "top_kernels_ms_per_step": [
            [e.key[:60], e.self_device_time_total / 1e3 / steps]
            for e in top],
    }


def serve(model_cfg, max_batch: int, max_seq: int, prompts, max_tokens: int,
          stagger: int, profile_steps: int = 0):
    """Serve ``prompts`` through the engine's public API, adding one every
    ``stagger`` steps so later requests join slots while others decode;
    then, if asked, profile ``profile_steps`` full-batch decode steps."""
    engine = TorchLLMEngine(EngineConfig(
        model=model_cfg, max_batch_size=max_batch, max_seq_len=max_seq,
        seed=SEED))
    sp = SamplingParams(max_tokens=max_tokens, temperature=0.0)
    engine.generate(["warm up"], SamplingParams(max_tokens=2))  # cuBLAS init
    engine.stats = EngineStats()
    torch.cuda.synchronize()
    reset_counters()
    pending, outs, steps = list(prompts), {}, 0
    t0 = time.perf_counter()
    while pending or engine.has_unfinished():
        if pending and steps % stagger == 0:
            engine.add_request(pending.pop(0), sp)
        for out in engine.step():
            outs[out["request_id"]] = out
        steps += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = engine.stats
    launches = {"decode_attention": decode_attention.launches,
                "flash_fwd": flash_attention.launches}
    n_layer = model_cfg.n_layer
    if len(outs) != len(prompts):
        raise AssertionError(f"{len(outs)} of {len(prompts)} finished")
    for out in outs.values():
        ids = out["token_ids"]
        if not 1 <= out["num_generated"] <= max_tokens:
            raise AssertionError(f"bad num_generated {out['num_generated']}")
        if any(not 0 <= t < model_cfg.vocab_size for t in ids):
            raise AssertionError("token id out of the vocabulary")
    if st.prefills != len(prompts):
        raise AssertionError(f"{st.prefills} prefills for {len(prompts)}")
    if launches["decode_attention"] != n_layer * st.decode_steps:
        raise AssertionError(f"decode launches {launches} != {n_layer} x "
                             f"{st.decode_steps} decode steps")
    if launches["flash_fwd"] != n_layer * st.prefills:
        raise AssertionError(f"flash launches {launches} != {n_layer} x "
                             f"{st.prefills} prefills")
    rep = {
        "requests": len(outs), "tokens": st.tokens, "wall_s": wall,
        "tokens_per_s": st.tokens / wall,
        "decode_steps": st.decode_steps,
        "mean_decode_step_ms": st.decode_s / st.decode_steps * 1e3,
        "prefills": st.prefills,
        "mean_prefill_ms": st.prefill_s / st.prefills * 1e3,
        "mean_prompt_bytes": float(np.mean([len(p) for p in prompts])),
        "launches": launches,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    if profile_steps:
        rep["profile"] = profile_decode(engine, prompts[:max_batch],
                                        profile_steps)
    del engine
    torch.cuda.empty_cache()
    return rep


# ------------------------------------------------------------------ phase 4
@contextlib.contextmanager
def route_attention(decode_fn, flash_fn):
    """Point both families' serving paths at other attention functions."""
    modules = (llama_decode, gpt2_decode)
    saved = [(m.decode_attention, m.flash_attention) for m in modules]
    for m in modules:
        m.decode_attention, m.flash_attention = decode_fn, flash_fn
    try:
        yield
    finally:
        for m, (dec, fl) in zip(modules, saved):
            m.decode_attention, m.flash_attention = dec, fl


def plain_decode(q, k_cache, v_cache, pos, layer, *, k_self=None,
                 v_self=None):
    return reference_decode_attention(q, k_cache, v_cache, pos, layer,
                                      k_self, v_self)


def plain_flash(q, k, v, *, causal=True):
    return reference_attention(q, k, v, causal=causal)


def checked(kernel, plain, tol: float, errs: list):
    """``kernel``, each of whose results is held against ``plain`` on the
    very inputs the path gave it; the errors are appended to ``errs``."""
    def call(*args, **kwargs):
        out = kernel(*args, **kwargs)
        errs.append(assert_close(out, plain(*args, **kwargs),
                                 f"{kernel.__name__} on the path", tol))
        return out
    return call


def path_parity(cfg, tol: float):
    """One prefill of two ragged prompts and 4 decode steps, through the
    kernels and through the plain versions.  In the kernel run every
    launch is also held against its plain version on its own inputs, at
    ``tol``.  Returns the two runs' logits, step by step, and the largest
    per-launch error."""
    fam = model_family(cfg)
    params = fam.init(torch.Generator("cuda").manual_seed(SEED + 2), cfg)
    rng = np.random.default_rng(SEED + 3)
    lengths = torch.tensor([300, 217], device="cuda")
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 300))).cuda()
    steps = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 2))).cuda()

    def run():
        cache = fam.init_cache(cfg, 2, 512)
        logits, _ = fam.prefill(params, tokens, lengths, cache, cfg)
        out = [logits]
        pos = lengths.to(torch.int32)
        for tok in steps:
            logits, _ = fam.decode_step(params, tok, pos, cache, cfg)
            out.append(logits)
            pos = pos + 1
        return out

    reset_counters()
    call_errs = []
    with route_attention(
            checked(decode_attention, plain_decode, tol, call_errs),
            checked(flash_attention, plain_flash, tol, call_errs)):
        kernel_logits = run()
    launches = (flash_attention.launches, decode_attention.launches)
    if launches != (cfg.n_layer, 4 * cfg.n_layer):
        raise AssertionError(f"kernel run launched {launches}")
    with route_attention(plain_decode, plain_flash):
        plain_logits = run()
    if (flash_attention.launches, decode_attention.launches) != launches:
        raise AssertionError("the plain run launched a kernel")
    for i, a in enumerate(kernel_logits):
        if not torch.isfinite(a).all():
            raise AssertionError(f"non-finite logits at step {i}")
    return kernel_logits, plain_logits, max(call_errs)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # plain f32 stays f32
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    # Phase 1: build.
    t0 = time.perf_counter()
    reports = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s for {sorted(reports)} "
          f"(others reused)", flush=True)
    for name, log in reports.items():
        for line in log.splitlines():
            if "Used" in line:
                print(f"  {name}: {line.strip()}", flush=True)

    # Phase 2: each kernel against its plain version.
    # Cache lengths: 2048 and 1024 are the engines' max_seq_len; 1000 is no
    # multiple of the kernel's 64-row tile.
    gen = torch.Generator("cuda").manual_seed(SEED)
    f32 = dict(dtype=torch.float32, tol=TOL_F32)
    llama_pos = [0, 1, 63, 64, 1000, 1537, 2046, 2047]
    gpt2_pos = [0, 1, 63, 64, 333, 700, 1022, 1023]
    dec = check_decode(gen, TINYLLAMA_DECODE, 2048, llama_pos, timed=True)
    check_decode(gen, TINYLLAMA_DECODE, 2048, llama_pos, **f32)
    check_decode(gen, TINYLLAMA_DECODE, 1000,
                 [0, 5, 64, 500, 777, 900, 998, 999])
    dec_gpt2 = check_decode(gen, GPT2_DECODE, 1024, gpt2_pos, timed=True)
    check_decode(gen, GPT2_DECODE, 1024, gpt2_pos, **f32)
    check_decode(gen, GPT2_DECODE, 1000, [0, 2, 64, 128, 500, 640, 998, 999],
                 **f32)
    flash_runs = [check_flash(gen, 2048, True, timed=True),
                  check_flash(gen, 1000, True, timed=True),
                  check_flash(gen, 512, False, timed=True),
                  check_flash(gen, 1000, True, h=12, timed=True)]
    check_flash(gen, 1000, True, **f32)
    check_flash(gen, 512, False, **f32)
    check_flash(gen, 1000, True, h=12, **f32)
    print("phase2 " + json.dumps({"decode": dec, "decode_gpt2": dec_gpt2,
                                  "flash": flash_runs}), flush=True)

    # Phase 3: serving at full width.
    llama = serve(LlamaConfig.tinyllama_1b(), 8, 2048,
                  make_prompts(12, 100, 1500, SEED), 64, stagger=4,
                  profile_steps=10)
    print("serve tinyllama_1b " + json.dumps(llama), flush=True)
    main_launches = llama["launches"]
    gpt2 = serve(GPT2Config.small(), 8, 1024,
                 make_prompts(12, 100, 800, SEED + 1), 64, stagger=4)
    print("serve gpt2_small " + json.dumps(gpt2), flush=True)

    # Phase 4: path parity, kernels vs plain versions, both families.
    # In f32 the logits of the two runs are held at 1e-4.  In bf16 each
    # launch is held at 2e-2 on its own inputs, and the logits are only
    # printed: the random-init residual stream (~0.02) is rescaled ~50x by
    # the final norm, so bf16 rounding differences inside attention reach
    # the logits at several times 2e-2 (PERF.md, Findings).
    parity_cfgs = [
        cfg for dtype in ("float32", "bfloat16")
        for cfg in (LlamaConfig.tinyllama_1b(n_layer=2, dtype=dtype),
                    dataclasses.replace(GPT2Config.small(dtype=dtype),
                                        n_layer=2))]
    for cfg in parity_cfgs:
        f32_run = cfg.dtype == "float32"
        tol = TOL_F32 if f32_run else TOL
        what = f"path parity {type(cfg).__name__} {cfg.dtype}"
        kern, plain, call_err = path_parity(cfg, tol)
        if f32_run:
            errs = [assert_close(a, b, f"{what} step {i}", tol)
                    for i, (a, b) in enumerate(zip(kern, plain))]
        else:
            errs = [max_err(a, b) for a, b in zip(kern, plain)]
        print(f"{what} (2 layers, prefill + 4 decode steps): every launch "
              f"within {tol} of its plain version (largest {call_err}); "
              f"logits max_abs_err per step {errs}"
              f"{f' (tolerance {tol})' if f32_run else ''}, largest logit "
              f"{max(b.abs().max().item() for b in plain)}", flush=True)

    flash_main = flash_runs[1]  # S=1000: a prompt length the path serves
    kernels = [
        {"name": "decode_attention", "route": "cuda",
         "source": "ray_tpu_torch/csrc/decode_attention.cu",
         "replaces": "ray_tpu/ops/decode_attention.py:95",
         "launches": main_launches["decode_attention"],
         "max_abs_err": dec["self"]["max_abs_err"],
         "ms": dec["self"]["ms"], "plain_ms": dec["self"]["plain_ms"],
         "bound_ms": dec["self"]["bound_ms"], "bound_by": "bytes",
         "library_ms": dec["library_ms"]},
        {"name": "flash_fwd", "route": "cuda",
         "source": "ray_tpu_torch/csrc/flash_fwd.cu",
         "replaces": "ray_tpu/ops/attention.py:55",
         "launches": main_launches["flash_fwd"],
         "max_abs_err": flash_main["max_abs_err"],
         "ms": flash_main["ms"], "plain_ms": flash_main["plain_ms"],
         "bound_ms": flash_main["bound_ms"],
         "bound_by": flash_main["bound_by"],
         "library_ms": flash_main["library_ms"]},
    ]
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

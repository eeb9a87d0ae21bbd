#!/usr/bin/env python3
"""Drive ray_tpu_torch's serving and training paths, its runtime and its Data
layer on one NVIDIA GPU and check them.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (none is caught: any failure exits non-zero):
  1. setup: the card's name and power limit; build the CUDA kernels from
     ray_tpu_torch/csrc/ into build/ray_tpu_torch/, print ptxas's register
     and spill report, and count HGMMA (wgmma) and UTMALDG (TMA load)
     instructions in the SASS of each tensor-core kernel function (the
     bf16 forward, dQ and dK/dV, at D=64 and 128: both must be nonzero);
  2. each kernel against its plain PyTorch version on the card: decode
     (against both plain versions, the plain softmax and the split
     kernel's recipe, at ragged positions on and around the 256-row split
     edges; two launches must agree bit for bit) and
     flash forward at the serving shapes of both families (TinyLlama-1.1B:
     4 query heads per kv head; GPT-2 small: one, on strided slices of the
     fused qkv), the flash backward kernels (dQ, dK/dV) at GPT-2 small's
     training shape (strided and contiguous), TinyLlama's width, S=1000
     and non-causal S=512, and the forward and backward at D=128 (S=1000
     causal, S=512 not); bf16 at a tolerance of 2e-2 (relative to the
     largest plain gradient for the backward) and f32 at 1e-4.  Each with
     its time, the plain version's time, one PyTorch library call of the
     same function (F.scaled_dot_product_attention forward or backward, a
     yardstick the port never calls) and the least time the card could
     take (bound);
  3. serving at full width: a TinyLlama-1.1B-shaped engine and a GPT-2-small
     engine (random weights from a seed) each answer 12 requests that join
     slots mid-run, and the launch counters show every prefill and decode
     layer went through the kernels;
  4. path parity: one prefill and 4 decode steps of each family at 2
     layers, through the kernels and through the plain versions, logits
     compared (f32 at 1e-4, bf16 launch by launch at 2e-2);
  5. training at full width (the training slice's path): GPT-2 small, bf16,
     flash attention, remat, B=32 x S=1024 seeded tokens, AdamW; 3 warm-up
     and 10 timed steps on one batch, finite and falling loss, launch
     counts per step (flash forward 2 x 12, dQ 12, dK/dV 12), tokens/s,
     peak memory and one profiled step, in which each of the three
     attention kernels must show device time;
  6. training parity: loss and every gradient leaf of both families at 2
     layers, through the kernels and through the plain versions (f32 at
     1e-4; bf16 launch by launch at 2e-2, leaves printed);
  7. continuous batching at full width: a TinyLlama-1.1B-shaped prefill
     replica and batched decode replica (bf16, buckets 1, 2, 4, 8, each
     bucket's decode step captured in a CUDA graph first) behind a local
     router; 16 prompts from 16 client threads 50 ms apart, 64 greedy
     tokens each, then 4 of them again as prefix-cache hits.  Tokens/s,
     the decode step per bucket, the bucket trace (must reach 8 and
     shrink), a profiled window of 10 full-bucket steps (22 decode kernels
     a replayed step, by name), graph replay against the eager step
     (logits at 2e-2, both timed) and how many outputs equal solo runs
     (printed, not asserted: bf16 rounds by batch shape).  Then f32 token
     parity with solo ``TorchLLMEngine`` runs for both families at 2
     layers, across buckets 1 -> 8 with a preemption, a cancel and a
     prefix-cache hit;
  8. the runtime on the card: ``ray_tpu_torch.init(num_cpus=4)`` must
     detect one GPU and label its model; a ``num_gpus=1`` task must see
     ``CUDA_VISIBLE_DEVICES="0"`` and the driver's card, a ``num_gpus=0``
     task no card; a 64 MiB bf16 CUDA tensor round-trips through
     ``put``/``get``; two fractional-GPU actors with
     ``tensor_transport="device"`` hand over TinyLlama's K and V for a
     1,000-token prompt (45 MB of bf16) by ``DeviceRef``, received on the
     card by point-to-point RPC; and a GPT-2-small bf16 engine in a
     fractional-GPU actor must give the same 32 greedy tokens for each of
     4 prompts as the same engine here, with its decode and flash-forward
     kernels launched in that worker.  Prints the task round trip, the
     actor call, put/get GB/s, device_fetch ms and GB/s, and the worker
     cold start;
  9. Serve and the OpenAI apps at TinyLlama-1.1B's width (bf16, phase 7's
     seeded weights, made by each engine), under
     ``ray_tpu_torch.init(num_cpus=4)``: (a) ``build_openai_app`` with one
     half-card replica behind the HTTP proxy: a prompt alone must give the
     greedy tokens of the same engine in this process, then 4 completions and 4 chats at
     once and one streamed completion (object fields, usage counts, SSE
     frames ending in ``[DONE]`` after a ``stop`` chunk, streamed text
     equal to the unary text; launches in the replica); (b) prefill and
     batched decode, each in its own half-card actor: through
     ``DisaggRouter`` over phase-local subclasses that time and count
     their work, a request alone must give phase 7's in-process tokens,
     then phase 7's burst (TTFT, prefill, KV handoff per request, flash
     launches in the prefill actor, 22 decode kernels a replayed step);
     then ``build_disagg_openai_app`` over HTTP with every bucket captured
     first: the burst, 4 repeats that must be router prefix hits, and a
     streamed request whose trace gathers spans from 3 processes.
     Tokens/s in phase 9 are read with no kernel trace;
 10. the Data layer and batch inference at TinyLlama-1.1B's width (bf16,
     phase 9's seeded weights, made by each engine; 64 greedy tokens),
     under a fresh ``ray_tpu_torch.init(num_cpus=4)``: (a) 128 seeded
     prompts written to parquet, read back and run through
     ``build_llm_processor`` as shipped, two data actors leasing half the
     card each: 128 rows, each with its own prompt and a ``str``, and
     both actors under ``CUDA_VISIBLE_DEVICES="0"`` (wall time, rows/s,
     the first block's time); (b) 64 of them through a counting subclass
     of the stage in a pool of n=1, then n=2 actors leasing 1/n of the
     card: in every actor, 22 flash launches a prefilled prompt and 22
     decode launches an eager step; tokens/s, block latency, prefill and
     decode-step ms by actor; at f32 and 2 layers every block's ids equal
     a local engine's, and at bf16 the share that does is printed;
     (c) ``bench_llm``'s quick stages on the card, their asserts active,
     their rows printed as ``bench.py`` re-emits them.

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
import shutil
import subprocess
import sys
import tempfile
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from ray_tpu_torch.llm import (  # noqa: E402
    BatchedDecodeReplica,
    ByteTokenizer,
    ContinuousBatchingConfig,
    ContinuousBatchingEngine,
    DisaggRouter,
    EngineConfig,
    EngineStats,
    PrefillEngine,
    PrefillReplica,
    SamplingParams,
    TorchLLMEngine,
    build_disagg_openai_app,
    build_llm_processor,
    build_openai_app,
    encode_prompt,
)
from ray_tpu_torch.device import resolve_device  # noqa: E402
from ray_tpu_torch.llm import bench_llm, serve_app  # noqa: E402
from ray_tpu_torch.llm.batch import _LLMStage  # noqa: E402
from ray_tpu_torch.llm.continuous_batching import PrefixKVCache  # noqa: E402
from ray_tpu_torch.models import (  # noqa: E402
    GPT2Config,
    LlamaConfig,
    gpt2_decode,
    llama_decode,
    model_family,
)
from ray_tpu_torch.ops import _build  # noqa: E402
from ray_tpu_torch.ops import attention as attention_ops  # noqa: E402
from ray_tpu_torch.ops.attention import (  # noqa: E402
    _flash_bwd,
    _flash_fwd,
    flash_attention,
    flash_delta,
    flash_dkv,
    flash_dq,
    reference_attention,
    reference_flash_bwd,
    reference_flash_dkv,
    reference_flash_dq,
    reference_flash_fwd,
    reference_lse,
)
from ray_tpu_torch.ops.decode_attention import (  # noqa: E402
    decode_attention,
    reference_decode_attention,
    reference_decode_attention_split,
)

TOL = 2e-2  # bf16 tolerance of tests/test_llama_kernels.py:199-200
# f32: the kernels and the plain versions differ only in summation order.
TOL_F32 = 1e-4
# bf16 gradients: the dQ and dK/dV kernels round P and dS to bf16 where the
# plain versions (and the JAX kernels) round them, but they sum in another
# order (and the wgmma products accumulate in their own order), so a
# gradient is held at 2e-2 of the largest plain gradient of its tensor.
TOL_GRAD = 2e-2
# Decode shapes of the serving runs of phase 3: layers, slots, query heads,
# kv heads, head dim.
TINYLLAMA_DECODE = (22, 8, 32, 8, 64)
GPT2_DECODE = (12, 8, 12, 12, 64)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOPS = 989e12  # H100 SXM dense bf16 data sheet
SEED = 0
# torch.profiler keeps a kernel only where its device timestamps, put on
# the host's clock, fall inside the window; that conversion can slip by a
# few milliseconds, and a window that opens or closes next to the traced
# work then loses the kernels at that edge (tools/profiler_window.py).
# Every traced window leaves the card idle this long at each end.
TRACE_MARGIN_S = 0.25


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuobjdump_path() -> str:
    """cuobjdump beside nvcc, else the copy Triton's package carries."""
    beside = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    if os.path.exists(beside):
        return beside
    try:
        import triton
        carried = os.path.join(os.path.dirname(triton.__file__), "backends",
                               "nvidia", "bin", "cuobjdump")
        if os.path.exists(carried):
            return carried
    except ImportError:
        pass
    raise RuntimeError("cuobjdump not found beside nvcc or in triton's "
                       "package: the SASS check cannot run")


SASS_OPS = ("HGMMA", "UTMALDG")
# The kernel functions that run on the tensor cores with TMA-fed tiles (the
# bf16 designs), by library; each instantiation (D=64, D=128) is checked.
TENSOR_CORE_KERNELS = {
    "flash_fwd": ("flash_fwd_wgmma_kernel",),
    "flash_bwd": ("flash_dq_wgmma_kernel", "flash_dkv_wgmma_kernel"),
}


def sass_counts(name: str) -> dict:
    """How many tensor-core (HGMMA) and TMA-load (UTMALDG) instructions
    each kernel function of the built library ``name`` holds, from its
    SASS split at the dump's ``Function :`` headers, keyed by mangled
    name."""
    sass = subprocess.run(
        [cuobjdump_path(), "-sass", str(_build.library_path(name))],
        capture_output=True, text=True, check=True, timeout=120).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = dict.fromkeys(SASS_OPS, 0)
        elif fn is not None:
            for op in SASS_OPS:
                counts[fn][op] += op in line
    return counts


def check_sass(name: str) -> dict:
    """Every instantiation of the tensor-core kernels of library ``name``
    must hold HGMMA and UTMALDG; returns their counts."""
    counts = sass_counts(name)
    found = {}
    for kernel in TENSOR_CORE_KERNELS[name]:
        fns = {fn: c for fn, c in counts.items() if kernel in fn}
        if len(fns) < 2:
            raise AssertionError(f"lib{name}: {len(fns)} instantiations of "
                                 f"{kernel} in the SASS, want D=64 and 128")
        for fn, c in fns.items():
            if not all(c.values()):
                raise AssertionError(f"lib{name} {fn}: SASS counts {c}, "
                                     f"want every one of {SASS_OPS} > 0")
        found[kernel] = list(fns.values())
    return found


def event_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean time of one call from CUDA events around ``iters`` calls: the
    kernels' time, or the host's dispatch where that is the longer."""
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


@contextlib.contextmanager
def kernel_trace(*activities):
    """torch.profiler over the body (CUDA activity, plus ``activities``),
    with ``TRACE_MARGIN_S`` of idle card before it and after its last
    kernel, so no kernel of the body falls outside the window."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA, *activities]) as prof:
        time.sleep(TRACE_MARGIN_S)
        yield prof
        torch.cuda.synchronize()
        time.sleep(TRACE_MARGIN_S)


def kernel_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of one call: torch.profiler's time of every kernel
    ``fn`` launches, summed over ``iters`` calls.  It leaves out the host's
    dispatch, which for a kernel of tens of microseconds (a prefill's
    flash forward) is longer than the kernel."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with kernel_trace() as prof:
        for _ in range(iters):
            fn()
    total_us = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if total_us <= 0:
        raise AssertionError("the profiler saw no device time")
    return total_us / 1e3 / iters


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
    ragged pos; both forms, each against both plain versions (the plain
    softmax and the split kernel's recipe)."""
    n_layer, b, h, hkv, d = shape
    tag = f"decode B={b} H={h} Hkv={hkv} T={t_max} {str(dtype)[6:]}"

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
        if not torch.equal(got, decode_attention(q, kc, vc, pos, layer,
                                                 k_self=k_self, v_self=v_self)):
            raise AssertionError(f"{tag} {form}: two launches differ")
        args = (q, kc, vc, pos, layer, k_self, v_self)
        err = assert_close(got, reference_decode_attention(*args),
                           f"{tag} {form}", tol)
        split_err = assert_close(got, reference_decode_attention_split(*args),
                                 f"{tag} {form} vs split recipe", tol)
        print(f"{tag} {form}: max_abs_err {err} (split recipe {split_err})",
              flush=True)
        rec[form] = {"max_abs_err": err, "max_abs_err_split": split_err}
        if not timed:
            continue
        # Cycle through the layers so each launch finds its prefix cold in
        # L2, as a decode step does (the layers' prefixes together exceed
        # the 50 MB L2).
        layers = itertools.cycle(range(n_layer))

        def kernel():
            return decode_attention(q, kc, vc, pos, next(layers),
                                    k_self=k_self, v_self=v_self)
        ms = kernel_ms(kernel, 100)
        ms_events = event_ms(kernel, 100)
        plain_ms = kernel_ms(lambda: reference_decode_attention(
            q, kc, vc, pos, next(layers), k_self, v_self), 20)
        live = [p if k_self is not None else p + 1 for p in pos_list]
        item = q.element_size()
        nbytes = 2 * sum(live) * hkv * d * item  # K and V prefix
        nbytes += 2 * q.numel() * item + pos.numel() * 4  # q and out
        if k_self is not None:
            nbytes += 2 * ks.numel() * item
        rec[form].update(ms=ms, event_ms=ms_events, plain_ms=plain_ms,
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
    rec["library_ms"] = kernel_ms(lambda: sdpa(next(layers)), 100)
    return rec


def check_flash(gen, s: int, causal: bool, h: int = 32, b: int = 1,
                dtype=torch.bfloat16, tol: float = TOL, timed: bool = False,
                d: int = 64):
    """Flash forward at a prefill shape, B=b (1 for a prefill, 32 for
    GPT-2's training batch), H=h (32 for TinyLlama, 12 for GPT-2 small),
    D=d (64 for both families; 128 the kernel's other width)."""
    tag = f"flash B={b} H={h} S={s} D={d} causal={causal} {str(dtype)[6:]}"

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    # GPT-2 hands the kernel strided slices of its fused qkv; Llama hands it
    # contiguous tensors.  Check both layouts.
    qkv = rand(b, s, 3, h, d)
    layouts = {
        "strided": (qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]),
        "contiguous": tuple(qkv[:, :, i].contiguous() for i in range(3)),
    }
    rec = {"B": b, "H": h, "S": s, "D": d, "causal": causal}
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
        rec["ms"] = kernel_ms(
            lambda: flash_attention(q, k, v, causal=causal), 20)
        rec["event_ms"] = event_ms(
            lambda: flash_attention(q, k, v, causal=causal), 20)
        rec["plain_ms"] = kernel_ms(
            lambda: reference_attention(q, k, v, causal=causal), 5)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        rec["library_ms"] = kernel_ms(lambda: F.scaled_dot_product_attention(
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


def check_grad(got, want, what: str) -> float:
    """A gradient against its plain version: f32 at TOL_F32 (absolute and
    relative), bf16 within TOL_GRAD of the largest plain value."""
    err = max_err(got, want)
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite gradient")
    if want.dtype == torch.float32:
        return assert_close(got, want, what, TOL_F32)
    limit = TOL_GRAD * want.float().abs().max().item()
    if err > limit:
        raise AssertionError(f"{what}: kernel disagrees, max abs err {err} "
                             f"(tolerance {limit})")
    return err


def flash_bwd_bound(b, s, h, d, causal, item, n_out, matmuls):
    """The least time the card could take: ``matmuls`` products of 2*D
    FLOPs over the live pairs, against q/k/v/dO read once, lse and delta,
    and ``n_out`` gradients written once."""
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 2 * matmuls * d * b * h * pairs
    nbytes = (4 + n_out) * b * s * h * d * item + 2 * b * h * s * 4
    t_ops, t_bytes = flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S
    return {"flops": flops, "bytes": nbytes,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops > t_bytes else "bytes"}


def check_flash_bwd(gen, b: int, h: int, s: int, causal: bool,
                    dtype=torch.bfloat16, timed: bool = False, d: int = 64):
    """Both backward kernels against their plain versions at D=d, on
    strided slices of a fused qkv (GPT-2's layout) and on contiguous
    tensors, with the forward kernel's out and lse and a random dO."""
    tag = (f"flash_bwd B={b} H={h} S={s} D={d} causal={causal} "
           f"{str(dtype)[6:]}")

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    qkv = rand(b, s, 3, h, d)
    layouts = {
        "strided": (qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]),
        "contiguous": tuple(qkv[:, :, i].contiguous() for i in range(3)),
    }
    do = rand(b, s, h, d)
    rec = {"B": b, "H": h, "S": s, "D": d, "causal": causal,
           "dtype": str(dtype)[6:],
           "max_abs_err": {}, "max_abs_plain": {}}
    for name, (q, k, v) in layouts.items():
        o, lse = _flash_fwd(q, k, v, causal)
        delta = flash_delta(o, do)
        args = (q, k, v, do, lse, delta, causal)
        got = (flash_dq(*args), *flash_dkv(*args))
        want = (reference_flash_dq(*args), *reference_flash_dkv(*args))
        for key, g, w in zip(("dq", "dk", "dv"), got, want):
            err = check_grad(g, w, f"{tag} {name} {key}")
            rec["max_abs_err"][key] = max(err,
                                          rec["max_abs_err"].get(key, 0.0))
            rec["max_abs_plain"][key] = w.float().abs().max().item()
        print(f"{tag} {name}: max_abs_err "
              f"{[max_err(g, w) for g, w in zip(got, want)]} against plain "
              f"gradients up to "
              f"{[w.float().abs().max().item() for w in want]}", flush=True)
    if not timed:
        return rec
    q, k, v = layouts["contiguous"]
    o, lse = _flash_fwd(q, k, v, causal)
    delta = flash_delta(o, do)
    args = (q, k, v, do, lse, delta, causal)
    item = q.element_size()
    rec["dq"] = dict(ms=kernel_ms(lambda: flash_dq(*args), 10),
                     event_ms=event_ms(lambda: flash_dq(*args), 10),
                     plain_ms=kernel_ms(lambda: reference_flash_dq(*args), 3),
                     **flash_bwd_bound(b, s, h, d, causal, item, 1, 3))
    rec["dkv"] = dict(ms=kernel_ms(lambda: flash_dkv(*args), 10),
                      event_ms=event_ms(lambda: flash_dkv(*args), 10),
                      plain_ms=kernel_ms(lambda: reference_flash_dkv(*args),
                                         3),
                      **flash_bwd_bound(b, s, h, d, causal, item, 2, 4))
    # Library yardstick: the backward of one SDPA call (dq, dk and dv
    # together) on a graph built once.
    qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_(True)
                  for x in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    dot = do.transpose(1, 2)
    rec["library_backend"] = out.grad_fn.name()
    rec["library_ms"] = kernel_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True), 10)
    lib = torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)
    rec["library_err_vs_plain"] = max(
        max_err(g.transpose(1, 2), w) for g, w in zip(
            lib, (reference_flash_dq(*args), *reference_flash_dkv(*args))))
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
    flash_dq.launches = 0
    flash_dkv.launches = 0


def flash_counts():
    return {"flash_fwd": flash_attention.launches,
            "flash_dq": flash_dq.launches, "flash_dkv": flash_dkv.launches}


def profile_decode(engine, prompts, steps: int):
    """Where a full-batch decode step's time goes: host wall time per step
    (unprofiled), and device kernel time per step from torch.profiler over
    the same number of steps right after."""
    from torch.profiler import ProfilerActivity

    sp = SamplingParams(max_tokens=2 * steps + 4, temperature=0.0)
    ids = [engine.add_request(p, sp) for p in prompts]
    engine.step()  # admit and prefill every request
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        engine.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / steps * 1e3
    with kernel_trace(ProfilerActivity.CPU) as prof:
        for _ in range(steps):
            engine.step()
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


def profile_prefill(engine, prompt: str):
    """Where one prefill's time goes: torch.profiler over the engine step
    that admits one request (prefill and first sample, nothing else in
    flight), host wall time and kernel time by class."""
    from torch.profiler import ProfilerActivity

    engine.generate([prompt], SamplingParams(max_tokens=1))  # its shapes warm
    torch.cuda.synchronize()
    with kernel_trace(ProfilerActivity.CPU) as prof:
        t0 = time.perf_counter()
        engine.generate([prompt], SamplingParams(max_tokens=1))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    return {"prompt_bytes": len(prompt), "wall_ms": wall_ms,
            "device_ms": device_ms if device_ms > 0 else None,
            "device_busy_share": device_ms / wall_ms if device_ms > 0 else None,
            "kernel_launches": sum(e.count for e in events),
            "by_class_ms": by_kernel_class(events)}


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
    prefill_ms = []  # each admission's prefill, in order
    t0 = time.perf_counter()
    while pending or engine.has_unfinished():
        if pending and steps % stagger == 0:
            engine.add_request(pending.pop(0), sp)
        before = engine.stats.prefill_s
        for out in engine.step():
            outs[out["request_id"]] = out
        if engine.stats.prefill_s > before:
            prefill_ms.append((engine.stats.prefill_s - before) * 1e3)
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
        "prefill_ms_each": prefill_ms,
        "median_prefill_ms": float(np.median(prefill_ms)),
        "mean_prompt_bytes": float(np.mean([len(p) for p in prompts])),
        "launches": launches,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    if profile_steps:
        rep["profile"] = profile_decode(engine, prompts[:max_batch],
                                        profile_steps)
        rep["profile_prefill"] = profile_prefill(
            engine, make_prompts(1, 1000, 1000, SEED + 9)[0])
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


def within(tol: float):
    """A check that holds a result at ``tol`` (absolute and relative)."""
    return lambda got, want, what: assert_close(got, want, what, tol)


def checked(kernel, plain, check, errs: list):
    """``kernel``, each of whose results (a tensor or a tuple of them) is
    held against ``plain`` on the very inputs the path gave it, by
    ``check(got, want, what)``; each error and the largest plain value it
    was held against are appended to ``errs``."""
    def call(*args, **kwargs):
        got, want = kernel(*args, **kwargs), plain(*args, **kwargs)
        pairs = zip(*(x if isinstance(x, tuple) else (x,)
                      for x in (got, want)))
        for g, w in pairs:
            errs.append((check(g, w, f"{kernel.__name__} on the path"),
                         w.float().abs().max().item()))
        return got
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
            checked(decode_attention, plain_decode, within(tol), call_errs),
            checked(flash_attention, plain_flash, within(tol), call_errs)):
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
    return kernel_logits, plain_logits, max(e for e, _ in call_errs)


# ------------------------------------------------------------------ phase 5
# The kernels a bf16 train step launches, by their names in the profile.
ATTENTION_KERNELS = ("flash_fwd_wgmma_kernel", "flash_dq_wgmma_kernel",
                     "flash_dkv_wgmma_kernel")
# Kernel classes of a train step, by substrings of the kernel's name; the
# first class that matches takes the kernel.
KERNEL_CLASSES = (
    ("attention", ATTENTION_KERNELS),
    ("matmul", ("nvjet", "gemm", "xmma", "cutlass")),
    ("optimizer", ("multi_tensor_apply",)),
    ("reduction", ("reduce_kernel",)),
    ("elementwise", ("elementwise", "copy")),
)


def kernel_class(name: str) -> str:
    for cls, keys in KERNEL_CLASSES:
        if any(k in name for k in keys):
            return cls
    return "other"


def by_kernel_class(events) -> dict:
    """Device ms of profiler kernel ``events``, summed by kernel class."""
    by_class = {}
    for e in events:
        cls = kernel_class(e.key)
        by_class[cls] = by_class.get(cls, 0.0) + e.self_device_time_total / 1e3
    return by_class


def profile_train_step(step):
    """Where one train step's time goes: torch.profiler over one step,
    kernel time by name, the device busy share of the profiled step and
    the share of the three attention kernels."""
    from torch.profiler import ProfilerActivity

    torch.cuda.synchronize()
    with kernel_trace(ProfilerActivity.CPU) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    attn = {name: sum(e.self_device_time_total for e in events
                      if name in e.key) / 1e3
            for name in ATTENTION_KERNELS}
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:10]
    return {
        "profiled_wall_ms": wall_ms,
        "device_ms": device_ms if device_ms > 0 else None,
        "device_busy_share": device_ms / wall_ms if device_ms > 0 else None,
        "kernel_launches": sum(e.count for e in events),
        "attention_ms": attn,
        "attention_share_of_device": (sum(attn.values()) / device_ms
                                      if device_ms > 0 else None),
        "by_class_ms": by_kernel_class(events),
        "top_kernels_ms": [[e.key[:70], e.self_device_time_total / 1e3,
                            e.count] for e in top],
    }


def train(cfg, batch: int, seq: int, warmup: int, steps: int,
          lr: float = 1e-4):
    """Train ``cfg`` on one seeded batch (the shape and step of
    ``bench.py:bench_gpt2_train``): ``warmup`` steps, then ``steps`` timed
    ones, then one profiled step.  Asserts finite, falling loss and the
    launch counts of every step."""
    fam = model_family(cfg)
    params = fam.init(torch.Generator("cuda").manual_seed(SEED + 4), cfg)
    params.requires_grad_(True)
    rng = np.random.default_rng(SEED + 5)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (batch, seq + 1))).cuda()
    opt = torch.optim.AdamW(params.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=1e-4)

    def step():
        """The JAX package's ``_train_step_time`` step: loss, backward,
        AdamW.  Returns the loss, still on the card."""
        opt.zero_grad(set_to_none=True)
        loss = fam.loss(params, tokens, cfg)
        loss.backward()
        opt.step()
        return loss.detach()

    n_layer = cfg.n_layer
    want = {"flash_fwd": n_layer * (2 if cfg.remat else 1),
            "flash_dq": n_layer, "flash_dkv": n_layer}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    losses, per_step = [], []

    def counted_step():
        before = flash_counts()
        losses.append(step())
        per_step.append({k: n - before[k] for k, n in flash_counts().items()})

    for _ in range(warmup):
        counted_step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        counted_step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    launches = flash_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = torch.stack(losses).tolist()
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    if any(c != want for c in per_step):
        raise AssertionError(f"launches per step {per_step}, want {want} "
                             "(flash forward, dQ, dK/dV)")
    rep = {
        "batch": batch, "seq": seq, "n_layer": n_layer, "remat": cfg.remat,
        "warmup_steps": warmup, "timed_steps": steps,
        "losses": losses, "mean_step_ms": step_ms,
        "tokens_per_s": batch * seq / (step_ms / 1e3),
        "peak_mem_gb": peak_gb, "launches": launches,
        "launches_per_step": want,
    }
    rep["profile"] = profile_train_step(step)
    silent = [k for k, ms in rep["profile"]["attention_ms"].items() if not ms]
    if silent:
        raise AssertionError(f"no device time for {silent} in the profiled "
                             "step: an attention kernel was renamed or not "
                             "launched")
    del params, opt, step
    torch.cuda.empty_cache()
    return rep


# ------------------------------------------------------------------ phase 6
@contextlib.contextmanager
def route_flash(fwd, bwd):
    """Point ``flash_attention``'s autograd function at another forward
    (``_flash_fwd``) and backward (``_flash_bwd``: delta, then dQ and
    dK/dV)."""
    mod = attention_ops
    saved = (mod._flash_fwd, mod._flash_bwd)
    mod._flash_fwd, mod._flash_bwd = fwd, bwd
    try:
        yield
    finally:
        mod._flash_fwd, mod._flash_bwd = saved


def grads_of(fam, params, tokens, cfg):
    for p in params.parameters():
        p.grad = None
    loss = fam.loss(params, tokens, cfg)
    loss.backward()
    return loss.detach(), {n: p.grad.detach().clone()
                           for n, p in params.named_parameters()}


def train_parity(cfg, batch: int, seq: int):
    """Loss and every gradient leaf of one batch, through the kernels
    (each launch also held against its plain version on its own inputs)
    and through the plain versions."""
    fam = model_family(cfg)
    params = fam.init(torch.Generator("cuda").manual_seed(SEED + 6), cfg)
    params.requires_grad_(True)
    rng = np.random.default_rng(SEED + 7)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (batch, seq + 1))).cuda()
    f32_run = cfg.dtype == "float32"
    fwd_tol = TOL_F32 if f32_run else TOL
    errs = {"flash_fwd": [], "flash_bwd": []}
    reset_counters()
    with route_flash(
            checked(_flash_fwd, reference_flash_fwd, within(fwd_tol),
                    errs["flash_fwd"]),
            checked(_flash_bwd, reference_flash_bwd, check_grad,
                    errs["flash_bwd"])):
        k_loss, k_grads = grads_of(fam, params, tokens, cfg)
    launches = flash_counts()
    want = {"flash_fwd": cfg.n_layer * (2 if cfg.remat else 1),
            "flash_dq": cfg.n_layer, "flash_dkv": cfg.n_layer}
    if launches != want:
        raise AssertionError(f"kernel run launched {launches}, want {want}")
    with route_flash(reference_flash_fwd, reference_flash_bwd):
        p_loss, p_grads = grads_of(fam, params, tokens, cfg)
    if flash_counts() != launches:
        raise AssertionError("the plain run launched a kernel")
    leaf_errs = {n: max_err(k_grads[n], p_grads[n]) for n in p_grads}
    for n, g in k_grads.items():
        if not torch.isfinite(g).all():
            raise AssertionError(f"non-finite gradient of {n}")
        if f32_run:
            assert_close(g, p_grads[n], f"gradient of {n}", TOL_F32)
    if f32_run:
        assert_close(k_loss, p_loss, "loss", TOL_F32)
    rep = {
        "loss_kernels": k_loss.item(), "loss_plain": p_loss.item(),
        "launches": launches,
        "largest_launch_err": {k: max(e for e, _ in v)
                               for k, v in errs.items()},
        "largest_launch_rel_err": {k: max(e / m for e, m in v if m > 0)
                                   for k, v in errs.items()},
        "leaf_max_abs_err": leaf_errs,
        "leaf_max_abs_plain": {n: g.float().abs().max().item()
                               for n, g in p_grads.items()},
    }
    del params, k_grads, p_grads
    torch.cuda.empty_cache()
    return rep


# ------------------------------------------------------------------ phase 7
# The kernels' function names in the profile (the flash forward's name is
# shared by its bf16 and f32 kernels).
DECODE_KERNEL = "decode_attention_kernel"
FLASH_KERNEL = "flash_fwd"
# Sent alone through phase 7's in-process router and phase 9's actor route.
SOLO_PROMPT = make_prompts(1, 100, 1500, SEED + 40)[0]


def graph_launches(programs: dict) -> int:
    """Decode-kernel launches of the graph path: each bucket's launches per
    captured graph times its replays, from ``stats()["programs"]``."""
    return sum(p["launches_per_step"].get("decode_attention", 0) * p["steps"]
               for p in programs.values())


def program_deltas(before: dict, after: dict) -> dict:
    """Per-bucket steps and decode seconds between two ``stats()``."""
    out = {}
    for b, p in after.items():
        q = before.get(b, {"steps": 0, "decode_s": 0.0})
        steps = p["steps"] - q["steps"]
        out[b] = {"steps": steps, "decode_s": p["decode_s"] - q["decode_s"],
                  "launches_per_step": p["launches_per_step"],
                  "mean_step_ms": ((p["decode_s"] - q["decode_s"]) / steps
                                   * 1e3 if steps else None)}
    return out


def _percentiles(xs) -> dict:
    return {"p50": float(np.percentile(xs, 50)),
            "p99": float(np.percentile(xs, 99)), "max": float(np.max(xs))}


def _burst(send, items, stagger_s: float):
    """``send(item)`` from one client thread each, started ``stagger_s``
    apart; returns (results, per-request seconds, wall seconds)."""
    outs, lat, errors = [None] * len(items), [None] * len(items), []

    def client(i):
        t = time.perf_counter()
        try:
            outs[i] = send(items[i])
        except Exception as e:  # noqa: BLE001 — raised below
            errors.append(repr(e))
        lat[i] = time.perf_counter() - t

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(len(items))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
        time.sleep(stagger_s)
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    if errors or any(o is None for o in outs):
        raise AssertionError(f"burst failed: {errors}")
    return outs, lat, wall


def submit_local(engine, pre, prompt: str, sp) -> int:
    """Prefill on ``pre`` and hand the pages to ``engine`` (no router)."""
    from ray_tpu_torch.llm.disagg import fetch_prefill_kv

    meta = pre.prefill(prompt, sp)
    k, v = fetch_prefill_kv(meta)
    return engine.submit_kv(meta, k, v)


def profile_cb(engine, pre, prompts, steps: int):
    """A full bucket of 8 stepped by hand on a stopped engine: host wall
    time per step (unprofiled), then kernel time, busy share and launches
    per step from torch.profiler over as many steps, the decode kernel
    counted by name.  Then graph replay against the eager decode step at
    the same bucket, on identical inputs."""
    from torch.profiler import ProfilerActivity

    sp = SamplingParams(max_tokens=3 * steps + 30, temperature=0.0,
                        stop_token=-1)
    rids = [submit_local(engine, pre, p, sp) for p in prompts]
    while engine.stats()["occupancy"] < len(prompts):
        engine.step()
    if engine.bucket != 8:
        raise AssertionError(f"profile window at bucket {engine.bucket}")
    for _ in range(3):
        engine.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        engine.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / steps * 1e3
    with kernel_trace(ProfilerActivity.CPU) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) / steps * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3 / steps
    decode_kernels = sum(e.count for e in events
                         if DECODE_KERNEL in e.key) / steps
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:6]
    rep = {
        "batch": len(prompts), "steps": steps,
        "wall_ms_per_step": wall_ms,
        "profiled_wall_ms_per_step": prof_wall_ms,
        "device_ms_per_step": device_ms if device_ms > 0 else None,
        "device_busy_share": device_ms / wall_ms if device_ms > 0 else None,
        "kernel_launches_per_step": sum(e.count for e in events) / steps,
        "decode_kernels_per_step": decode_kernels,
        "top_kernels_ms_per_step": [
            [e.key[:60], e.self_device_time_total / 1e3 / steps]
            for e in top],
    }
    # Graph replay against the eager step on the live bucket-8 inputs.  A
    # step recomputes and rewrites each row's k/v at its position from the
    # same inputs, so repeating it changes nothing.
    fam, cfg = engine.family, engine.cfg.model
    prog = engine.decode_program(8)

    def eager():
        return fam.decode_step(engine.params, prog.inputs[0], prog.inputs[1],
                               prog.cache, cfg)[0]

    want = eager().clone()
    prog.graph.replay()
    got = prog.logits.clone()
    tol = TOL_F32 if cfg.dtype == "float32" else TOL
    rep["graph_vs_eager_max_abs_err"] = assert_close(
        got, want, "graph replay vs eager decode step", tol)
    rep["graph_vs_eager_tolerance"] = tol
    rep["eager_step_ms"] = event_ms(eager, 20)
    rep["graph_step_ms"] = event_ms(prog.graph.replay, 20)
    for rid in rids:
        engine.cancel(rid)
    while engine.has_unfinished():
        engine.step()
    for rid in rids:
        engine.result(rid)
    return rep


def cb_serve(prompts, max_tokens: int, stagger_s: float, repeats: int):
    """Continuous batching at full width: TinyLlama-1.1B-shaped, bf16,
    buckets 1-8 captured first; ``prompts`` from one client thread each,
    started ``stagger_s`` apart, through the router; then ``repeats`` of
    them again, which must be prefix-cache hits (no prefill).  The report
    is printed before any check of it can fail."""
    cfg = LlamaConfig.tinyllama_1b()
    params = model_family(cfg).init(
        torch.Generator("cuda").manual_seed(SEED + 8), cfg)
    # One prefill and one batched decode replica sharing ``params``, behind
    # a local router; every bucket's decode step is captured before the
    # loop starts.  The prefix cache holds the whole burst's prompts (at
    # most 16 x 1,501 tokens, 45 KB of host memory a token at this width).
    ecfg = EngineConfig(model=cfg, max_batch_size=8, max_seq_len=2048,
                        seed=SEED, param_loader=lambda: params)
    pre = PrefillReplica(ecfg)
    dec = BatchedDecodeReplica(
        ecfg, ContinuousBatchingConfig(prefix_cache_tokens=32768), warm=True)
    router = DisaggRouter([pre], [dec])
    engine = dec.engine
    st0 = engine.stats()
    captured = {b: p["capture_s"] for b, p in st0["programs"].items()}
    if sorted(captured) != [1, 2, 4, 8] or not all(
            p["graph"] for p in st0["programs"].values()):
        raise AssertionError(f"buckets captured: {st0['programs']}")
    print(f"cb capture seconds by bucket {captured}", flush=True)
    sp = SamplingParams(max_tokens=max_tokens, temperature=0.0, stop_token=-1)
    router.generate("warm up", SamplingParams(max_tokens=2))
    # One request alone at bucket 1: phase 9 sends it alone through the
    # actor route and must get these tokens.
    solo = router.generate(SOLO_PROMPT, sp, timeout_s=600)
    torch.cuda.synchronize()
    # Each prefill's host time, as the client threads see it.
    prefill_ms = []
    prefill = pre.engine.prefill

    def timed_prefill(*args, **kwargs):
        t = time.perf_counter()
        out = prefill(*args, **kwargs)
        prefill_ms.append((time.perf_counter() - t) * 1e3)
        return out

    pre.engine.prefill = timed_prefill
    before = engine.stats()
    trace_from = len(engine.bucket_trace)
    reset_counters()
    # The burst runs under the profiler's kernel trace (CUDA activity only,
    # no host-op recording), so its kernels, graph replays' included, are
    # counted on the card by name.
    with kernel_trace() as prof:
        outs, lat, wall = _burst(
            lambda p: router.generate(p, sp, timeout_s=600), prompts,
            stagger_s)
        torch.cuda.synchronize()
    pre.engine.prefill = prefill
    flash_run = flash_attention.launches
    eager_decode = decode_attention.launches
    mid = engine.stats()
    traced = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    traced_decode = sum(e.count for e in traced if DECODE_KERNEL in e.key)
    traced_flash = sum(e.count for e in traced if FLASH_KERNEL in e.key)
    del prof, traced
    # The repeats: full-coverage prefix hits, so no prefill runs.
    again = [router.generate(p, sp, timeout_s=600)
             for p in prompts[:repeats]]
    end = engine.stats()
    flash_repeats = flash_attention.launches - flash_run
    # Grown under the burst, shrunk after it (the repeats run one at a time).
    trace = list(engine.bucket_trace)[trace_from - 1:]
    # The burst again with no trace, on an empty prefix cache so every
    # request prefills as before: the reading phase 9's untraced one is
    # set beside.
    engine.prefix_cache = PrefixKVCache(engine.cb.prefix_cache_tokens,
                                        engine.cb.prefix_block_tokens)
    traced_prefill_ms = list(prefill_ms)
    prefill_ms.clear()
    pre.engine.prefill = timed_prefill
    outs_u, lat_u, wall_u = _burst(
        lambda p: router.generate(p, sp, timeout_s=600), prompts, stagger_s)
    pre.engine.prefill = prefill
    tokens_u = sum(o["num_generated"] for o in outs_u)
    hits = end["prefix_cache"]["hits"] - mid["prefix_cache"]["hits"]
    run_programs = program_deltas(before["programs"], mid["programs"])
    tokens = sum(o["num_generated"] for o in outs)
    rep = {
        "requests": len(outs), "tokens": tokens, "wall_s": wall,
        "solo_tokens": solo["token_ids"],
        "tokens_per_s": tokens / wall, "kernel_trace_on": True,
        "mean_request_s": float(np.mean(lat)),
        "max_request_s": float(np.max(lat)),
        "prefill_ms": traced_prefill_ms,
        "untraced": {"tokens": tokens_u, "wall_s": wall_u,
                     "tokens_per_s": tokens_u / wall_u,
                     "request_s": _percentiles(lat_u),
                     "prefill_ms": prefill_ms},
        "capture_s": captured,
        "decode_by_bucket": run_programs,
        "bucket_trace": trace,
        "max_occupancy": mid["max_occupancy"],
        "preempted": mid["preempted"] - before["preempted"],
        "prefix_cache": end["prefix_cache"],
        "repeat_hits": hits,
        "repeats_equal_first": sum(a["token_ids"] == o["token_ids"]
                                   for a, o in zip(again, outs)),
        # Kernel launches in the burst: the flash forward counted by its
        # wrapper and by the trace; the decode kernel by the trace, beside
        # the wrappers' eager count and each bucket's launches per captured
        # graph times its replays in the burst.
        "launches": {
            "flash_fwd": flash_run,
            "flash_fwd_traced": traced_flash,
            "decode_attention_traced": traced_decode,
            "decode_attention_eager": eager_decode,
            "decode_attention_graph": graph_launches(run_programs),
        },
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    print("cb serve " + json.dumps(rep), flush=True)
    # Checks that leave the later measurements meaningful are gathered and
    # raised at the end.
    problems = []
    if any(o["num_generated"] != max_tokens for o in outs + outs_u):
        problems.append(f"a request did not generate exactly {max_tokens} "
                        "tokens")
    if any(not 0 <= t < cfg.vocab_size for o in outs for t in o["token_ids"]):
        problems.append("token id out of the vocabulary")
    if flash_run != cfg.n_layer * len(prompts):
        problems.append(f"flash launches {flash_run} != {cfg.n_layer} x "
                        f"{len(prompts)} prefills")
    if 8 not in trace or trace[-1] >= 8:
        problems.append(f"bucket trace {trace}: must reach 8 and shrink")
    if hits != repeats or flash_repeats:
        problems.append(f"{hits} prefix hits for {repeats} repeats, "
                        f"{flash_repeats} flash launches in them")
    if rep["launches"]["decode_attention_graph"] <= 0:
        problems.append("the decode kernel ran in no graph replay")
    if traced_decode != eager_decode + rep["launches"]["decode_attention_graph"]:
        problems.append(f"{traced_decode} {DECODE_KERNEL} kernels traced in "
                        f"the burst, want {eager_decode} eager + "
                        f"{rep['launches']['decode_attention_graph']} replayed")
    if traced_flash != flash_run:
        problems.append(f"{traced_flash} {FLASH_KERNEL} kernels traced in the "
                        f"burst, {flash_run} counted by the wrapper")
    dec.close()
    rep["profile"] = profile_cb(engine, pre.engine, prompts[:8], 10)
    print("cb profile " + json.dumps(rep["profile"]), flush=True)
    if rep["profile"]["decode_kernels_per_step"] != cfg.n_layer:
        problems.append(
            f"{rep['profile']['decode_kernels_per_step']} {DECODE_KERNEL} "
            f"kernels per replayed step in the profile, want {cfg.n_layer}")
    # bf16 at full width: batch shape changes rounding, so outputs are only
    # counted against solo runs, not asserted.
    solo = TorchLLMEngine(dataclasses.replace(ecfg, max_batch_size=1))
    want = solo.generate(prompts, sp)
    rep["match_solo"] = sum(w["token_ids"] == o["token_ids"]
                            for w, o in zip(want, outs))
    print(f"cb outputs equal to solo runs: {rep['match_solo']} of "
          f"{len(outs)}", flush=True)
    if problems:
        raise AssertionError("cb serve: " + "; ".join(problems))
    del solo, engine, dec, pre, router, params
    torch.cuda.empty_cache()
    return rep


def logit_gap(fam, params, cfg, prompt_ids, want, step: int) -> dict:
    """The solo run's logits at the first diverging step: prefill, then
    decode the expected tokens one at a time at batch 1."""
    n, dev = len(prompt_ids), params["wte"].device
    cache = fam.init_cache(cfg, 1, n + len(want) + 1, dev)
    logits, _ = fam.prefill(params, torch.tensor([prompt_ids], device=dev),
                            torch.tensor([n], device=dev), cache, cfg)
    for i in range(step):
        logits, _ = fam.decode_step(
            params, torch.tensor([want[i]], device=dev),
            torch.tensor([n + i], dtype=torch.int32, device=dev), cache, cfg)
    top = torch.topk(logits[0], 2)
    return {"step": step, "top2_logits": top.values.tolist(),
            "top2_ids": top.indices.tolist()}


def cb_parity(model_cfg):
    """f32 token parity of the continuous-batching path with solo
    ``TorchLLMEngine`` runs: staggered admissions across buckets 1 -> 8,
    a forced preemption (starvation timeout 0, stepped by hand), a cancel
    and a prefix-cache hit.  Every finished result must equal its solo
    run."""
    fam = model_family(model_cfg)
    params = fam.init(torch.Generator("cuda").manual_seed(SEED + 10),
                      model_cfg)
    cb = ContinuousBatchingConfig(starvation_timeout_s=0.0, shrink_patience=4,
                                  preempt_min_tokens=2)
    ecfg = EngineConfig(model=model_cfg, max_batch_size=8, max_seq_len=512,
                        seed=SEED, param_loader=lambda: params)
    pre = PrefillEngine(ecfg)
    engine = ContinuousBatchingEngine(ecfg, cb)
    # One admission every 2 steps and lengths growing by 2 tokens: the
    # 11th and 12th arrive with all 8 slots busy, so the guard preempts.
    prompts = make_prompts(12, 20, 300, SEED + 11)
    sps = [SamplingParams(max_tokens=16 + 2 * i, temperature=0.0,
                          stop_token=-1) for i in range(len(prompts))]
    reset_counters()
    rids, step, cancelled, cached = [], 0, None, None
    while len(rids) < len(prompts) or engine.has_unfinished():
        if len(rids) < len(prompts) and step % 2 == 0:
            i = len(rids)
            rids.append(submit_local(engine, pre, prompts[i], sps[i]))
        engine.step()
        step += 1
        if step == 9:
            cancelled = rids[3]
            engine.cancel(cancelled)
        if cached is None and rids and rids[0] in engine._finished:
            cached = engine.submit_cached(prompts[0], sps[0])
            if cached is None:
                raise AssertionError("prefix cache missed a finished prompt")
    results = {rid: engine.result(rid) for rid in rids + [cached]}
    st = engine.stats()
    flash_cb = flash_attention.launches
    if flash_cb != model_cfg.n_layer * len(prompts):
        raise AssertionError(f"flash launches {flash_cb} for {len(prompts)} "
                             "prefills")
    trace = list(engine.bucket_trace)
    if not results[cancelled].get("cancelled"):
        raise AssertionError(f"request {cancelled} was not cancelled")
    if st["preempted"] < 1 or 8 not in trace or trace[-1] >= 8:
        raise AssertionError(f"preempted {st['preempted']}, trace {trace}")
    if st["prefix_cache"]["hits"] != 1:
        raise AssertionError(f"prefix cache {st['prefix_cache']}")
    solo = TorchLLMEngine(dataclasses.replace(ecfg, max_batch_size=1))
    checks = [(rid, i) for i, rid in enumerate(rids) if rid != cancelled]
    checks.append((cached, 0))
    mismatches = []
    for rid, i in checks:
        [want] = solo.generate([prompts[i]], sps[i])
        got = results[rid]["token_ids"]
        if got != want["token_ids"]:
            first = next((j for j, (a, b) in enumerate(
                zip(got, want["token_ids"])) if a != b),
                min(len(got), len(want["token_ids"])))
            ids = encode_prompt(engine.tokenizer, prompts[i], 512)
            mismatches.append({"request": rid, "prompt": i, "got": got,
                               "want": want["token_ids"],
                               **logit_gap(fam, params, model_cfg, ids,
                                           want["token_ids"], first)})
    if mismatches:
        raise AssertionError(f"cb parity {type(model_cfg).__name__}: "
                             f"{json.dumps(mismatches)}")
    rep = {"requests": len(checks), "cancelled": 1,
           "preempted": st["preempted"], "prefix_hits": 1,
           "bucket_trace": trace,
           "graph_launches": graph_launches(st["programs"]),
           "flash_fwd": flash_cb}
    del engine, pre, solo, params
    torch.cuda.empty_cache()
    return rep


# ------------------------------------------------------------------ phase 8
# TinyLlama's K and V for a 1,000-token prompt: K and V x 22 layers x 1,000
# tokens x 8 kv heads x 64 dims, bf16: 45,056,000 bytes.
KV_HANDOFF_SHAPE = (2, 22, 1000, 8, 64)
PUT_GET_ELEMENTS = 32 << 20  # 64 MiB of bf16
EXPECT_MODEL = "H100"  # in the detected accelerator_type label
ROUND_TRIPS = 1000  # no-op tasks and actor calls timed


# The remote functions and actor classes below travel to the workers by
# value (cloudpickle), so they import what they use.
def _noop():
    return None


def _lease_view():
    """What a leased worker sees of the cards."""
    import os

    import torch

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return {"visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "available": torch.cuda.is_available(), "count": n,
            "name": torch.cuda.get_device_name(0) if n else None}


def _sha256(tensor) -> str:
    import hashlib

    import torch

    raw = tensor.contiguous().reshape(-1).view(torch.uint8).cpu().numpy()
    return hashlib.sha256(raw.tobytes()).hexdigest()


def _seeded_kv(device, seed: int):
    g = torch.Generator(device).manual_seed(seed)
    return torch.randn(KV_HANDOFF_SHAPE, generator=g,
                       device=device).to(torch.bfloat16)


class _Pinger:
    def ping(self):
        return None


class _KVProducer:
    def make(self, device, seed):
        return _seeded_kv(device, seed)


class _KVConsumer:
    def take(self, kv):
        """``kv`` arrives resolved from its DeviceRef."""
        from ray_tpu_torch.collective.device_objects import (
            device_object_store,
        )

        return {"device": kv.device.type, "dtype": str(kv.dtype),
                "shape": list(kv.shape), "sha256": _sha256(kv),
                "path": device_object_store().last_transfer_path}


def _greedy_tokens(engine, prompts, max_tokens: int):
    outs = engine.generate(prompts, SamplingParams(max_tokens=max_tokens,
                                                   temperature=0.0))
    return [o["token_ids"] for o in outs]


class _EngineActor:
    """A serving engine inside a GPU-leased worker."""

    def __init__(self, model_cfg, max_batch: int, max_seq: int, seed: int,
                 device):
        self.engine = TorchLLMEngine(EngineConfig(
            model=model_cfg, max_batch_size=max_batch, max_seq_len=max_seq,
            seed=seed), device=device)

    def generate(self, prompts, max_tokens: int):
        reset_counters()
        tokens = _greedy_tokens(self.engine, prompts, max_tokens)
        return {"tokens": tokens,
                "launches": {"decode_attention": decode_attention.launches,
                             "flash_fwd": flash_attention.launches},
                "visible": os.environ.get("CUDA_VISIBLE_DEVICES")}


def _host_copies_ms(x, repeats: int = 3) -> dict:
    """The two host copies a device_fetch of ``x`` makes, each timed alone
    (pageable host memory, median of ``repeats``): the owner's card to the
    host, and the host to the consumer's card."""
    def sync():
        if x.is_cuda:
            torch.cuda.synchronize()

    d2h, h2d = [], []
    for _ in range(repeats):
        sync()
        t0 = time.perf_counter()
        host = x.cpu()
        t1 = time.perf_counter()
        back = host.to(x.device, copy=True)
        sync()
        d2h.append((t1 - t0) * 1e3)
        h2d.append((time.perf_counter() - t1) * 1e3)
        del host, back
    return {"d2h_ms": float(np.median(d2h)), "h2d_ms": float(np.median(h2d))}


def _timed_calls(call, n: int, warmup: int = 20) -> float:
    """Mean wall ms of ``n`` sequential round trips."""
    for _ in range(warmup):
        call()
    t0 = time.perf_counter()
    for _ in range(n):
        call()
    return (time.perf_counter() - t0) / n * 1e3


def runtime_phase(device, model_cfg, prompts, max_tokens: int,
                  init_kwargs=None) -> dict:
    """The port's runtime on the card: GPU detection, CUDA_VISIBLE_DEVICES
    leases, a CUDA tensor through put/get, a KV-sized DeviceRef handed
    between two GPU-leased actors by point-to-point RPC, and a serving
    engine in a GPU-leased actor whose greedy tokens must equal the same
    engine's here.  Every process it starts is stopped before it returns."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.collective.device_objects import (
        DeviceRef,
        device_object_store,
    )

    # Workers import the port from this checkout, wherever the script
    # was started from.
    os.environ["PYTHONPATH"] = os.pathsep.join(
        p for p in (HERE, os.environ.get("PYTHONPATH")) if p)
    dev = torch.device(device)
    driver_name = (torch.cuda.get_device_name(0) if dev.type == "cuda"
                   else None)
    rep = {}
    t0 = time.perf_counter()
    rt.init(num_cpus=4, **(init_kwargs or {}))
    rep["init_s"] = time.perf_counter() - t0
    try:
        gpus = rt.cluster_resources().get("GPU")
        label = rt.nodes()[0]["snapshot"]["labels"].get("accelerator_type",
                                                        "")
        rep["detected"] = {"GPU": gpus, "accelerator_type": label}
        if gpus != 1.0 or EXPECT_MODEL not in label:
            raise AssertionError(f"detection: {rep['detected']}")

        # Leases.  The first num_gpus=1 task needs a worker whose env holds
        # its card, which no pooled worker has: its round trip is a cold
        # start.
        t0 = time.perf_counter()
        rt.get(rt.remote(_noop).options(num_gpus=1).remote(), timeout=120)
        rep["worker_cold_start_s"] = time.perf_counter() - t0
        whole = rt.get(rt.remote(_lease_view).options(num_gpus=1).remote(),
                       timeout=120)
        none = rt.get(rt.remote(_lease_view).options(num_gpus=0).remote(),
                      timeout=120)
        rep["lease_views"] = {"num_gpus=1": whole, "num_gpus=0": none}
        if (whole["visible"], whole["count"], whole["name"]) != (
                "0", 1 if driver_name else 0, driver_name):
            raise AssertionError(f"num_gpus=1 lease saw {whole}")
        if none["visible"] != "" or none["available"]:
            raise AssertionError(f"num_gpus=0 lease saw {none}")

        noop = rt.remote(_noop)
        rep["task_round_trip_ms"] = _timed_calls(
            lambda: rt.get(noop.remote(), timeout=60), ROUND_TRIPS)
        pinger = rt.remote(_Pinger).remote()
        rep["actor_call_ms"] = _timed_calls(
            lambda: rt.get(pinger.ping.remote(), timeout=60), ROUND_TRIPS)
        rt.kill(pinger)

        # A CUDA tensor through the object plane: to the host and into the
        # shm arena on put, a CPU tensor of the same dtype and shape on get.
        g = torch.Generator(device).manual_seed(SEED + 20)
        x = torch.randn(PUT_GET_ELEMENTS, generator=g,
                        device=device).to(torch.bfloat16)
        want = x.cpu()
        nbytes = x.numel() * x.element_size()
        put_s, get_s = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            ref = rt.put(x)
            put_s.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            got = rt.get(ref, timeout=120)
            get_s.append(time.perf_counter() - t0)
            if (got.device.type, got.dtype) != ("cpu", torch.bfloat16) or \
                    not torch.equal(got, want):
                raise AssertionError("put/get of a CUDA tensor changed it")
            del ref, got
        rep["put_get"] = {
            "bytes": nbytes, "put_s": put_s, "get_s": get_s,
            "put_gb_per_s": nbytes / float(np.median(put_s)) / 1e9,
            "get_gb_per_s": nbytes / float(np.median(get_s)) / 1e9}
        del x, want

        # The KV handoff: two actors sharing the card.
        opts = dict(num_gpus=0.25, num_cpus=0, tensor_transport="device",
                    max_concurrency=2)
        producer = rt.remote(_KVProducer).options(**opts).remote()
        consumer = rt.remote(_KVConsumer).options(**opts).remote()
        kv_ref = rt.get(producer.make.remote(device, SEED + 21), timeout=120)
        if not isinstance(kv_ref, DeviceRef) or \
                tuple(kv_ref.shape) != KV_HANDOFF_SHAPE:
            raise AssertionError(f"producer returned {kv_ref!r}")
        want = _seeded_kv(device, SEED + 21)
        want_sha = _sha256(want)
        t0 = time.perf_counter()
        took = rt.get(consumer.take.remote(kv_ref), timeout=120)
        handoff_s = time.perf_counter() - t0
        if (took["device"], took["path"], took["sha256"]) != (
                dev.type, "p2p_rpc", want_sha):
            raise AssertionError(f"the consumer received {took}")
        store = device_object_store()  # the driver's: a borrower
        fetch_s = []
        for _ in range(5):
            t0 = time.perf_counter()
            fetched = store.fetch(kv_ref)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            fetch_s.append(time.perf_counter() - t0)
            if store.last_transfer_path != "p2p_rpc" or \
                    fetched.device.type != dev.type or \
                    not torch.equal(fetched, want):
                raise AssertionError("device_fetch changed the tensor")
            del fetched
        kv_bytes = want.numel() * want.element_size()
        if not store.free(kv_ref) or store.refcount(kv_ref) != 0:
            raise AssertionError("the producer still holds the KV tensor")
        rep["kv_handoff"] = {
            "bytes": kv_bytes, "consumer": took, "consumer_call_s": handoff_s,
            "device_fetch_s": fetch_s,
            "device_fetch_ms": float(np.median(fetch_s)) * 1e3,
            "device_fetch_gb_per_s": kv_bytes / float(np.median(fetch_s))
            / 1e9,
            "host_copies": _host_copies_ms(want)}
        for actor in (producer, consumer):
            rt.kill(actor)
        del want

        # The serving path in a GPU-leased actor, against the same engine
        # here.
        engine_actor = rt.remote(_EngineActor).options(
            num_gpus=0.5, num_cpus=0).remote(model_cfg, len(prompts),
                                             model_cfg.max_seq, SEED, device)
        t0 = time.perf_counter()
        remote_out = rt.get(engine_actor.generate.remote(prompts, max_tokens),
                            timeout=600)
        rep["actor_generate_s"] = time.perf_counter() - t0
        rt.kill(engine_actor)
        local = TorchLLMEngine(EngineConfig(
            model=model_cfg, max_batch_size=len(prompts),
            max_seq_len=model_cfg.max_seq, seed=SEED), device=device)
        want_tokens = _greedy_tokens(local, prompts, max_tokens)
        del local
        rep["actor_engine"] = {
            "launches": remote_out["launches"],
            "visible": remote_out["visible"],
            "tokens_equal": remote_out["tokens"] == want_tokens,
            "tokens": [len(t) for t in want_tokens]}
        if remote_out["tokens"] != want_tokens:
            raise AssertionError(
                f"the actor's tokens {remote_out['tokens']} differ from "
                f"the driver's {want_tokens}")
        if min(remote_out["launches"].values()) <= 0:
            raise AssertionError(
                f"the actor launched no kernel: {remote_out['launches']}")
    finally:
        rt.shutdown()
    return rep


# ------------------------------------------------------------------ phase 9
# The OpenAI apps are reached over HTTP through the serve proxy, which
# needs aiohttp.
SERVE_SEED = SEED + 8  # phase 7's weights: each engine makes them from this
BURST_PROMPTS = (16, 100, 1500, SEED + 12)  # phase 7's traffic
APP_TOKENS = 32  # 9a's greedy tokens a request
APP_BODIES = 4  # 9a's completions, and as many chats, sent at once


def _free_port() -> int:
    """A port no process holds now: bound to port 0, then closed
    (``start_http_proxy(port=0)`` would name port 0 in its URL)."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _post(url: str, body: dict, timeout: float = 600.0):
    """POST a JSON body; returns the urllib response (a context manager)."""
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=timeout)


def _post_unary(url: str, body: dict) -> dict:
    with _post(url, body) as resp:
        return json.loads(resp.read())["result"]


def _post_sse(url: str, body: dict):
    """The SSE chunks of a streamed request and its trace id; the frames
    must end in ``[DONE]``."""
    with _post(url, body) as resp:
        trace_id = resp.headers["x-ray-tpu-trace-id"]
        frames = [line[len("data: "):]
                  for line in resp.read().decode().splitlines()
                  if line.startswith("data: ")]
    if not frames or frames[-1] != "[DONE]":
        raise AssertionError(f"SSE frames end in {frames[-1:]}")
    return [json.loads(f) for f in frames[:-1]], trace_id


class _IdRecorder(ByteTokenizer):
    """The byte tokenizer, keeping the ids of every decode: random weights
    pick ids past the byte range, which decode to no text."""

    def __init__(self):
        self.decoded = []

    def decode(self, ids):
        self.decoded.append(list(ids))
        return super().decode(ids)


def _counted_llm_server():
    """``build_openai_app``'s replica class with one phase-local method
    that reads (and optionally zeroes) its kernel counters, its lease and
    the ids its engine decoded."""

    class _CountedLLMServer(serve_app.LLMServer.func_or_class):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.engine.tokenizer = _IdRecorder()

        def probe(self, reset: bool = False):
            out = {"visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                   "launches": {"decode_attention": decode_attention.launches,
                                "flash_fwd": flash_attention.launches},
                   "decoded": self.engine.tokenizer.decoded}
            if reset:
                reset_counters()
                self.engine.tokenizer.decoded = []
            return out

    return _CountedLLMServer


def _completion_body(prompt: str, max_tokens: int, chat: bool = False,
                     stream: bool = False) -> dict:
    body = ({"messages": [{"role": "user", "content": prompt}]} if chat
            else {"prompt": prompt})
    body["max_tokens"] = max_tokens
    if stream:
        body["stream"] = True
    return body


def openai_app_phase(serve, ecfg) -> dict:
    """9a: ``build_openai_app`` with one half-card replica behind the HTTP
    proxy: a prompt alone against the same engine here, then 4 completions
    and 4 chats at once and one streamed completion."""
    from ray_tpu_torch.llm.serve_app import _prompt_from_body

    app = build_openai_app(ecfg, num_gpus=0.5)
    app = dataclasses.replace(app, deployment=dataclasses.replace(
        app.deployment, func_or_class=_counted_llm_server()))
    t0 = time.perf_counter()
    handle = serve.run(app)
    url = serve.start_http_proxy(port=_free_port())
    rep = {"deploy_s": time.perf_counter() - t0}
    try:
        _post_unary(url + "/v1/completions", _completion_body("warm up", 2))
        # A prompt alone, against the same engine here (the same weights,
        # slots and width) given that prompt alone.
        handle.probe.remote(reset=True).result(timeout=60)
        solo = _post_unary(url + "/v1/completions",
                           _completion_body(SOLO_PROMPT, APP_TOKENS))
        decoded = handle.probe.remote(reset=True).result(timeout=60)
        local = TorchLLMEngine(ecfg)
        [want] = local.generate([SOLO_PROMPT], SamplingParams(
            max_tokens=APP_TOKENS, temperature=0.0))
        del local
        torch.cuda.empty_cache()
        rep["solo"] = {"tokens_equal": want["token_ids"] in decoded["decoded"],
                       "text_equal":
                           solo["choices"][0]["text"] == want["text"],
                       "completion_tokens": solo["usage"]["completion_tokens"],
                       "local_tokens": want["num_generated"]}
        if not (rep["solo"]["tokens_equal"] and rep["solo"]["text_equal"]
                and want["num_generated"]
                == solo["usage"]["completion_tokens"]):
            raise AssertionError(f"9a alone: {rep['solo']}, here {want}")

        prompts = make_prompts(APP_BODIES, 100, 1500, SEED + 41)
        bodies = [(path, _completion_body(p, APP_TOKENS, chat=chat))
                  for chat, path in ((False, "/v1/completions"),
                                     (True, "/v1/chat/completions"))
                  for p in prompts]
        outs, lat, wall = _burst(
            lambda pb: _post_unary(url + pb[0], pb[1]), bodies, 0.0)
        # prompts[0] alone, unary then streamed: the ids each decoded.
        n0 = len(handle.probe.remote().result(timeout=60)["decoded"])
        unary = _post_unary(url + "/v1/completions", _completion_body(
            prompts[0], APP_TOKENS))
        unary_ids = handle.probe.remote().result(timeout=60)["decoded"][n0:]
        chunks, _ = _post_sse(url + "/v1/completions", _completion_body(
            prompts[0], APP_TOKENS, stream=True))
        after = handle.probe.remote().result(timeout=60)
        stream_ids = after["decoded"][n0 + len(unary_ids):]
    finally:
        serve.stop_http_proxy()
    serve.delete("LLMServer")
    tok = ByteTokenizer()
    problems = []
    for (path, body), out in zip(bodies, outs):
        chat = "messages" in body
        n_prompt = len(tok.encode(_prompt_from_body(body)))
        usage = out["usage"]
        if out["object"] != ("chat.completion" if chat
                             else "text_completion") or usage[
                "prompt_tokens"] != n_prompt or not (
                1 <= usage["completion_tokens"] <= APP_TOKENS) or usage[
                "total_tokens"] != n_prompt + usage["completion_tokens"]:
            problems.append(f"{path}: {out['object']} {usage}")
    streamed = "".join(c["choices"][0]["text"] for c in chunks)
    if chunks[-1]["choices"][0]["finish_reason"] != "stop" or any(
            c["object"] != "text_completion" for c in chunks):
        problems.append(f"SSE chunks {chunks[-1:]}")
    if streamed != unary["choices"][0]["text"]:
        problems.append(f"streamed {streamed!r} != unary "
                        f"{unary['choices'][0]['text']!r}")
    # The stream decodes each step's new ids, then at retirement the whole
    # result and the tail not yet sent: the deltas and the tail must join
    # to the result, and the result must be the unary request's ids.
    sent = [t for ids in stream_ids[:-2] + stream_ids[-1:] for t in ids]
    if len(unary_ids) != 1 or len(stream_ids) < 2 or \
            stream_ids[-2] != unary_ids[0] or sent != unary_ids[0]:
        problems.append(f"streamed ids {stream_ids} != unary {unary_ids}")
    n_layer = ecfg.model.n_layer
    launches = after["launches"]
    # Every prefill (8 bodies, the unary and the stream) runs the flash
    # forward once a layer; every eager decode step runs the decode kernel
    # once a layer.
    if launches["flash_fwd"] != n_layer * (len(bodies) + 2) or \
            launches["decode_attention"] <= 0 or \
            launches["decode_attention"] % n_layer:
        problems.append(f"launches {launches}")
    if after["visible"] != "0":
        problems.append(f"replica saw CUDA_VISIBLE_DEVICES={after['visible']}")
    rep.update({
        "requests": len(bodies), "wall_s": wall,
        "requests_per_s": len(bodies) / wall,
        "latency_s": _percentiles(lat),
        "completion_tokens": [o["usage"]["completion_tokens"] for o in outs],
        "stream_chunks": len(chunks), "stream_deltas": len(stream_ids) - 2,
        "stream_ids_equal": stream_ids[-2:-1] == unary_ids,
        "launches": launches,
        "visible": after["visible"]})
    print("serve app " + json.dumps(rep), flush=True)
    if problems:
        raise AssertionError("9a: " + "; ".join(problems))
    return rep


@dataclasses.dataclass
class _SentParams(SamplingParams):
    """Sampling settings carrying the client's send time, on the host's
    monotonic clock, which every process here shares."""

    sent_t: float = 0.0


class _TimedPrefill(PrefillReplica):
    """The prefill role, timing each prefill and the wait before it, and
    counting its launches in its own process.  The request's send time
    becomes its enqueue time, from which the decode engine's own serving
    telemetry counts its TTFT."""

    def prefill(self, prompt, params=None):
        t0 = time.monotonic()
        meta = super().prefill(prompt, params)
        meta.update(prefill_s=time.monotonic() - t0,
                    prefill_wait_s=t0 - params.sent_t, enq_t=params.sent_t)
        return meta

    def launches(self, reset: bool = False):
        out = {"flash_fwd": flash_attention.launches,
               "decode_attention": decode_attention.launches}
        if reset:
            reset_counters()
        return out


class _TimedDecode(BatchedDecodeReplica):
    """The batched decode role as shipped, with phase-local probes: the KV
    handoff (the fetch of the prefill actor's pages onto this card), timed
    from the call to the engine's ``submit_kv`` with the copy's stream
    synchronized; each request's TTFT as the engine's serving telemetry
    records it; and a kernel trace of this process between two calls."""

    def __init__(self, *args, **kwargs):
        from ray_tpu_torch.util import flight_recorder

        super().__init__(*args, **kwargs)
        self._call = threading.local()
        self._ttft_s = []
        self._opened, self._closed = threading.Event(), threading.Event()
        submit = self.engine.submit_kv
        record = flight_recorder.record_serve_stream

        def timed_submit(meta, k, v):
            torch.cuda.current_stream(k.device).synchronize()
            self._call.fetch_s = time.perf_counter() - self._call.t0
            self._call.kv_bytes = (k.numel() * k.element_size()
                                   + v.numel() * v.element_size())
            return submit(meta, k, v)

        def kept(deployment, replica, queue_wait_s, ttft_s, gaps,
                 outcome="ok"):
            self._ttft_s.append(ttft_s)
            record(deployment, replica, queue_wait_s, ttft_s, gaps,
                   outcome=outcome)

        self.engine.submit_kv = timed_submit
        flight_recorder.record_serve_stream = kept

    def run_from_kv(self, meta, timeout_s: float = 300.0):
        fetch_from = time.monotonic() - meta["enq_t"]
        self._call.t0 = time.perf_counter()
        out = super().run_from_kv(meta, timeout_s)
        out.update(fetch_s=self._call.fetch_s, kv_bytes=self._call.kv_bytes,
                   fetch_from_s=fetch_from, prefill_s=meta["prefill_s"],
                   prefill_wait_s=meta["prefill_wait_s"])
        return out

    def ttfts(self, n: int, reset: bool = False, timeout_s: float = 30.0):
        """The TTFTs recorded since the last reset, once there are ``n``
        (a request's telemetry is recorded just after its result)."""
        deadline = time.monotonic() + timeout_s
        while len(self._ttft_s) < n and time.monotonic() < deadline:
            time.sleep(0.01)
        out = list(self._ttft_s)
        if reset:
            self._ttft_s.clear()
        return out

    def trace_window(self):
        """Trace this process's kernels on the card until ``close_window``;
        returns the decode kernels traced by name, beside the eager launches
        and the graph replays' launches (per capture times steps) made in
        between."""
        self._closed.clear()
        with kernel_trace() as prof:
            before = self.engine.stats()["programs"]
            eager = decode_attention.launches
            self._opened.set()
            self._closed.wait(600)
            eager = decode_attention.launches - eager
            after = self.engine.stats()["programs"]
        self._opened.clear()
        traced = sum(e.count for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and DECODE_KERNEL in e.key)
        return {"traced": traced, "eager": eager,
                "replayed": graph_launches(program_deltas(before, after))}

    def window_opened(self) -> bool:
        return self._opened.wait(600)

    def close_window(self) -> None:
        self._closed.set()


def _probed_disagg_server():
    """``build_disagg_openai_app``'s replica class with one phase-local
    method that returns the token ids of its unary requests (random
    weights pick ids past the byte range, which decode to no text)."""

    class _ProbedDisaggServer(serve_app.LLMDisaggServer.func_or_class):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.generated = []
            generate = self.router.generate

            def kept(*a, **kw):
                out = generate(*a, **kw)
                self.generated.append(out["token_ids"])
                return out

            self.router.generate = kept

        def probe(self):
            return self.generated

    return _ProbedDisaggServer


def _graph_check(programs: dict, n_layer: int, what: str) -> None:
    """Each bucket's program (``stats()["programs"]``) must be a CUDA graph
    that replays ``n_layer`` decode kernels a step: the graph launches a
    report gives are these per capture times the steps replayed."""
    bad = {b: (p["graph"], p["launches_per_step"])
           for b, p in programs.items()
           if p["launches_per_step"].get("decode_attention") != n_layer
           or not p["graph"]}
    if bad:
        raise AssertionError(f"{what}: graph, launches per step {bad}")


def _wait_captured(stats, timeout_s: float = 600.0) -> dict:
    """Poll ``stats()`` until buckets 1, 2, 4 and 8 are captured graphs.
    A decode actor still starting answers no ``stats()`` call in time: that
    is retried until the deadline."""
    from ray_tpu_torch.core.exceptions import GetTimeoutError

    deadline = time.monotonic() + timeout_s
    programs = None
    while time.monotonic() < deadline:
        try:
            programs = stats()["programs"]
        except GetTimeoutError:
            continue
        if sorted(programs) == [1, 2, 4, 8] and all(
                p["graph"] for p in programs.values()):
            return {b: p["capture_s"] for b, p in programs.items()}
        time.sleep(0.5)
    raise AssertionError(f"buckets not captured: {programs}")


def actor_route_phase(rt, ecfg, cb_cfg, prompts, max_tokens: int,
                      want_solo) -> dict:
    """9b, the actor route: ``DisaggRouter`` over a prefill and a batched
    decode actor (half a card each) that time and count their work: a
    request alone must give phase 7's in-process tokens; then phase 7's
    burst, untraced, with each request's TTFT, prefill wait, prefill and
    KV handoff; then a request alone under a kernel trace in the decode
    actor."""
    Pre = rt.remote(num_cpus=0, num_gpus=0.5)(_TimedPrefill)
    Dec = rt.remote(num_cpus=0, num_gpus=0.5, max_concurrency=64)(
        _TimedDecode)
    pre, dec = Pre.remote(ecfg), Dec.remote(ecfg, cb_cfg)
    try:
        rt.get(dec.warm.remote(), timeout=600)
        captured = _wait_captured(
            lambda: rt.get(dec.stats.remote(), timeout=60))
        router = DisaggRouter([pre], [dec])
        sp = _SentParams(max_tokens=max_tokens, temperature=0.0,
                         stop_token=-1)

        def send(prompt):
            return router.generate(
                prompt, dataclasses.replace(sp, sent_t=time.monotonic()),
                timeout_s=900)

        router.generate("warm up", _SentParams(max_tokens=2,
                                               sent_t=time.monotonic()))
        solo = send(SOLO_PROMPT)
        rep = {"capture_s": captured,
               "solo_equal": solo["token_ids"] == want_solo,
               "solo_kv_handoff": {"bytes": solo["kv_bytes"],
                                   "ms": solo["fetch_s"] * 1e3}}
        if not rep["solo_equal"]:
            raise AssertionError(
                f"actor route alone: {solo['token_ids']} != phase 7's "
                f"{want_solo}")
        rt.get(pre.launches.remote(reset=True), timeout=60)
        rt.get(dec.ttfts.remote(2, reset=True), timeout=60)  # warm-up, solo
        before = rt.get(dec.stats.remote(), timeout=60)
        outs, lat, wall = _burst(send, prompts, 0.05)
        after = rt.get(dec.stats.remote(), timeout=60)
        pre_launches = rt.get(pre.launches.remote(), timeout=60)
        ttft = rt.get(dec.ttfts.remote(len(prompts)), timeout=60)
        # One more request alone under a kernel trace in the decode actor,
        # after the timed burst, which thus ran in a process never traced.
        window = dec.trace_window.remote()
        rt.get(dec.window_opened.remote(), timeout=600)
        send(make_prompts(1, 100, 1500, SEED + 42)[0])
        rt.get(dec.close_window.remote(), timeout=60)
        solo_trace = rt.get(window, timeout=120)
    finally:
        for actor in (pre, dec):
            rt.kill(actor)
    n_layer = ecfg.model.n_layer
    _graph_check(after["programs"], n_layer, "actor route")
    run_programs = program_deltas(before["programs"], after["programs"])
    tokens = sum(o["num_generated"] for o in outs)
    kv_bytes = [o["kv_bytes"] for o in outs]
    fetch_s = [o["fetch_s"] for o in outs]
    # Per request, in arrival order (the clients start 50 ms apart).
    rep.update({
        "solo_trace": solo_trace,
        "requests": len(outs), "tokens": tokens, "wall_s": wall,
        "tokens_per_s": tokens / wall, "kernel_trace_on": False,
        "request_s": _percentiles(lat),
        "ttft_s": _percentiles(ttft) if len(ttft) == len(prompts) else None,
        "prefill_wait_ms": [o["prefill_wait_s"] * 1e3 for o in outs],
        "prefill_ms": [o["prefill_s"] * 1e3 for o in outs],
        "kv_handoff": {
            "bytes": kv_bytes, "ms": [f * 1e3 for f in fetch_s],
            "from_send_ms": [o["fetch_from_s"] * 1e3 for o in outs],
            "gb_per_s": [b / f / 1e9 for b, f in zip(kv_bytes, fetch_s)]},
        "decode_by_bucket": run_programs,
        "launches": {"flash_fwd_prefill_actor": pre_launches["flash_fwd"],
                     "decode_attention_graph": graph_launches(run_programs),
                     "decode_attention_traced_solo": solo_trace["traced"]}})
    print("disagg actor route " + json.dumps(rep), flush=True)
    problems = []
    if any(o["num_generated"] != max_tokens for o in outs):
        problems.append(f"a request did not generate {max_tokens} tokens")
    if len(ttft) != len(prompts):
        problems.append(f"{len(ttft)} TTFTs recorded for {len(prompts)} "
                        "requests")
    if pre_launches["flash_fwd"] != n_layer * len(prompts):
        problems.append(f"prefill actor flash launches "
                        f"{pre_launches['flash_fwd']} != {n_layer} x "
                        f"{len(prompts)}")
    if solo_trace["replayed"] <= 0 or solo_trace["traced"] != \
            solo_trace["eager"] + solo_trace["replayed"]:
        problems.append(f"{solo_trace['traced']} {DECODE_KERNEL} traced in "
                        f"the decode actor for a request alone, want "
                        f"{solo_trace['eager']} eager + "
                        f"{solo_trace['replayed']} replayed")
    if problems:
        raise AssertionError("9b actor route: " + "; ".join(problems))
    return rep


def disagg_app_phase(rt, serve, ecfg, cb_cfg, prompts, max_tokens: int,
                     repeats: int, want_solo) -> dict:
    """9b, the app: ``build_disagg_openai_app`` behind the HTTP proxy,
    every bucket captured first; a request alone must give phase 7's
    tokens; then phase 7's burst, ``repeats`` of it again (router prefix
    hits), and one streamed request whose trace must gather spans from 3
    processes."""
    from ray_tpu_torch.util import obs, tracing

    app = build_disagg_openai_app(ecfg, cb_cfg=cb_cfg)
    app = dataclasses.replace(app, deployment=dataclasses.replace(
        app.deployment, func_or_class=_probed_disagg_server()))
    t0 = time.perf_counter()
    handle = serve.run(app)
    url = serve.start_http_proxy(port=_free_port())
    rep = {"deploy_s": time.perf_counter() - t0}
    try:
        stats = lambda: handle.stats.remote().result(timeout=60)  # noqa: E731
        rep["capture_s"] = _wait_captured(lambda: stats()["decode"][0])
        rep["ready_s"] = time.perf_counter() - t0
        path = url + "/v1/completions"
        _post_unary(path, _completion_body("warm up", 2))
        n0 = len(handle.probe.remote().result(timeout=60))
        _post_unary(path, _completion_body(SOLO_PROMPT, max_tokens))
        solo_ids = handle.probe.remote().result(timeout=60)[n0:]
        before = stats()

        def send(prompt):
            return _post_unary(path, _completion_body(prompt, max_tokens))

        outs, lat, wall = _burst(send, prompts, 0.05)
        mid = stats()
        for p in prompts[:repeats]:
            send(p)
        end = stats()
        chunks, trace_id = _post_sse(path, _completion_body(
            prompts[0], max_tokens, stream=True))
        deadline = time.monotonic() + 120
        while True:
            procs = obs.trace_processes(trace_id)
            names = {sp["name"] for sp in tracing.get_trace(trace_id,
                                                            timeout=30)}
            if len(procs) >= 3 and {"serve.http.stream",
                                    "serve.request.stream"} <= names:
                break
            if time.monotonic() > deadline:
                raise AssertionError(f"trace {trace_id}: {len(procs)} "
                                     f"processes, spans {sorted(names)}")
            time.sleep(0.5)
    finally:
        serve.stop_http_proxy()
    serve.delete("LLMDisaggServer")
    n_layer = ecfg.model.n_layer
    _graph_check(mid["decode"][0]["programs"], n_layer, "disagg app")
    run_programs = program_deltas(before["decode"][0]["programs"],
                                  mid["decode"][0]["programs"])
    tokens = sum(o["usage"]["completion_tokens"] for o in outs)
    hits = end["router"]["hits"] - mid["router"]["hits"]
    # The app samples to the byte tokenizer's EOS, which phase 7's
    # reference (stop_token=-1) runs past.
    eos = ByteTokenizer.EOS
    want = want_solo[:want_solo.index(eos)] if eos in want_solo else want_solo
    rep.update({
        "solo_equal": solo_ids == [want],
        "requests": len(outs), "tokens": tokens, "wall_s": wall,
        "tokens_per_s": tokens / wall, "request_s": _percentiles(lat),
        "decode_by_bucket": run_programs, "router_repeat_hits": hits,
        "engine_prefix_cache": end["decode"][0]["prefix_cache"],
        "trace_processes": len(procs), "stream_chunks": len(chunks),
        "launches": {"decode_attention_graph": graph_launches(run_programs)}})
    print("disagg app " + json.dumps(rep), flush=True)
    problems = []
    if not rep["solo_equal"]:
        problems.append(f"the prompt alone gave {solo_ids}, phase 7's "
                        f"router {want}")
    if hits != repeats:
        problems.append(f"{hits} router prefix hits for {repeats} repeats")
    if chunks[-1]["choices"][0]["finish_reason"] != "stop":
        problems.append(f"SSE ends in {chunks[-1]}")
    if any(not 1 <= o["usage"]["completion_tokens"] <= max_tokens
           for o in outs):
        problems.append("a completion's token count is out of range")
    if problems:
        raise AssertionError("9b app: " + "; ".join(problems))
    return rep


def serve_phase(cb_solo_tokens, max_tokens: int, repeats: int) -> dict:
    """Phase 9: the Serve layer and both OpenAI apps at TinyLlama-1.1B's
    width, bf16, under ``ray_tpu_torch.init(num_cpus=4)`` with the card
    found by detection; each engine in its own GPU-leased process.  Every
    process it starts is stopped before it returns."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve

    os.environ["PYTHONPATH"] = os.pathsep.join(
        p for p in (HERE, os.environ.get("PYTHONPATH")) if p)
    cfg = LlamaConfig.tinyllama_1b()
    ecfg = EngineConfig(model=cfg, max_batch_size=8, max_seq_len=2048,
                        seed=SERVE_SEED)
    # The prefix cache holds the whole burst's prompts, as in phase 7.
    cb_cfg = ContinuousBatchingConfig(prefix_cache_tokens=32768)
    prompts = make_prompts(*BURST_PROMPTS)
    rt.init(num_cpus=4)
    try:
        if rt.cluster_resources().get("GPU") != 1.0:
            raise AssertionError(f"detected {rt.cluster_resources()}")
        rep = {"openai_app": openai_app_phase(serve, ecfg)}
        rep["actor_route"] = actor_route_phase(
            rt, ecfg, cb_cfg, prompts, 64, cb_solo_tokens)
        rep["disagg_app"] = disagg_app_phase(
            rt, serve, ecfg, cb_cfg, prompts, 64, repeats, cb_solo_tokens)
    finally:
        serve.shutdown()
        rt.shutdown()
    return rep


# ----------------------------------------------------------------- phase 10
# Phase 10's traffic: a file of seeded prompts, 8 a block (one engine's
# slots); the counted runs take the first 64 of them.
DATA_PROMPTS = (128, 100, 1500, SEED + 50)
DATA_BLOCKS = 16
DATA_COUNTED = 64
DATA_TOKENS = 64


def wait_card_free(rt, timeout_s: float = 120.0) -> float:
    """Wait until no lease holds any share of the card: a pool is torn down
    with ``kill``, which does not wait for the kill to land.  Returns the
    wait in seconds."""
    t0 = time.monotonic()
    while rt.available_resources().get("GPU", 0.0) < 1.0:
        if time.monotonic() - t0 > timeout_s:
            raise AssertionError(
                f"the card is still leased: {rt.available_resources()}")
        time.sleep(0.1)
    return time.monotonic() - t0


def _prompt_rows(prompts):
    return [{"id": i, "prompt": p} for i, p in enumerate(prompts)]


class _SeededWeights:
    """An engine's weights made as the engine makes them (seeded, on its
    device), writing down first the lease of the process that makes them:
    the shipped processor's actors run no code of this script but this."""

    def __init__(self, cfg, seed: int, device, out_dir: str):
        self.cfg, self.seed, self.device = cfg, seed, device
        self.out_dir = out_dir

    def __call__(self):
        dev = resolve_device(self.device)
        with open(os.path.join(self.out_dir, f"{os.getpid()}.json"), "w") as f:
            json.dump({"pid": os.getpid(), "device": str(dev),
                       "visible": os.environ.get("CUDA_VISIBLE_DEVICES")}, f)
        gen = torch.Generator(device=dev).manual_seed(self.seed)
        return model_family(self.cfg).init(gen, self.cfg, dev)


def shipped_processor(rd, ecfg, prompts, device, tmp: str) -> dict:
    """10a: ``build_llm_processor`` as shipped over a parquet file of
    prompts, two actors leasing half the card each."""
    src = os.path.join(tmp, "prompts")
    leases = os.path.join(tmp, "leases")
    os.makedirs(leases)
    rd.from_items(_prompt_rows(prompts), parallelism=DATA_BLOCKS
                  ).write_parquet(src)
    cfg = dataclasses.replace(ecfg, param_loader=_SeededWeights(
        ecfg.model, ecfg.seed, device, leases))
    process = build_llm_processor(
        cfg, SamplingParams(max_tokens=DATA_TOKENS, temperature=0.0),
        concurrency=2, num_gpus=0.5, device=device)
    t0 = time.perf_counter()
    rows_iter = process(rd.read_parquet(src)).iter_rows()
    # take_all() is list(iter_rows()): the same, with the first row timed.
    rows = [next(rows_iter)]
    first_block_s = time.perf_counter() - t0
    rows += list(rows_iter)
    wall = time.perf_counter() - t0
    seen = [json.load(open(os.path.join(leases, f)))
            for f in sorted(os.listdir(leases))]
    problems = []
    if sorted(int(r["id"]) for r in rows) != list(range(len(prompts))):
        problems.append(f"{len(rows)} rows, not one for each of "
                        f"{len(prompts)} prompts")
    wrong = [int(r["id"]) for r in rows
             if r["prompt"] != prompts[int(r["id"])]
             or not isinstance(r["generated"], str)]
    if wrong:
        problems.append(f"rows {wrong[:8]} lost their prompt or text")
    if len(seen) != 2 or any(s["visible"] != "0" for s in seen):
        problems.append(f"data actors' leases {seen}")
    if problems:
        raise AssertionError("10a: " + "; ".join(problems))
    return {"rows": len(rows), "wall_s": wall,
            "rows_per_s": len(rows) / wall, "first_block_s": first_block_s,
            "actors": seen}


class _CountedStage(_LLMStage):
    """The shipped stage, which also writes into each of a block's rows the
    block's token ids, this actor's pid and lease, the engine's
    ``EngineStats`` over the block, and the block's launches of the flash
    forward and decode kernels (counters zeroed when the actor starts)."""

    def __init__(self, *args):
        super().__init__(*args)
        reset_counters()
        self.blocks = 0

    def __call__(self, block):
        outs = []
        generate = self.engine.generate

        def keep(prompts, params):  # the shipped call's outputs, kept
            outs.extend(generate(prompts, params))
            return outs

        t0 = time.monotonic()
        f0, d0 = flash_attention.launches, decode_attention.launches
        s0 = dataclasses.replace(self.engine.stats)
        self.engine.generate = keep
        try:
            rows = super().__call__(block)
        finally:
            del self.engine.generate
        s1 = self.engine.stats
        meta = {"pid": os.getpid(), "block": self.blocks, "t0": t0,
                "t1": time.monotonic(),
                "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "flash": flash_attention.launches - f0,
                "decode": decode_attention.launches - d0,
                **{k: getattr(s1, k) - getattr(s0, k) for k in (
                    "prefills", "prefill_s", "decode_steps", "decode_s",
                    "tokens")}}
        self.blocks += 1
        return [{**row, **meta, "token_ids": out["token_ids"]}
                for row, out in zip(rows, outs)]


def counted_run(rt, rd, ecfg, prompts, n: int, device) -> dict:
    """10b: the counted stage under ``ActorPoolStrategy(size=n,
    num_gpus=1/n)``; gates every actor's launch counts on its engine's
    prefills and eager steps.  Returns the blocks in the order they came
    out, with the run's readings."""
    waited = wait_card_free(rt)
    sp = SamplingParams(max_tokens=DATA_TOKENS, temperature=0.0)
    ds = rd.from_items(_prompt_rows(prompts), parallelism=len(prompts) // 8)
    t0 = time.perf_counter()
    rows = ds.map_batches(
        _CountedStage, fn_constructor_args=(ecfg, sp, "prompt", "generated",
                                            device),
        compute=rd.ActorPoolStrategy(size=n, num_gpus=1 / n, num_cpus=0),
    ).take_all()
    wall = time.perf_counter() - t0
    blocks = {}
    for r in rows:
        b = blocks.setdefault((r["pid"], r["block"]), {
            k: r[k] for k in ("pid", "block", "t0", "t1", "visible", "flash",
                              "decode", "prefills", "prefill_s",
                              "decode_steps", "decode_s", "tokens")}
            | {"ids": [], "rows": [], "prompts": []})
        b["ids"].append(r["token_ids"])
        b["rows"].append(r["id"])
        b["prompts"].append(r["prompt"])
    blocks = list(blocks.values())
    n_layer = ecfg.model.n_layer
    actors = {}
    for b in blocks:
        a = actors.setdefault(b["pid"], {
            "visible": b["visible"], "blocks": 0, "rows": 0, "flash": 0,
            "decode": 0, "prefills": 0, "prefill_s": 0.0, "decode_steps": 0,
            "decode_s": 0.0})
        a["blocks"] += 1
        a["rows"] += len(b["rows"])
        for k in ("flash", "decode", "prefills", "prefill_s", "decode_steps",
                  "decode_s"):
            a[k] += b[k]
    problems = []
    if sorted(r["id"] for r in rows) != list(range(len(prompts))):
        problems.append(f"{len(rows)} rows for {len(prompts)} prompts")
    if len(actors) != n:
        problems.append(f"{len(actors)} actors took blocks, not {n}")
    for pid, a in actors.items():
        if a["visible"] != "0":
            problems.append(f"actor {pid} sees CUDA_VISIBLE_DEVICES="
                            f"{a['visible']!r}")
        if a["prefills"] != a["rows"] or a["flash"] != n_layer * a["prefills"]:
            problems.append(f"actor {pid}: {a['flash']} flash launches for "
                            f"{a['prefills']} prefills of {a['rows']} rows")
        if a["decode"] != n_layer * a["decode_steps"] or not a["decode"]:
            problems.append(f"actor {pid}: {a['decode']} decode launches for "
                            f"{a['decode_steps']} eager steps")
        a["prefill_ms"] = 1e3 * a["prefill_s"] / max(a["prefills"], 1)
        a["decode_step_ms"] = 1e3 * a["decode_s"] / max(a["decode_steps"], 1)
    if problems:
        raise AssertionError(f"10b n={n}: " + "; ".join(problems))
    tokens = sum(len(ids) for b in blocks for ids in b["ids"])
    span = max(b["t1"] for b in blocks) - min(b["t0"] for b in blocks)
    block_s = sorted(b["t1"] - b["t0"] for b in blocks)
    return {"n": n, "blocks": blocks, "actors": actors, "wall_s": wall,
            "lease_wait_s": waited, "tokens": tokens,
            "tokens_per_s": tokens / wall,
            # From the first block's start in an actor to the last's end:
            # the pool's start and the engines' weights left out.
            "tokens_per_s_blocks": tokens / span,
            "block_s": {"p50": float(np.median(block_s)),
                        "max": block_s[-1]},
            "launches": {"flash_fwd": sum(a["flash"] for a in actors.values()),
                         "decode_attention": sum(
                             a["decode"] for a in actors.values())}}


def local_block_ids(ecfg, blocks, device):
    """Each block's ids from a local ``TorchLLMEngine`` given the same rows
    in the same order."""
    engine = TorchLLMEngine(ecfg, device=device)
    sp = SamplingParams(max_tokens=DATA_TOKENS, temperature=0.0)
    out = {tuple(b["rows"]): [o["token_ids"] for o in engine.generate(
        b["prompts"], sp)] for b in blocks}
    del engine
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out


def _bench_record(row: dict) -> dict:
    """A ``bench_llm`` row as ``bench.py``'s ``run_llm_suite`` re-emits it
    (its metric, value and unit first)."""
    row = dict(row)
    metric, value = row.pop("metric"), row.pop("value")
    unit = ("x" if metric.endswith("_speedup")
            else "req/s" if metric.endswith("_per_s")
            else "s" if metric.endswith("_s") else "count")
    return {"metric": metric, "value": round(float(value), 4), "unit": unit,
            **row}


def data_phase(device="cuda", cfg=None, parity_cfg=None,
               init_kwargs=None) -> dict:
    """Phase 10: the Data layer and batch inference at TinyLlama-1.1B's
    width (bf16, phase 9's seeded weights made by each engine) under a
    fresh ``ray_tpu_torch.init(num_cpus=4)``: (a) the shipped processor
    over a parquet file; (b) the counted stage at n=1 and n=2 actors, and
    its f32 token parity at 2 layers; (c) ``bench_llm``'s quick stages.
    Every process it starts is stopped before it returns."""
    import ray_tpu_torch as rt
    import ray_tpu_torch.data as rd

    os.environ["PYTHONPATH"] = os.pathsep.join(
        p for p in (HERE, os.environ.get("PYTHONPATH")) if p)
    cfg = cfg or LlamaConfig.tinyllama_1b()
    parity_cfg = parity_cfg or LlamaConfig.tinyllama_1b(n_layer=2,
                                                        dtype="float32")
    ecfg = EngineConfig(model=cfg, max_batch_size=8, max_seq_len=2048,
                        seed=SERVE_SEED)
    prompts = make_prompts(*DATA_PROMPTS)
    counted = prompts[:DATA_COUNTED]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_data_")
    rt.init(num_cpus=4, **(init_kwargs or {}))
    try:
        if rt.cluster_resources().get("GPU") != 1.0:
            raise AssertionError(f"detected {rt.cluster_resources()}")
        rep = {"shipped": shipped_processor(rd, ecfg, prompts, device, tmp)}
        runs = {n: counted_run(rt, rd, ecfg, counted, n, device)
                for n in (1, 2)}
        # f32 at 2 layers: every block's ids equal a local engine's.
        ecfg32 = dataclasses.replace(ecfg, model=parity_cfg)
        run32 = counted_run(rt, rd, ecfg32, counted, 2, device)
        want32 = local_block_ids(ecfg32, run32["blocks"], device)
        bad = [b["rows"] for b in run32["blocks"]
               if b["ids"] != want32[tuple(b["rows"])]]
        if bad:
            raise AssertionError(f"10b f32 parity: blocks {bad} differ from "
                                 f"a local engine's ids")
        # bf16 at full width: the share of blocks that agree, no gate
        # (bf16 is held launch by launch, tokens in f32).
        want = local_block_ids(ecfg, runs[1]["blocks"], device)
        agree = {n: sum(b["ids"] == want[tuple(b["rows"])]
                        for b in r["blocks"]) / len(r["blocks"])
                 for n, r in runs.items()}
        rep["counted"] = {f"n={n}": {k: v for k, v in r.items()
                                     if k != "blocks"}
                          | {"bf16_blocks_agree": agree[n]}
                          for n, r in runs.items()}
        rep["f32_parity"] = {"blocks": len(run32["blocks"]),
                             "tokens": run32["tokens"],
                             "launches": run32["launches"]}
        # (c) the load bench's quick stages, their in-bench asserts active.
        wait_card_free(rt)
        rows = bench_llm.bench_load(quick=True, device=device)
        rows += bench_llm.bench_disagg_ab(quick=True, device=device)
        wait_card_free(rt)
        rows += bench_llm.bench_interference(quick=True, device=device)
        rep["bench"] = [_bench_record(r) for r in rows]
    finally:
        rt.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    return rep


def report_data_phase(card: str, dp: dict) -> None:
    """Phase 10's readings: one line of numbers, the bench rows, then the
    whole report as JSON."""
    sh, c1, c2 = dp["shipped"], dp["counted"]["n=1"], dp["counted"]["n=2"]

    def by_actor(run, key):
        return [round(a[key], 3) for a in run["actors"].values()]

    print(f"data on {card}: 10a shipped processor {sh['rows']} rows in "
          f"{sh['wall_s']:.2f} s ({sh['rows_per_s']:.2f} rows/s), first "
          f"block after {sh['first_block_s']:.2f} s (actors' start and "
          f"weights included); 10b output tokens/s n=1 "
          f"{c1['tokens_per_s']:.1f} ({c1['tokens_per_s_blocks']:.1f} over "
          f"the blocks), n=2 {c2['tokens_per_s']:.1f} "
          f"({c2['tokens_per_s_blocks']:.1f}); block s p50/max n=1 "
          f"{c1['block_s']['p50']:.3f}/{c1['block_s']['max']:.3f}, n=2 "
          f"{c2['block_s']['p50']:.3f}/{c2['block_s']['max']:.3f}; prefill "
          f"ms by actor n=1 {by_actor(c1, 'prefill_ms')}, n=2 "
          f"{by_actor(c2, 'prefill_ms')}; decode step ms n=1 "
          f"{by_actor(c1, 'decode_step_ms')}, n=2 "
          f"{by_actor(c2, 'decode_step_ms')}; bf16 blocks agreeing with a "
          f"local engine n=1 {c1['bf16_blocks_agree']:.3f}, n=2 "
          f"{c2['bf16_blocks_agree']:.3f}; f32 2-layer ids equal a local "
          f"engine's in all {dp['f32_parity']['blocks']} blocks", flush=True)
    for row in dp["bench"]:
        print("bench " + json.dumps(row), flush=True)
    print("data " + json.dumps({k: v for k, v in dp.items()
                                if k != "bench"}), flush=True)


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
        fn = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1] if "'" in line else line.strip()
            if "Used" in line or "spill" in line or "Potential" in line:
                print(f"  {name}: {fn}: {line.strip()}", flush=True)
    # The bf16 flash forward, dQ and dK/dV run on the tensor cores (HGMMA)
    # with TMA-fed tiles (UTMALDG): both must be in each kernel's own SASS.
    sass = {name: check_sass(name) for name in TENSOR_CORE_KERNELS}
    print(f"sass {json.dumps(sass)}", flush=True)

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
    # The split kernel's edges (256-row splits): live lengths of 0, 1, one
    # split exactly, one split and a row, and rows of very different lengths.
    split_pos = [0, 1, 255, 256, 257, 511, 1279, 2047]
    check_decode(gen, TINYLLAMA_DECODE, 2048, split_pos)
    check_decode(gen, TINYLLAMA_DECODE, 2048, split_pos, **f32)
    check_decode(gen, GPT2_DECODE, 1000, [0, 1, 255, 256, 257, 767, 768, 999])
    # The other buckets phase 7 replays (B = 1, 2, 4) at TinyLlama's width,
    # on every other ragged and split-edge position of the lists above.
    dec_buckets = {}
    for b in (1, 2, 4):
        every = 8 // b
        shape = TINYLLAMA_DECODE[:1] + (b,) + TINYLLAMA_DECODE[2:]
        for pos_b in sorted({tuple(p[k::every]) for p in (llama_pos, split_pos)
                             for k in (0, every - 1)}):
            for kw in ({}, f32):
                rec = check_decode(gen, shape, 2048, list(pos_b), **kw)
                dec_buckets[f"B={b} pos={list(pos_b)} "
                            f"{str(kw.get('dtype', torch.bfloat16))[6:]}"] = \
                    max(r["max_abs_err"] for r in rec.values())
    flash_runs = [check_flash(gen, 2048, True, timed=True),
                  check_flash(gen, 1000, True, timed=True),
                  check_flash(gen, 512, False, timed=True),
                  check_flash(gen, 1000, True, h=12, timed=True)]
    check_flash(gen, 1000, True, **f32)
    check_flash(gen, 512, False, **f32)
    check_flash(gen, 1000, True, h=12, **f32)
    # The kernels' other head dim, D=128, in bf16 (no model of the repo
    # serves it yet).
    flash_d128 = [check_flash(gen, 1000, True, d=128),
                  check_flash(gen, 512, False, d=128)]
    # The forward at GPT-2 small's training shape, for the step's budget.
    flash_train = check_flash(gen, 1024, True, h=12, b=32, timed=True)
    # The backward kernels: GPT-2 small's training shape (timed), TinyLlama's
    # width, S=1000 (no multiple of 64) and non-causal S=512.
    bwd_runs = []
    for dtype in (torch.bfloat16, torch.float32):
        bwd_runs += [
            check_flash_bwd(gen, 32, 12, 1024, True, dtype,
                            timed=dtype == torch.bfloat16),
            check_flash_bwd(gen, 1, 32, 2048, True, dtype),
            check_flash_bwd(gen, 1, 32, 1000, True, dtype),
            check_flash_bwd(gen, 1, 32, 512, False, dtype)]
    bwd_runs += [check_flash_bwd(gen, 1, 32, 1000, True, d=128),
                 check_flash_bwd(gen, 1, 32, 512, False, d=128)]
    bwd_train = bwd_runs[0]
    print("phase2 " + json.dumps({"decode": dec, "decode_gpt2": dec_gpt2,
                                  "decode_buckets": dec_buckets,
                                  "flash": flash_runs,
                                  "flash_train_shape": flash_train,
                                  "flash_d128": flash_d128,
                                  "flash_bwd": bwd_runs}), flush=True)

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

    # Phase 5: training at full width (this slice's path).
    train_rep = train(GPT2Config.small(dtype="bfloat16", attention="flash",
                                       remat=True), 32, 1024, 3, 10)
    print("train gpt2_small " + json.dumps(train_rep), flush=True)
    train_launches = train_rep["launches"]

    # Phase 6: training parity, kernels vs plain versions, both families.
    for dtype in ("float32", "bfloat16"):
        for cfg, batch, seq in (
                (LlamaConfig.tinyllama_1b(n_layer=2, dtype=dtype,
                                          attention="flash"), 2, 2048),
                (dataclasses.replace(
                    GPT2Config.small(dtype=dtype, attention="flash",
                                     remat=True), n_layer=2), 4, 1024)):
            rep = train_parity(cfg, batch, seq)
            what = f"train parity {type(cfg).__name__} {dtype}"
            held = ("loss and every leaf within 1e-4" if dtype == "float32"
                    else "each launch within its bf16 tolerance")
            print(f"{what} (2 layers, B={batch} x S={seq}): {held}; "
                  + json.dumps(rep), flush=True)

    # Phase 7: continuous batching at full width, then f32 token parity.
    cb = cb_serve(make_prompts(16, 100, 1500, SEED + 12), 64, 0.05, 4)
    prof = cb["profile"]
    print(f"cb tinyllama_1b on {card}: {cb['tokens_per_s']:.1f} tokens/s "
          f"(under the kernel trace); "
          f"mean decode step ms by bucket "
          f"{ {b: p['mean_step_ms'] for b, p in cb['decode_by_bucket'].items()} }"
          f"; bucket 8 step {prof['graph_step_ms']:.3f} ms as a graph replay "
          f"against {prof['eager_step_ms']:.3f} ms eager; busy share "
          f"{prof['device_busy_share']:.3f} of {prof['wall_ms_per_step']:.3f} "
          f"ms a full-bucket step", flush=True)
    print("cb tinyllama_1b " + json.dumps(cb), flush=True)
    for cfg in (LlamaConfig.tinyllama_1b(n_layer=2, dtype="float32"),
                dataclasses.replace(GPT2Config.small(dtype="float32"),
                                    n_layer=2)):
        rep = cb_parity(cfg)
        print(f"cb parity {type(cfg).__name__} float32 (2 layers): every "
              f"result equals its solo run; " + json.dumps(rep), flush=True)

    # Phase 8: the runtime on the card, the serving path in a leased actor.
    rt_rep = runtime_phase("cuda", GPT2Config.small(),
                           make_prompts(4, 50, 400, SEED + 30), 32)
    kv = rt_rep["kv_handoff"]
    print(f"runtime on {card}: task round trip "
          f"{rt_rep['task_round_trip_ms']:.3f} ms (mean of 1000), actor call "
          f"{rt_rep['actor_call_ms']:.3f} ms, put/get of 64 MiB "
          f"{rt_rep['put_get']['put_gb_per_s']:.2f}/"
          f"{rt_rep['put_get']['get_gb_per_s']:.2f} GB/s, device_fetch of "
          f"{kv['bytes']} B {kv['device_fetch_ms']:.2f} ms "
          f"({kv['device_fetch_gb_per_s']:.2f} GB/s), worker cold start "
          f"{rt_rep['worker_cold_start_s']:.2f} s", flush=True)
    print("runtime " + json.dumps(rt_rep), flush=True)
    actor_launches = rt_rep["actor_engine"]["launches"]

    # Phase 9: the Serve layer and the OpenAI apps, each engine in its own
    # GPU-leased process.
    sv = serve_phase(cb["solo_tokens"], 64, 4)
    oa, ar, da = sv["openai_app"], sv["actor_route"], sv["disagg_app"]
    handoff, steps = ar["kv_handoff"], da["decode_by_bucket"]
    print(f"serve on {card}: 9a openai app "
          f"{oa['requests_per_s']:.2f} requests/s, latency p50 "
          f"{oa['latency_s']['p50']:.3f} s, max {oa['latency_s']['max']:.3f}"
          f" s; 9b actor route {ar['tokens_per_s']:.1f} tokens/s untraced "
          f"(phase 7 in one process: {cb['untraced']['tokens_per_s']:.1f} "
          f"untraced, {cb['tokens_per_s']:.1f} traced), "
          f"TTFT p50 {ar['ttft_s']['p50']:.3f} s, p99 "
          f"{ar['ttft_s']['p99']:.3f} s, prefill "
          f"{np.median(ar['prefill_ms']):.1f} ms median (phase 7 untraced: "
          f"{np.median(cb['untraced']['prefill_ms']):.1f}), KV handoff "
          f"{np.median(handoff['ms']):.1f} ms median at "
          f"{np.median(handoff['gb_per_s']):.2f} GB/s for "
          f"{int(np.median(handoff['bytes']))} B median (alone: "
          f"{ar['solo_kv_handoff']['ms']:.1f} ms for "
          f"{ar['solo_kv_handoff']['bytes']} B); 9b app over HTTP "
          f"{da['tokens_per_s']:.1f} tokens/s, request p50 "
          f"{da['request_s']['p50']:.3f} s, decode step ms by bucket "
          f"{ {b: p['mean_step_ms'] for b, p in steps.items()} }",
          flush=True)

    # Phase 10: the Data layer and batch inference, each engine in a
    # GPU-leased data actor.
    dp = data_phase()
    report_data_phase(card, dp)
    c1, c2 = dp["counted"]["n=1"], dp["counted"]["n=2"]

    flash_main = flash_runs[1]  # S=1000: a prompt length the path serves
    # "design" is the bf16 route each kernel runs on the main path: tensor
    # cores fed by TMA, or f32 FMAs (f32 runs FMAs everywhere).
    kernels = [
        {"name": "decode_attention", "route": "cuda",
         "source": "ray_tpu_torch/csrc/decode_attention.cu",
         "replaces": "ray_tpu/ops/decode_attention.py:95", "design": "split-t",
         "launches": main_launches["decode_attention"],
         # Phase 7: counted by name in the burst's kernel trace.
         "launches_cb": cb["launches"]["decode_attention_traced"],
         # Phase 8: in the GPU-leased engine actor.
         "launches_runtime_actor": actor_launches["decode_attention"],
         # Phase 9: eager steps in the OpenAI app's replica; graph replays
         # in the decode actor of the actor route and of the disagg app
         # (launches per capture times steps), and the actor route's
         # request alone, counted by name in a trace of the decode actor.
         "launches_serve_app": oa["launches"]["decode_attention"],
         "launches_disagg_actor": ar["launches"]["decode_attention_graph"],
         "launches_disagg_actor_traced_solo":
             ar["launches"]["decode_attention_traced_solo"],
         "launches_disagg_app": da["launches"]["decode_attention_graph"],
         # Phase 10: eager steps in 10b's data actors, one and two.
         "launches_data_n1": c1["launches"]["decode_attention"],
         "launches_data_n2": c2["launches"]["decode_attention"],
         "max_abs_err": dec["self"]["max_abs_err"],
         "ms": dec["self"]["ms"], "event_ms": dec["self"]["event_ms"],
         "plain_ms": dec["self"]["plain_ms"],
         "bound_ms": dec["self"]["bound_ms"], "bound_by": "bytes",
         "library_ms": dec["library_ms"],
         "gpt2_shape": {k: dec_gpt2["self"][k] for k in (
             "ms", "event_ms", "plain_ms", "bound_ms", "max_abs_err")}
         | {"library_ms": dec_gpt2["library_ms"]}},
        {"name": "flash_fwd", "route": "cuda",
         "source": "ray_tpu_torch/csrc/flash_fwd.cu",
         "replaces": "ray_tpu/ops/attention.py:55", "design": "wgmma+tma",
         "launches": main_launches["flash_fwd"],
         "launches_train_gpt2_small": train_launches["flash_fwd"],
         "launches_cb": cb["launches"]["flash_fwd"],
         "launches_runtime_actor": actor_launches["flash_fwd"],
         # Phase 9: the OpenAI app's replica, and the prefill actor.
         "launches_serve_app": oa["launches"]["flash_fwd"],
         "launches_disagg_actor": ar["launches"]["flash_fwd_prefill_actor"],
         # Phase 10: the prompts 10b's data actors prefilled.
         "launches_data_n1": c1["launches"]["flash_fwd"],
         "launches_data_n2": c2["launches"]["flash_fwd"],
         "max_abs_err": flash_main["max_abs_err"],
         "ms": flash_main["ms"], "plain_ms": flash_main["plain_ms"],
         "bound_ms": flash_main["bound_ms"],
         "bound_by": flash_main["bound_by"],
         "library_ms": flash_main["library_ms"],
         "event_ms": flash_main["event_ms"],
         "train_shape": {k: flash_train[k] for k in (
             "ms", "event_ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms", "max_abs_err")}},
    ]
    for name, key, line, design in (("flash_dq", "dq", 144, "wgmma+tma"),
                                    ("flash_dkv", "dkv", 191, "wgmma+tma")):
        rec = bwd_train[key]
        errs = [bwd_train["max_abs_err"][g]
                for g in (("dq",) if key == "dq" else ("dk", "dv"))]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "ray_tpu_torch/csrc/flash_bwd.cu",
            "replaces": f"ray_tpu/ops/attention.py:{line}", "design": design,
            "launches": train_launches[name],
            "max_abs_err": max(errs),
            "ms": rec["ms"], "event_ms": rec["event_ms"],
            "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": bwd_train["library_ms"],
            "library": f"one SDPA backward (dq, dk, dv): "
                       f"{bwd_train['library_backend']}"})
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

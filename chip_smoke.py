#!/usr/bin/env python3
"""Drive ray_tpu_torch's serving and training paths, its runtime, its Data
layer, its collective layer and Train, its DAGs, Tune and jobs, its
pipeline-parallel trainer, its autoscaler, its parallel layer (ring and
Ulysses attention, the sharded train step), its vision and MoE models,
RLlib (the learners, Anakin and Sebulba, DreamerV3) and its chaos
injectors on one NVIDIA GPU and check them.

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
     and non-causal S=512, the forward and backward at D=128 (S=1000
     causal, S=512 not), and both at ViT-B/16's attention (B=32 x S=197,
     no multiple of the 64-row tile, H=12, not causal, timed in bf16);
     bf16 at a tolerance of 2e-2 (relative to the
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
     under a fresh ``ray_tpu_torch.init(num_cpus=4)``: (a) 64 seeded
     prompts written to parquet, read back and run through
     ``build_llm_processor`` as shipped, two data actors leasing half the
     card each: 64 rows, each with its own prompt and a ``str``, and
     both actors under ``CUDA_VISIBLE_DEVICES="0"`` (wall time, rows/s,
     the first block's time); (b) 32 of them through a counting subclass
     of the stage in a pool of n=1, then n=2 actors leasing 1/n of the
     card: in every actor, 22 flash launches a prefilled prompt and 22
     decode launches an eager step; tokens/s, block latency, prefill and
     decode-step ms by actor; at f32 and 2 layers every block's ids equal
     a local engine's, and at bf16 the share that does is printed;
     (c) ``bench_llm``'s quick stages on the card, their asserts active,
     their rows printed as ``bench.py`` re-emits them.
 11. the collective layer and Train, under a fresh
     ``ray_tpu_torch.init(num_cpus=4)``: (a) a 4-rank ``LocalGroup`` on the
     card (two slices of 2): every op, every algorithm candidate pinned,
     f32 and bf16 at 4 KiB, 1 MiB and 64 MiB a rank, held against plain
     arithmetic on the card (integer-valued payloads exactly, floats at
     1e-5 / 2e-2 relative, q8 within its bound), each op's GB/s at 64 MiB;
     a ``DistGroup`` over NCCL at world 1 in a whole-card actor (every op
     on 64 MiB returns what world 1 must), two NCCL ranks on one card
     refused; a gloo ``DistGroup`` of two half-card actors: every op on
     CUDA tensors of 1, 8 and 64 MiB against numpy here (results stay on
     ``cuda:0``; GB/s printed), an integer-valued allreduce and a q8 one
     through the tuner (a committed decision), a ``DeviceRef`` fetched
     through the group, the flight recorder's records (algorithm, q8 wire
     bytes) and the collective re-probe; (b) a ``TorchTrainer`` worker
     leasing the card (NCCL, world 1) trains phase 5's GPT-2 small (bf16,
     flash, remat, AdamW, B=32 x S=1024 from a dataset shard through
     ``iter_batches``; 3 warm-up and 5 timed steps, reported each step, a
     ``torch_ckpt`` checkpoint after step 5): 24/12/12 flash launches every
     step in the worker, ``CUDA_VISIBLE_DEVICES="0"``, falling loss, the
     result's checkpoint restored bit for bit on the card; step ms and
     tokens/s beside phase 5's and their ratio, save ms; (c) the same loop
     at 2 layers and f32 hard-exits once at step 4, right after its
     checkpoint at step 3, and resumes on the card: losses from step 4 on
     equal, at 1e-5, those of the same steps run uninterrupted in this
     process on the card; (d) two workers leasing half
     the card each (gloo over CUDA tensors), each on half of a seeded
     batch, gradients MEAN-allreduced through a collective group of the
     loop (2 layers, f32, SGD, 5 steps): both ranks' parameters equal,
     and equal, at 1e-4, those of the same SGD steps on the whole batch in
     this process, every rank's flash launches counted.
 12. compiled DAGs, Tune, a job, the CLI and the dashboard, under a fresh
     ``ray_tpu_torch.init(num_cpus=8)``: (a) GPT-2 small (bf16, flash) cut
     at layer 6 over two half-card actors, ``InputNode`` -> stage A ->
     stage B compiled; B=4 x S=1024 ids, the 6.3 MB residual stream on
     the edge: the greedy ids equal one ``gpt2_apply`` here and the same
     stages through ``.remote()``, 6 flash launches a stage a call; at
     f32 and 2 layers the logits within 1e-4; ms per execute against the
     ``.remote()`` chain at that payload and at one element (20 calls
     after 5), the edge's host-copy share; an in-graph allreduce of two
     half-card actors' CUDA tensors (f32 and bf16, 1 and 64 MiB) by the
     host path and through a gloo ``DistGroup``: the sum in participant
     order, exact at f32, 2e-2 at bf16, GB/s; (b) a ``Tuner`` over AdamW's
     lr (two trials at once), each trial a ``TorchTrainer`` worker on half
     the card training GPT-2 small (bf16, flash, remat, B=8 x S=1024, 6
     steps): each trial's losses equal those of its steps run here at
     1e-5, 24/12/12 launches a step, the best trial the one with the
     lower last loss;
     (c) ``python -m ray_tpu_torch job submit`` of an entrypoint that
     joins with ``address="auto"`` and serves GPT-2 small from one
     ``num_gpus=1`` task (4 prompts, 16 greedy tokens): ``SUCCEEDED``, the
     ids in ``job logs`` equal the same engine's here, flash and decode
     launches in the task, ``status`` and ``list nodes`` name the GPU, and
     a dashboard started here answers with it.
 13. the pipeline-parallel trainer and the autoscaler: (a) under a fresh
     ``ray_tpu_torch.init(num_cpus=4)``, GPT-2 small (bf16, flash) cut by
     ``gpt2_stage_modules`` into two 6-layer stages, each an actor leasing
     half the card, trained 5 steps of non-interleaved 1F1B by
     ``PipelinedTrainer.fit`` on seeded B=8 x S=1024 batches in 4
     microbatches: every step's loss within 2e-3 of ``reference_run`` of
     the same chunks here on the card, the first within 2e-2 of the plain
     path's (dense attention), 240/120/120 flash forward/dQ/dK-dV launches
     in each stage process (6 layers x 4 microbatches x forward and
     recompute x 5 steps), at most 2 inputs held on stage 0; the step time
     (median and min of steps 2-5), tokens/s, the bubble against
     ``theoretical_bubble_fraction(2, 4)``, each edge's host copies and
     each stage's peak memory; (b) under another ``init`` whose head
     registers no card, an ``Autoscaler`` over ``FakeMultiNodeProvider``
     with one node type ``{"CPU": 2, "GPU": 1}`` (min 0, max 1) launches
     a node for a ``num_gpus=1`` task, which runs the flash forward and
     decode there against their plain versions; the cluster's GPU total is
     1 while the node is up and 0 after it is drained away; the seconds to
     launch, to the result and to scale down.
 14. ``parallel/`` on the card: (a) ring and Ulysses attention over a
     ``LocalGroup`` of 4 ranks, all on ``cuda:0``, at GPT-2 small's
     attention (B=4, global S=4096, H=12, D=64, bf16, causal), forward and
     backward: the ring's kernel route (the flash forward on each block,
     merged by lse; a second ring of the dQ and dK/dV kernels) and
     Ulysses with the flash kernels as its attention, each held against
     the flash kernels over the whole sequence (out, dQ, dK and dV element
     by element at 2e-2 absolute and relative, and each gradient within
     2e-2 by norm in each rank's sequence block), the ring also against
     the plain ring on the same inputs; 10/10/10 and 4/4/4 launches a
     call; ms a forward and backward beside the whole-sequence kernels';
     (b) GPT-2 small (bf16, ``attention="ring"``) placed by
     ``shard_pytree`` with ``gpt2_param_axes()`` on a world-of-one NCCL
     ``DeviceMesh``, trained 2 + 5 steps of ``gpt2_loss(..., mesh=mesh)``
     and AdamW at B=32 x S=1024, beside the unsharded flash step on the
     same weights and tokens: the first step's gradient of every leaf
     within 2e-2 by norm, losses within 2e-3 every step, 12/12/12
     launches a step, ms a step and tokens/s of both and phase 5's.
     ``tools/parallel_cards.py`` runs 14a and 14b as a world of one
     process a card.
 15. the vision models and the MoE LM: (a) under a fresh
     ``ray_tpu_torch.init(num_cpus=4)``, one Serve replica leasing the
     card runs ``vit_apply`` over each ``@serve.batch`` (at most 32
     images, 10 ms wait): first ViT-B/16's width at 2 layers in f32, 64
     requests, every logit row within 1e-4 of ``vit_apply`` here; then
     ViT-B/16 (224², patch 16, 12 layers, bf16, flash attention, seeded
     weights), 256 seeded images one a request from 16 client threads:
     every answer a class of 1000, a batch above 1, 12 flash launches a
     batch and no call of the plain attention in the replica; images/s,
     request latency, batch sizes, the replica's start (deploy to first
     answer) and the share of top-1 classes equal to ``vit_apply`` here;
     (b) ResNet-50 (bf16, f32 batch-norm statistics) in one
     ``TorchTrainer`` worker leasing the card (NCCL, world 1): B=128
     seeded 224² images, SGD with momentum 0.9, 3 warm-up and 10 timed
     steps: the loss finite and falling, every running statistic moved
     in train mode and left as it was in eval mode; images/s, step ms,
     peak memory, and the step's bound (FLOPs reckoned from the shapes
     at 989 TFLOP/s); (c) the MoE LM (12 layers, d_model 768, 8 experts,
     top-2, bf16, flash attention) trained by phase 5's harness at B=8 x
     S=1024, AdamW, 2 warm-up and 5 timed steps: the loss finite and
     falling, 12/12/12 launches a step, the aux loss above 0; tokens/s
     and peak memory; then phase 6's parity at 2 layers (f32 loss and
     every leaf at 1e-4, bf16 launch by launch).
 16. RLlib, whose networks are small MLPs (no kernel of the four is on
     its path): (a) ``CartPoleTorch`` and ``PendulumTorch`` step 1,000
     seeded states, step counts and actions on the card at once (across
     CartPole's thresholds, 1 in 10 on its last step), against the numpy
     envs: obs within 1e-5 where not done, a fresh episode where done,
     CartPole's rewards and every done equal, Pendulum's rewards within
     1e-5 (f32 against f64);
     (b) card against CPU from the same params and inputs, each within
     1e-5 relative: the batched v-trace loss, aux and every gradient leaf
     at E=64 x T=16 with and without the APPO clip,
     ``TorchLearner.update_minibatches`` on one 2 x 256-step batch, one
     SAC update with its noise passed in; (c) Anakin at bench_rl's sizes
     (64 envs, unroll 16, 20 updates a step) on the card, 1 warm-up and
     3 timed ``training_step``s (env-steps/s, ms a step), one profiled
     update (device ms, kernels, busy share) and one profiled
     ``training_step`` with at most 2 device-to-host copies; then
     ``test_anakin_learns_cartpole``'s configuration on one replica must
     beat its seeded threshold within 6 steps; then, under a fresh
     ``ray_tpu_torch.init(num_cpus=4)``: (d) ``bench_rl``'s Anakin
     against the host-loop IMPALA (2 CPU runners, rollout 128, 4 batches,
     learner on the card), ratio above 1.0; (e) Sebulba at bench_rl's
     sizes (2 runners x 4 envs, 64 steps, 8 batches a step), each
     runner's forward on a quarter-card lease (``cuda``, printed with its
     ``CUDA_VISIBLE_DEVICES``), the learner on the card: learner steps/s,
     staleness, broadcast bytes, each runner's start; (f) PPO with 2 CPU
     runners x 256 steps, 3 iterations: finite losses, every learner
     tensor on ``cuda``, ms an ``update_minibatches`` and s an iteration.
 17. DreamerV3 and the chaos injectors: (a) DreamerV3 at ``_Hyper``'s
     defaults (deter 64, 8 x 8 latents, hidden 64, B=8 x T=16, horizon 8)
     from the same params, batch and noise on the card and on the CPU,
     CartPole and Pendulum: the world-model loss, its metrics and every
     gradient leaf, the actor-critic loss and every gradient leaf, and
     one whole ``train_once`` (clip and Adam) within 1e-5 of the CPU's,
     relative to each leaf's largest magnitude, in f64 every number and
     in f32 all but the parameters after Adam (printed); then, under a
     fresh ``ray_tpu_torch.init(num_cpus=4)``,
     ``test_dreamer_world_model_learns_cartpole``'s configuration with
     its learner on the card for 6 ``train()`` calls (1 CPU runner x 128
     steps, min_buffer 256, train_ratio 4, B=8 x T=12): the world-model
     loss finite and falling, ``imag_return`` finite, every learner
     tensor on ``cuda``; ms a ``train_once`` (median of 10), one profiled
     update (kernels, device ms, busy share, exactly one device-to-host
     copy: the return spread's EMA), s a ``train()``; (b) phase 13a's
     ``PipelinedTrainer`` (two 6-layer GPT-2 small stages, each leasing
     half the card, 1F1B, B=8 x S=1024 in 4 microbatches, a checkpoint
     every 2 steps, ``max_failures=1``, 5 steps) with stage 1 killed by
     ``devtools.chaos.KilledStageActor`` once 3 steps completed: the
     trainer restores and respawns it by itself (one restart), the new
     stage process under ``CUDA_VISIBLE_DEVICES="0"`` with 48/24/24 flash
     launches a step it ran, and every step's loss, the re-run ones
     included, within 2e-3 of 13a's sequential run; the seconds from the
     kill to the next completed step and from the respawn request to the
     new stage's constructor.

Prints the kernels' JSON line on the line before the last, and as the last
line {"ok": true, "device": {...}}.  Exits non-zero with no result when no
GPU is present.
"""

from __future__ import annotations

import concurrent.futures
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
import types

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
from ray_tpu_torch.serve.batching import batch as serve_batch  # noqa: E402
from ray_tpu_torch.ops.decode_attention import (  # noqa: E402
    decode_attention,
    reference_decode_attention,
    reference_decode_attention_split,
)
from ray_tpu_torch.train import pipeline as train_pipeline  # noqa: E402

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
          lr: float = 1e-4, fam=None):
    """Train ``cfg`` on one seeded batch (the shape and step of
    ``bench.py:bench_gpt2_train``): ``warmup`` steps, then ``steps`` timed
    ones, then one profiled step.  Asserts finite, falling loss and the
    launch counts of every step.  ``fam`` (``init``, ``loss``) stands in
    for the registered family of a model that has none (the MoE LM)."""
    fam = fam or model_family(cfg)
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


def train_parity(cfg, batch: int, seq: int, fam=None):
    """Loss and every gradient leaf of one batch, through the kernels
    (each launch also held against its plain version on its own inputs)
    and through the plain versions.  ``fam`` as in ``train``."""
    fam = fam or model_family(cfg)
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
# slots); the counted runs take the first 32 of them.  Half the depth
# this phase first ran at (128 and 64), to keep the script, phase 11
# included, near half its time limit.
DATA_PROMPTS = (64, 100, 1500, SEED + 50)
DATA_BLOCKS = 8
DATA_COUNTED = 32
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


# ----------------------------------------------------------------- phase 11
# 11a: payload bytes per rank of the LocalGroup sweep and of the gloo pair.
LOCAL_SIZES = (4 << 10, 1 << 20, 64 << 20)
GLOO_SIZES = (1 << 20, 8 << 20, 64 << 20)
COLL_RANKS = 4
COLL_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
COLL_SEED = SEED + 60
# 11b: phase 5's model and batch, 3 + 5 steps; a checkpoint every 5 steps
# (one, after step 5).
TRAIN_CKPT_EVERY = 5
# 11c: 8 steps at 2 layers, f32, a checkpoint every 4; the first attempt
# hard-exits as step 4 starts, right after its checkpoint at step 3.
RESUME_STEPS, RESUME_FAIL_AT, RESUME_BATCH = 8, 4, 8
# 11d: 2 layers, f32, SGD, 5 steps on 8 sequences, halved between 2 ranks.
DP_STEPS, DP_BATCH, DP_LR = 5, 8, 0.1


@contextlib.contextmanager
def _pinned(group, algo: str):
    """``group``'s algorithm selection pinned to ``algo``."""
    group._select = lambda op, nbytes, quantized: algo
    try:
        yield
    finally:
        del group._select


def _q8_bound(stack, block: int, algo: str, ici: int):
    """Per-element bound of a q8 allreduce of ``stack`` [n, elems] (f32)
    against the exact sum: each rank's round-to-nearest error is at most
    amax/254 of its block (``algorithms.quantized_allreduce``); two-level
    quantizes each slice partial's reduce-scattered chunk instead."""
    n, elems = stack.shape

    def per_block(rows):
        pad = (-rows.shape[1]) % block
        blocks = F.pad(rows, (0, pad)).reshape(rows.shape[0], -1, block)
        bound = blocks.abs().amax(dim=2).sum(dim=0) / 254.0
        return bound.repeat_interleave(block)[:rows.shape[1]]

    if algo != "two_level_q8":
        return per_block(stack)
    partials = stack.reshape(n // ici, ici, elems).sum(dim=1)
    chunks = F.pad(partials, (0, (-elems) % ici)).reshape(n // ici, ici, -1)
    return torch.cat([per_block(chunks[:, c]) for c in range(ici)])[:elems]


def local_collectives(device, sizes=LOCAL_SIZES) -> dict:
    """11a: every op of a 4-rank ``LocalGroup`` on ``device`` (two slices of
    2), every algorithm candidate pinned, f32 and bf16, at each payload of
    ``sizes`` per rank, held against plain arithmetic on the same device:
    integer-valued payloads exactly, floats at 1e-5 (f32) and 2e-2 (bf16)
    relative, q8 within its bound.  Then each op's bytes/s at the largest
    f32 payload (``bench_collective.op_bandwidth``)."""
    from ray_tpu_torch.collective import LocalGroup
    from ray_tpu_torch.collective import algorithms as alg
    from ray_tpu_torch.collective.bench_collective import op_bandwidth
    from ray_tpu_torch.collective.types import ReduceOp

    n = COLL_RANKS
    g = LocalGroup("phase11-local", [device] * n, slice_size=2)
    gen = torch.Generator(device).manual_seed(COLL_SEED)
    problems, checks, worst = [], 0, {}

    def want(ok, what):
        nonlocal checks
        checks += 1
        if not ok:
            problems.append(what)

    def rel(outs, ref, what, tol):
        ref = ref.float()
        err = max(((o.float() - ref).abs() / ref.abs()).max().item()
                  for o in outs)
        worst[what] = max(worst.get(what, 0.0), err)
        want(err <= tol, f"{what}: relative error {err} > {tol}")

    def exact(outs, ref, what):
        want(all(o.dtype == ref.dtype and torch.equal(o, ref) for o in outs),
             what)

    for dtype in (torch.float32, torch.bfloat16):
        tol = COLL_TOL[dtype]
        name = str(dtype)[6:]
        for nbytes in sizes:
            elems = nbytes // dtype.itemsize
            at = f"{name} {nbytes} B"
            ints = [torch.randint(-8, 8, (elems,), generator=gen,
                                  device=device).to(dtype) for _ in range(n)]
            ones_twos = [torch.randint(1, 3, (elems,), generator=gen,
                                       device=device).to(dtype)
                         for _ in range(n)]
            floats = [(1 + torch.rand(elems, generator=gen, device=device)
                       ).to(dtype) for _ in range(n)]
            istack = torch.stack(ints).float()
            fstack = torch.stack(floats).double()
            isum = istack.sum(0).to(dtype)
            for algo in alg.allreduce_candidates(n, g.topology):
                with _pinned(g, algo):
                    exact(g.allreduce(ints), isum, f"allreduce {algo} {at}")
                    rel(g.allreduce(floats), fstack.sum(0),
                        f"allreduce {algo} {name}", tol)
            for algo in alg.allreduce_candidates(n, g.topology, True):
                with _pinned(g, algo):
                    outs = g.allreduce(floats, quantized=True)
                f32 = fstack.float()
                bound = _q8_bound(f32, g._quant_block(), algo, 2)
                ref = f32.sum(0)
                slack = ref.abs() * 2 ** -7 if dtype == torch.bfloat16 \
                    else 1e-5
                err = max(((o.float() - ref).abs() - bound - slack).max()
                          .item() for o in outs)
                want(err <= 0, f"allreduce {algo} {at}: past the q8 bound "
                     f"by {err}")
            for op, xs, ref in (
                    (ReduceOp.MAX, ints, istack.amax(0)),
                    (ReduceOp.MIN, ints, istack.amin(0)),
                    (ReduceOp.MEAN, ints, istack.sum(0) / n),
                    (ReduceOp.PRODUCT, ones_twos,
                     torch.stack(ones_twos).float().prod(0))):
                exact(g.allreduce(xs, op), ref.to(dtype),
                      f"allreduce {op.value} {at}")
                red = g.reducescatter(xs, op)
                part = elems // n
                want(all(torch.equal(o, ref.to(dtype)[r * part:(r + 1) * part])
                         for r, o in enumerate(red)),
                     f"reducescatter {op.value} {at}")
            for algo in ("flat", "ring"):
                with _pinned(g, algo):
                    got = g.allgather(floats)
                    red = g.reducescatter(ints)
                want(all(torch.equal(a, b) for r in got
                         for a, b in zip(r, floats)),
                     f"allgather {algo} {at}")
                part = elems // n
                want(all(torch.equal(o, isum[r * part:(r + 1) * part])
                         for r, o in enumerate(red)),
                     f"reducescatter sum {algo} {at}")
            want(all(torch.equal(o, floats[3]) for o in
                     g.broadcast(floats, src_rank=3)), f"broadcast {at}")
            chunks = [x.reshape(n, -1) for x in floats]
            want(all(torch.equal(o, torch.stack([c[i] for c in chunks]))
                     for i, o in enumerate(g.alltoall(chunks))),
                 f"alltoall {at}")
            want(all(torch.equal(o, floats[(i - 1) % n]) for i, o in
                     enumerate(g.sendrecv_ring(floats, shift=1))),
                 f"sendrecv_ring {at}")
            del ints, ones_twos, floats, istack, fstack, chunks
    g.barrier()
    if problems:
        raise AssertionError(f"11a LocalGroup: {problems}")
    big = sizes[-1] // 4
    xs = [torch.rand(big, generator=gen, device=device) for _ in range(n)]
    bw = op_bandwidth(g, xs)
    del xs
    if device != "cpu":
        torch.cuda.empty_cache()
    return {"ranks": n, "device": str(device), "checks": checks,
            "largest_rel_err": worst,
            "gb_per_s_at_largest_f32": {k: v / 1e9 for k, v in bw.items()}}


def _int_payload(seed: int, rank: int, elems: int):
    """Phase 11a's gloo payloads: integer-valued f32, from numpy (so the
    script makes the same ones)."""
    rng = np.random.default_rng(seed + rank)
    return rng.integers(-8, 8, elems).astype(np.float32)


def _gloo_expected(seed: int, elems: int) -> dict:
    """sha256 of each op's result by rank, from numpy in this process."""
    import hashlib

    x = [_int_payload(seed, r, elems) for r in range(2)]
    p = [np.abs(v) % 2 + 1 for v in x]
    half = elems // 2
    full = {"allreduce_sum": [x[0] + x[1]] * 2,
            "allreduce_max": [np.maximum(x[0], x[1])] * 2,
            "allreduce_min": [np.minimum(x[0], x[1])] * 2,
            "allreduce_mean": [(x[0] + x[1]) / 2] * 2,
            "allreduce_product": [p[0] * p[1]] * 2,
            "allgather": [np.stack(x)] * 2,
            "reducescatter": [(x[0] + x[1])[r * half:(r + 1) * half]
                              for r in range(2)],
            "broadcast": [x[1]] * 2,
            "alltoall": [np.stack([x[j].reshape(2, -1)[r] for j in range(2)])
                         for r in range(2)],
            "ppermute": [x[1], x[0]]}
    for algo in ("ring", "tree"):
        full[f"allreduce_sum_{algo}"] = full["allreduce_sum"]
    full["allgather_ring"] = full["allgather"]
    full["reducescatter_ring"] = full["reducescatter"]
    return {k: [hashlib.sha256(np.ascontiguousarray(v, np.float32).tobytes())
                .hexdigest() for v in vs] for k, vs in full.items()}


class _NcclMember:
    """11a: a DistGroup over NCCL in a worker that leases the whole card."""

    def world_one(self, nbytes: int) -> dict:
        import os

        import torch

        from ray_tpu_torch import collective as col
        from ray_tpu_torch.collective.types import ReduceOp

        g = col.init_collective_group(1, 0, backend="nccl",
                                      group_name="nccl-1")
        x = torch.randint(-8, 8, (nbytes // 4,), device="cuda").float()
        ok = {f"allreduce_{op.value}": torch.equal(g.allreduce(x, op), x)
              for op in ReduceOp}
        ok["allreduce_q8"] = torch.equal(g.allreduce(x, quantized=True), x)
        got = g.allgather(x)
        ok["allgather"] = len(got) == 1 and torch.equal(got[0], x)
        ok["reducescatter"] = torch.equal(g.reducescatter(x), x)
        ok["broadcast"] = torch.equal(g.broadcast(x, 0), x)
        ok["alltoall"] = torch.equal(g.alltoall(x.reshape(1, -1)),
                                     x.reshape(1, -1))
        ok["ppermute"] = torch.equal(g.ppermute(x), x)
        g.barrier()
        col.destroy_collective_group("nccl-1")
        return {"ok": ok, "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "device": str(x.device)}

    def refused(self, rank: int):
        """Two NCCL ranks on one card: the group must refuse, by name."""
        from ray_tpu_torch import collective as col

        try:
            col.init_collective_group(2, rank, backend="nccl",
                                      group_name="nccl-2")
        except ValueError as e:
            return str(e)
        return None


class _GlooMember:
    """11a: one of two gloo ranks, each leasing half the card."""

    def join(self, rank: int) -> str:
        import os

        from ray_tpu_torch import collective as col

        self.rank = rank
        self.group = col.init_collective_group(2, rank, backend="gloo",
                                               group_name="gloo-2")
        return os.environ.get("CUDA_VISIBLE_DEVICES")

    def ops(self, seed: int, sizes, device) -> dict:
        """Every op at each payload on ``device``'s tensors: each result's
        sha256, device and time (ms, the card synchronized)."""
        import hashlib
        import time

        import numpy as np
        import torch

        from ray_tpu_torch.collective.types import ReduceOp

        g, out = self.group, {}

        def sync():
            if device != "cpu":
                torch.cuda.synchronize()

        def timed(fn):
            sync()
            t0 = time.perf_counter()
            res = fn()
            sync()
            return res, (time.perf_counter() - t0) * 1e3

        for nbytes in sizes:
            elems = nbytes // 4
            xn = _int_payload(seed, self.rank, elems)
            x = torch.from_numpy(xn).to(device)
            p = torch.from_numpy(np.abs(xn) % 2 + 1).to(device)
            calls = {f"allreduce_{op.value}":
                     (lambda op=op: g.allreduce(
                         p if op == ReduceOp.PRODUCT else x, op), None)
                     for op in ReduceOp}
            calls.update({
                "allreduce_sum_ring": (lambda: g.allreduce(x), "ring"),
                "allreduce_sum_tree": (lambda: g.allreduce(x), "tree"),
                "allgather": (lambda: torch.stack(g.allgather(x)), "flat"),
                "allgather_ring": (lambda: torch.stack(g.allgather(x)),
                                   "ring"),
                "reducescatter": (lambda: g.reducescatter(x), "flat"),
                "reducescatter_ring": (lambda: g.reducescatter(x), "ring"),
                "broadcast": (lambda: g.broadcast(x, src_rank=1), None),
                "alltoall": (lambda: g.alltoall(x.reshape(2, -1)), None),
                "ppermute": (lambda: g.ppermute(x, shift=1), None),
            })
            calls["allreduce_sum"] = (lambda: g.allreduce(x), "flat")
            for name, (fn, algo) in calls.items():
                if algo:
                    g._select = lambda o, nb, q, a=algo: a
                fn()  # warm: the first call of a shape
                res, ms = timed(fn)
                if algo:
                    del g._select
                raw = res.contiguous().reshape(-1).view(torch.uint8)
                out[f"{name} {nbytes}"] = {
                    "sha256": hashlib.sha256(
                        raw.cpu().numpy().tobytes()).hexdigest(),
                    "device": str(res.device), "ms": ms}
        return out

    def tuned(self, nbytes: int, device) -> dict:
        """An integer-valued ring allreduce through the tuner (every
        candidate explored, then a synced commit) and a q8 allreduce."""
        import torch

        from ray_tpu_torch import collective as col

        col.reset_tuner()
        g = self.group
        x = torch.from_numpy(_int_payload(SEED, self.rank, nbytes // 4)
                             ).to(device)
        want = torch.from_numpy(_int_payload(SEED, 0, nbytes // 4)
                                + _int_payload(SEED, 1, nbytes // 4)
                                ).to(device)
        exact = [torch.equal(g.allreduce(x), want) for _ in range(10)]
        # Each rank's |x| + 1 is 1..9: its q8 error is at most 9/254.
        q = g.allreduce(x.abs() + 1, quantized=True)
        ref = x.abs() + 1 + (want - x).abs() + 1
        stats = col.collective_stats()
        return {"exact": exact,
                "q8_max_abs_err": (q - ref).abs().max().item(),
                "tuner": stats["tuner"], "staged": stats["staged"]}

    def recorder(self) -> dict:
        """The flight recorder's collective series in this process: the
        algorithms each op was recorded under, and the q8 bytes saved."""
        from ray_tpu_torch.util import metric_registry as reg
        from ray_tpu_torch.util import metrics

        algos, saved = set(), 0.0
        with metrics._lock:
            for (name, tags), ent in metrics._local.items():
                tags = dict(tags)
                if name == reg.COLLECTIVE_DURATION_HIST and "algo" in tags:
                    algos.add(f"{tags['op']}/{tags['algo']}")
                if name == reg.COLLECTIVE_QUANTIZED_BYTES_SAVED_TOTAL:
                    saved += ent["value"]
        return {"algos": sorted(algos), "q8_bytes_saved": saved}

    def put(self, seed: int, device):
        import torch

        from ray_tpu_torch.collective import device_object_store

        gen = torch.Generator(device).manual_seed(seed)
        t = torch.randn((1024, 1024), generator=gen, device=device)
        return device_object_store().put(t, group_name="gloo-2", rank=0)

    def serve(self, ref) -> str:
        from ray_tpu_torch.collective import device_object_store

        return _sha256(device_object_store().serve_fetch(ref))

    def fetch(self, ref) -> dict:
        from ray_tpu_torch.collective import device_object_store

        store = device_object_store()
        t = store.fetch(ref)
        return {"sha256": _sha256(t), "device": str(t.device),
                "path": store.last_transfer_path}

    def leave(self) -> None:
        from ray_tpu_torch import collective as col

        col.destroy_collective_group("gloo-2")


def dist_collectives(rt, device) -> dict:
    """11a's process groups: NCCL at world 1 in a whole-card actor (every
    op returns what world 1 must; two NCCL ranks on one card refused), and
    gloo at world 2 in two half-card actors (every op on CUDA tensors of
    ``GLOO_SIZES`` against numpy here, the tuner, the recorder, a
    ``DeviceRef`` fetched through the group, the collective re-probe).  A
    rehearsal on the CPU (``device="cpu"``) has no NCCL and skips it."""
    rep = nccl_collectives(rt) if device != "cpu" else {}
    rep["gloo_world_2"] = gloo_collectives(rt, device)
    return rep


def nccl_collectives(rt) -> dict:
    """11a's NCCL groups: world 1 in a whole-card actor, where every op on
    64 MiB must return what world 1 must, and two half-card ranks, which
    must be refused."""
    rep = {}
    wait_card_free(rt)
    member = rt.remote(num_gpus=1)(_NcclMember).remote()
    rep["nccl_world_1"] = rt.get(member.world_one.remote(64 << 20),
                                 timeout=600)
    rt.kill(member)
    bad = [k for k, ok in rep["nccl_world_1"]["ok"].items() if not ok]
    if bad or rep["nccl_world_1"]["visible"] != "0":
        raise AssertionError(f"11a NCCL world 1: {rep['nccl_world_1']}")
    wait_card_free(rt)
    pair = [rt.remote(num_gpus=0.5)(_NcclMember).remote() for _ in range(2)]
    refusals = rt.get([m.refused.remote(r) for r, m in enumerate(pair)],
                      timeout=600)
    for m in pair:
        rt.kill(m)
    if not all(r and "same card" in r for r in refusals):
        raise AssertionError(f"11a: two NCCL ranks on one card: {refusals}")
    rep["nccl_two_ranks_one_card"] = refusals[0]
    return rep


def gloo_collectives(rt, device) -> dict:
    """11a's gloo pair, each rank in a half-card actor."""
    from ray_tpu_torch.util import remediation

    want_device = "cpu" if device == "cpu" else "cuda:0"
    wait_card_free(rt)
    pair = [rt.remote(num_gpus=0.5, max_concurrency=2)(_GlooMember).remote()
            for _ in range(2)]
    visible = rt.get([m.join.remote(r) for r, m in enumerate(pair)],
                     timeout=600)
    ops = rt.get([m.ops.remote(COLL_SEED, GLOO_SIZES, device)
                  for m in pair], timeout=900)
    problems, gbps = [], {}
    for nbytes in GLOO_SIZES:
        want = _gloo_expected(COLL_SEED, nbytes // 4)
        for name, shas in want.items():
            key = f"{name} {nbytes}"
            for r in range(2):
                got = ops[r][key]
                if got["sha256"] != shas[r] or got["device"] != want_device:
                    problems.append(f"{key} rank {r}: {got}")
            gbps[key] = nbytes / max(ops[0][key]["ms"], ops[1][key]["ms"]) \
                / 1e6
    tuned = rt.get([m.tuned.remote(1 << 20, device) for m in pair],
                   timeout=600)
    for r, t in enumerate(tuned):
        if not all(t["exact"]):
            problems.append(f"tuned allreduce rank {r}: {t['exact']}")
        if t["q8_max_abs_err"] > 2 * 9 / 254 + 1e-5:
            problems.append(f"q8 rank {r}: {t['q8_max_abs_err']}")
        if not any(row["chosen"] for row in t["tuner"].values()):
            problems.append(f"no committed tuner decision in rank {r}")
    if tuned[0]["tuner"] != tuned[1]["tuner"] and {
            k: v["chosen"] for k, v in tuned[0]["tuner"].items()} != {
            k: v["chosen"] for k, v in tuned[1]["tuner"].items()}:
        problems.append("the two ranks committed differently")
    ref = rt.get(pair[0].put.remote(COLL_SEED, device), timeout=60)
    served, fetched = rt.get([pair[0].serve.remote(ref),
                              pair[1].fetch.remote(ref)], timeout=600)
    if fetched != {"sha256": served, "device": want_device,
                   "path": "collective"}:
        problems.append(f"DeviceRef through the group: {fetched} against "
                        f"the owner's {served}")
    recorded = rt.get([m.recorder.remote() for m in pair], timeout=60)
    for r, rec in enumerate(recorded):
        if not rec["algos"] or rec["q8_bytes_saved"] <= 0:
            problems.append(f"recorder rank {r}: {rec}")
    reprobe = remediation._builtin_collective_reprobe(
        "chip_smoke 11a", None, op="allreduce")
    rt.get([m.leave.remote() for m in pair], timeout=60)
    for m in pair:
        rt.kill(m)
    if problems or visible != ["0", "0"]:
        raise AssertionError(f"11a gloo pair (leases {visible}): {problems}")
    return {
        "visible": visible, "gb_per_s": gbps,
        "staged_bytes": tuned[0]["staged"],
        "tuner": {k: v["chosen"] for k, v in tuned[0]["tuner"].items()},
        "q8_max_abs_err": max(t["q8_max_abs_err"] for t in tuned),
        "recorder": recorded, "device_ref": fetched, "reprobe": reprobe}


def _train_loop(config):
    """11b-d's ``train_loop_per_worker``: GPT-2 on the leased card, its
    batches from the ``"train"`` dataset shard, gradients MEAN-allreduced
    through ``ray_tpu_torch.collective`` when the gang has more than one
    rank, a ``torch_ckpt`` checkpoint every ``ckpt_every`` steps, resumed
    from the latest checkpoint (on the card) when there is one, and each
    step's flash launches reported."""
    import hashlib
    import json
    import os
    import tempfile
    import time

    import torch

    import ray_tpu_torch.train as train
    from ray_tpu_torch import collective as col
    from ray_tpu_torch.collective.types import ReduceOp
    from ray_tpu_torch.models import GPT2Config, model_family
    from ray_tpu_torch.ops.attention import (
        flash_attention, flash_dkv, flash_dq,
    )
    from ray_tpu_torch.train.torch_ckpt import (
        async_save_sharded, restore_sharded,
    )

    ctx = train.get_context()
    rank, world = ctx.world_rank, ctx.world_size
    device = config["device"]

    def sync():
        if device != "cpu":
            torch.cuda.synchronize()

    if world > 1:
        col.init_collective_group(world, rank, backend="gloo")
    cfg = GPT2Config(**config["cfg"])
    fam = model_family(cfg)
    params = fam.init(torch.Generator(device).manual_seed(config["seed"]),
                      cfg, device=device)
    params.requires_grad_(True)
    if config["optimizer"] == "adamw":
        opt = torch.optim.AdamW(params.parameters(), lr=config["lr"],
                                betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=1e-4)
    else:
        opt = torch.optim.SGD(params.parameters(), lr=config["lr"])

    def state():
        return {"model": params.state_dict(), "opt": opt.state_dict()}

    def digest():
        h = hashlib.sha256()
        for t in params.state_dict().values():
            h.update(t.detach().contiguous().reshape(-1).view(torch.uint8)
                     .cpu().numpy().tobytes())
        return h.hexdigest()

    start = 0
    ck = train.get_checkpoint()
    if ck is not None:
        # The optimizer's state takes its shape from one step; the
        # restored tensors then replace the step's every effect.
        for p in params.parameters():
            p.grad = torch.zeros_like(p)
        opt.step()
        restored = restore_sharded(state(), ck.path, device=device)
        params.load_state_dict(restored["model"])
        opt.load_state_dict(restored["opt"])
        with open(os.path.join(ck.path, "meta.json")) as f:
            start = json.load(f)["step"]
    shard = train.get_dataset_shard("train")

    def counts():
        return [flash_attention.launches, flash_dq.launches,
                flash_dkv.launches]

    warmup, t_timed = config["warmup"], None
    saves = []
    for step in range(start, config["steps"]):
        if step == warmup:
            sync()
            t_timed = time.perf_counter()
        if step == config.get("fail_at") and not os.path.exists(
                config["marker"]):
            open(config["marker"], "w").close()
            os._exit(1)  # the hard exit of 11c, once
        before = counts()
        batch = next(iter(shard.iter_batches(batch_size=config["batch"],
                                             batch_format="numpy")))
        tokens = torch.from_numpy(batch).to(device)
        opt.zero_grad(set_to_none=True)
        loss = fam.loss(params, tokens, cfg)
        loss.backward()
        if world > 1:
            for p in params.parameters():
                p.grad = col.allreduce(p.grad, op=ReduceOp.MEAN)
        opt.step()
        metrics = {"step": step, "loss": float(loss), "start": start,
                   "launches": [a - b for a, b in zip(counts(), before)]}
        ckpt = None
        if (step + 1) % config["ckpt_every"] == 0:
            d = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
            handle = async_save_sharded(state(), d)
            with open(os.path.join(d, "meta.json"), "w") as f:
                json.dump({"step": step + 1}, f)
            handle.wait()
            saves.append({"host_copy_ms": handle.host_copy_s * 1e3,
                          "write_ms": handle.write_s * 1e3})
            metrics["sha256"] = digest()
            ckpt = train.Checkpoint.from_directory(d) if rank == 0 else None
        train.report(metrics, checkpoint=ckpt)
    sync()
    summary = {"visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
               "backend": ctx.backend, "saves": saves,
               "timed_step_ms": (time.perf_counter() - t_timed)
               / (config["steps"] - warmup) * 1e3
               if t_timed is not None else None}
    if world > 1:
        # Every rank's launches and parameters, gathered to rank 0.
        mine = torch.tensor(counts() + [int(digest()[:12], 16)],
                            dtype=torch.float64)
        summary["ranks"] = [t.tolist() for t in col.allgather(mine)]
        col.destroy_collective_group()
    train.report(summary)


def _token_rows(n: int, seq: int, vocab: int, seed: int):
    rng = np.random.default_rng(seed)
    return list(rng.integers(0, vocab, (n, seq + 1)))


def _fit(rt, rd, *, config, rows, parallelism=1, workers=1, gpus=1.0,
         max_failures=0):
    """One ``TorchTrainer`` fit of ``_train_loop`` over ``rows``, after the
    whole card is free.  A rehearsal on the CPU runs gloo where a whole
    card would take NCCL."""
    import ray_tpu_torch.train as rtrain

    wait_card_free(rt)
    t0 = time.perf_counter()
    backend = rtrain.TorchBackend("gloo" if config["device"] == "cpu"
                                  else None)
    result = rtrain.TorchTrainer(
        _train_loop, train_loop_config=config,
        scaling_config=rtrain.ScalingConfig(
            num_workers=workers, use_gpu=True, gpus_per_worker=gpus),
        run_config=rtrain.RunConfig(
            name="phase11", storage_path=tempfile.mkdtemp(
                prefix="chip_smoke_train_"),
            failure_config=rtrain.FailureConfig(max_failures=max_failures)),
        datasets={"train": rd.from_items(rows, parallelism=parallelism)},
        backend=backend,
    ).fit()
    if result.error is not None:
        raise AssertionError(f"phase 11 fit failed: {result.error!r}")
    result.wall_s = time.perf_counter() - t0
    return result


def _steps(result) -> dict:
    """The per-step reports of rank 0, by step (a resumed run's last)."""
    return {m["step"]: m for m in result.metrics_history if "loss" in m}


def _restore_sha(ckpt, cfg, seed: int, device) -> str:
    """sha256 of the checkpoint's model, restored onto ``device``."""
    import hashlib

    from ray_tpu_torch.train.torch_ckpt import restore_sharded

    fam = model_family(cfg)
    like = fam.init(torch.Generator(device).manual_seed(seed), cfg,
                    device=device)
    got = restore_sharded({"model": like.state_dict()}, ckpt.path,
                          device=device)["model"]
    h = hashlib.sha256()
    for t in got.values():
        h.update(t.contiguous().reshape(-1).view(torch.uint8).cpu().numpy()
                 .tobytes())
    del like, got
    if device != "cpu":
        torch.cuda.empty_cache()
    return h.hexdigest()


def trainer_full_width(rt, rd, cfg, batch: int, seq: int, warmup: int,
                       steps: int, device) -> dict:
    """11b: ``_train_loop`` in one ``TorchTrainer`` worker leasing the card
    (NCCL, world 1) at phase 5's model and batch, fed by a dataset."""
    n_layer = cfg.n_layer
    config = {"cfg": dataclasses.asdict(cfg), "seed": SEED + 4, "optimizer": "adamw", "lr": 1e-4,
              "batch": batch, "warmup": warmup, "steps": warmup + steps,
              "ckpt_every": TRAIN_CKPT_EVERY, "device": device}
    result = _fit(rt, rd, config=config,
                  rows=_token_rows(batch, seq, cfg.vocab_size, SEED + 5))
    per_step = _steps(result)
    want = [n_layer * (2 if cfg.remat else 1), n_layer, n_layer]
    losses = [per_step[s]["loss"] for s in sorted(per_step)]
    summary = result.metrics
    problems = [f"step {s}: launches {m['launches']}, want {want}"
                for s, m in per_step.items() if m["launches"] != want]
    if len(per_step) != warmup + steps:
        problems.append(f"{len(per_step)} steps reported")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        problems.append(f"losses {losses}")
    backend = "gloo" if device == "cpu" else "nccl"
    if summary.get("visible") != "0" or summary.get("torch_backend") != \
            backend or summary.get("backend") != backend:
        problems.append(f"lease/backend {summary}")
    last = max((s for s, m in per_step.items() if "sha256" in m),
               default=None)
    if result.checkpoint is None or last is None:
        problems.append("the result has no checkpoint")
    elif _restore_sha(result.checkpoint, cfg, SEED + 4, device) != \
            per_step[last]["sha256"]:
        problems.append(f"the checkpoint of step {last} does not restore "
                        "bit for bit")
    if problems:
        raise AssertionError(f"11b: {problems}")
    step_ms = summary["timed_step_ms"]
    return {"batch": batch, "seq": seq, "n_layer": n_layer,
            "steps": warmup + steps, "losses": losses,
            "step_ms": step_ms, "tokens_per_s": batch * seq / step_ms * 1e3,
            "launches_per_step": want,
            "launches": [sum(m["launches"][i] for m in per_step.values())
                         for i in range(3)],
            "saves": summary["saves"], "checkpoint_step": last + 1,
            "fit_s": result.wall_s, "visible": summary["visible"],
            "backend": summary["torch_backend"]}


def _train_here(config: dict, rows, device):
    """``_train_loop``'s steps at world 1, in this process: the same init,
    optimizer and batch (the first ``config["batch"]`` rows, as the loop's
    ``iter_batches`` gives them every step).  Returns each step's loss and
    the parameters at the end."""
    cfg = GPT2Config(**config["cfg"])
    fam = model_family(cfg)
    params = fam.init(torch.Generator(device).manual_seed(config["seed"]),
                      cfg, device=device)
    params.requires_grad_(True)
    if config["optimizer"] == "adamw":
        opt = torch.optim.AdamW(params.parameters(), lr=config["lr"],
                                betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=1e-4)
    else:
        opt = torch.optim.SGD(params.parameters(), lr=config["lr"])
    tokens = torch.from_numpy(np.stack(rows[:config["batch"]])).to(device)
    losses = []
    for _ in range(config["steps"]):
        opt.zero_grad(set_to_none=True)
        loss = fam.loss(params, tokens, cfg)
        loss.backward()
        opt.step()
        losses.append(float(loss))
    return losses, {k: v.detach() for k, v in params.state_dict().items()}


def trainer_resume(rt, rd, cfg, seq: int, device) -> dict:
    """11c: the same loop at 2 layers and f32 with ``max_failures=1``; the
    first attempt hard-exits at step 4, right after its checkpoint at step
    3; the second restores on the card.  Its losses from step 4 on must
    equal, at 1e-5 relative, the same steps run uninterrupted in this
    process on the card."""
    marker = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_fail_"),
                          "failed_once")
    small = dataclasses.replace(cfg, n_layer=2, dtype="float32")
    config = {"cfg": dataclasses.asdict(small), "seed": SEED + 70,
              "optimizer": "adamw", "lr": 1e-3, "batch": RESUME_BATCH,
              "warmup": 0, "steps": RESUME_STEPS,
              "ckpt_every": RESUME_FAIL_AT, "fail_at": RESUME_FAIL_AT,
              "marker": marker, "device": device}
    rows = _token_rows(RESUME_BATCH, seq, cfg.vocab_size, SEED + 71)
    resumed = _fit(rt, rd, config=config, rows=rows, max_failures=1)
    clean, _ = _train_here(config, rows, device)
    if device != "cpu":
        torch.cuda.empty_cache()
    # The first attempt's last reports may die with it, unpolled; the
    # second attempt's start at step 4 shows its checkpoint was restored.
    got = _steps(resumed)
    after = range(RESUME_FAIL_AT, RESUME_STEPS)
    errs = {s: abs(got[s]["loss"] - clean[s]) / abs(clean[s])
            for s in after if s in got}
    if (not os.path.exists(marker) or len(errs) != len(after)
            or max(errs.values()) > 1e-5
            or {got[s]["start"] for s in after} != {RESUME_FAIL_AT}):
        raise AssertionError(f"11c: marker {os.path.exists(marker)}, "
                             f"steps {sorted(got)}, errors {errs}")
    return {"losses_resumed": [got[s]["loss"] for s in sorted(got)],
            "losses_clean": clean,
            "max_rel_err_from_step_4": max(errs.values()),
            "fit_s_resumed": resumed.wall_s}


def trainer_data_parallel(rt, rd, cfg, seq: int, device) -> dict:
    """11d: two workers leasing half the card each (gloo, CUDA tensors),
    each on its half of a seeded batch, gradients MEAN-allreduced through a
    collective group of the loop; SGD, 2 layers, f32.  Both ranks'
    parameters must be equal, and equal those of the same SGD steps on the
    whole batch in this process at 1e-4 relative."""
    small = dataclasses.replace(cfg, n_layer=2, dtype="float32")
    config = {"cfg": dataclasses.asdict(small), "seed": SEED + 80,
              "optimizer": "sgd", "lr": DP_LR, "warmup": 0,
              "steps": DP_STEPS, "ckpt_every": DP_STEPS, "device": device}
    rows = _token_rows(DP_BATCH, seq, cfg.vocab_size, SEED + 81)
    two = _fit(rt, rd, config={**config, "batch": DP_BATCH // 2}, rows=rows,
               parallelism=2, workers=2, gpus=0.5)
    losses_one, b = _train_here({**config, "batch": DP_BATCH}, rows, device)
    from ray_tpu_torch.train.torch_ckpt import restore_sharded

    fam = model_family(small)
    like = {"model": fam.init(torch.Generator(device).manual_seed(SEED + 80),
                              small, device=device).state_dict()}
    a = restore_sharded(like, two.checkpoint.path, device=device)["model"]
    rel = {k: ((a[k] - b[k]).abs().max() / b[k].abs().max()).item()
           for k in b}
    ranks = two.metrics["ranks"]
    # flash forward (twice under remat), dQ, dK/dV: a step at 2 layers
    want = [2 * (2 if small.remat else 1), 2, 2]
    problems = []
    if ranks[0][3] != ranks[1][3]:
        problems.append("the two ranks' parameters differ")
    if max(rel.values()) > 1e-4:
        problems.append(f"against one worker: {rel}")
    for r, row in enumerate(ranks):
        if [int(v) for v in row[:3]] != [w * DP_STEPS for w in want]:
            problems.append(f"rank {r} launched {row[:3]}")
    if two.metrics["torch_backend"] != "gloo":
        problems.append(f"backend {two.metrics}")
    if problems:
        raise AssertionError(f"11d: {problems}")
    del a, b, like
    if device != "cpu":
        torch.cuda.empty_cache()
    return {"max_rel_err_vs_one_worker": max(rel.values()),
            "launches_by_rank": [row[:3] for row in ranks],
            "losses_two": [m["loss"] for m in
                           sorted(_steps(two).values(),
                                  key=lambda m: m["step"])],
            "losses_one": losses_one,
            "fit_s_two": two.wall_s,
            "backend": two.metrics["torch_backend"]}


def train_phase(train_cfg, batch: int, seq: int, warmup: int, steps: int,
                device="cuda", local_sizes=LOCAL_SIZES,
                init_kwargs=None) -> dict:
    """Phase 11: the collective layer and Train on the card, under a fresh
    ``ray_tpu_torch.init(num_cpus=4)``.  Every process it starts is
    stopped before it returns."""
    import ray_tpu_torch as rt
    import ray_tpu_torch.data as rd

    os.environ["PYTHONPATH"] = os.pathsep.join(
        p for p in (HERE, os.environ.get("PYTHONPATH")) if p)
    rep = {"local": local_collectives(device, local_sizes)}
    rt.init(num_cpus=4, **(init_kwargs or {}))
    try:
        if rt.cluster_resources().get("GPU") != 1.0:
            raise AssertionError(f"detected {rt.cluster_resources()}")
        rep["dist"] = dist_collectives(rt, device)
        rep["trainer"] = trainer_full_width(rt, rd, train_cfg, batch, seq,
                                            warmup, steps, device)
        rep["resume"] = trainer_resume(rt, rd, train_cfg, seq, device)
        rep["data_parallel"] = trainer_data_parallel(rt, rd, train_cfg, seq,
                                                     device)
    finally:
        rt.shutdown()
    return rep


def report_train_phase(card: str, tp: dict, phase5: dict) -> None:
    """Phase 11's readings: one line of numbers, then the report as JSON."""
    tr, gl = tp["trainer"], tp["dist"]["gloo_world_2"]["gb_per_s"]
    big = max(GLOO_SIZES)
    print(f"train on {card}: 11b TorchTrainer worker {tr['step_ms']:.2f} ms "
          f"a step, {tr['tokens_per_s']:.1f} tokens/s (phase 5 in the "
          f"script's process: {phase5['mean_step_ms']:.2f} ms, "
          f"{phase5['tokens_per_s']:.1f}; ratio "
          f"{tr['step_ms'] / phase5['mean_step_ms']:.3f}), checkpoint save "
          f"ms (caller's copy / background write) "
          f"{[(round(s['host_copy_ms'], 1), round(s['write_ms'], 1)) for s in tr['saves']]}"
          f"; 11c resumed losses within "
          f"{tp['resume']['max_rel_err_from_step_4']:.2e} of an "
          f"uninterrupted run here; 11d two half-card ranks within "
          f"{tp['data_parallel']['max_rel_err_vs_one_worker']:.2e} of the "
          f"whole batch's steps here; gloo GB/s at {big} B: "
          f"{ {k.split()[0]: round(v, 3) for k, v in gl.items() if k.endswith(str(big))} }",
          flush=True)
    print("collective_train " + json.dumps(tp), flush=True)


# ----------------------------------------------------------------- phase 12
# 12a: GPT-2 small split in two halves of its layers, one a half-card
# actor; B=4 x S=1024 ids, so the residual stream on the edge is
# 4 x 1024 x 768 bf16 (6.3 MB, under the channels' 8 MiB default).
DAG_BATCH, DAG_SEQ = 4, 1024
DAG_SEED = SEED + 90
DAG_CALLS, DAG_WARMUP = 20, 5
# The f32 check: 2 layers at full width, B=1 x S=128, logits compared.
DAG_F32_SEQ = 128
DAG_ALLREDUCE_SIZES = (1 << 20, 64 << 20)
DAG_ALLREDUCE_CALLS = 5
# 12b: two trials of a TorchTrainer each, one worker on half the card.
TUNE_LRS = (3e-4, 3e-3)
TUNE_BATCH, TUNE_STEPS = 8, 6
TUNE_SEED = SEED + 100
# 12c: a job serving GPT-2 small from one task leasing the card.
JOB_PROMPTS = (4, 50, 400, SEED + 110)
JOB_TOKENS = 16


class _PipelineStage:
    """One stage of GPT-2 cut by layers, written from the port's
    ``_block``: the first stage embeds token ids, the last runs the final
    norm and the tied head.  Every stage makes the whole model's seeded
    weights (so all stages hold one model) and runs its own layers.  A
    residual that came over a channel arrives on the host and moves to
    this stage's card here."""

    def __init__(self, cfg, seed: int, layers, first: bool, last: bool,
                 device):
        self.cfg, self.first, self.last = cfg, first, last
        self.layers = list(layers)
        self.device = torch.device(device)
        self.params = model_family(cfg).init(
            torch.Generator(device).manual_seed(seed), cfg, device=device)
        self.calls = 0

    def _run(self, x):
        from ray_tpu_torch.models.gpt2 import _block, _layernorm

        p = self.params
        with torch.no_grad():
            if self.first:
                tokens = torch.as_tensor(x).to(self.device)
                x = p["wte"][tokens] + p["wpe"][:tokens.shape[1]][None]
            else:
                x = x.to(self.device)
            for layer in self.layers:
                x = _block(x, p.layer(layer), self.cfg)
            if self.last:
                x = torch.einsum("bse,ve->bsv",
                                 _layernorm(x, p["lnf_g"], p["lnf_b"]),
                                 p["wte"])
        self.calls += 1
        return x

    def forward(self, x):
        """The residual stream; the last stage's greedy next ids."""
        out = self._run(x)
        return out.argmax(-1) if self.last else out

    def logits(self, x):
        return self._run(x)

    def echo(self, x):
        return x

    def counts(self):
        return {"flash_fwd": flash_attention.launches, "calls": self.calls}


def _stages(rt, cfg, seed: int, device):
    """Two half-card stages holding the first and the second half of
    ``cfg``'s layers."""
    stage = rt.remote(_PipelineStage).options(num_gpus=0.5, num_cpus=0)
    split = cfg.n_layer // 2
    return (stage.remote(cfg, seed, range(split), True, False, device),
            stage.remote(cfg, seed, range(split, cfg.n_layer), False, True,
                         device))


def _gpt2_here(cfg, seed: int, tokens, device):
    """The same model's logits from one ``gpt2_apply`` in this process."""
    from ray_tpu_torch.models import gpt2_apply

    params = model_family(cfg).init(torch.Generator(device).manual_seed(seed),
                                    cfg, device=device)
    with torch.no_grad():
        out = gpt2_apply(params, tokens.to(device), cfg)
    del params
    return out


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _per_call_ms(call, n: int, warmup: int) -> dict:
    """Wall ms of ``n`` sequential calls after ``warmup``: median, mean."""
    for _ in range(warmup):
        call()
    ms = []
    for _ in range(n):
        t0 = time.perf_counter()
        call()
        ms.append((time.perf_counter() - t0) * 1e3)
    return {"median": float(np.median(ms)), "mean": float(np.mean(ms)),
            "min": min(ms), "max": max(ms)}


def dag_pipeline(rt, cfg, f32_cfg, batch: int, seq: int, calls: int,
                 warmup: int, device) -> dict:
    """12a: ``InputNode`` -> stage A -> stage B compiled over two
    half-card actors; the greedy ids against one ``gpt2_apply`` here and
    against the same stages called through ``.remote()``; at f32 and two
    layers the logits against the same at 1e-4; every forward's flash
    launches counted in each stage; per-execute wall ms against the
    ``.remote()`` chain at the residual's payload and at one element."""
    from ray_tpu_torch.core.serialization import (
        deserialize_from_bytes, serialize_to_bytes,
    )
    from ray_tpu_torch.dag import InputNode

    rep = {}
    vocab = cfg.vocab_size
    # f32, two layers: the logits.
    wait_card_free(rt)
    tok32 = torch.from_numpy(np.array(_token_rows(1, DAG_F32_SEQ - 1, vocab,
                                                  DAG_SEED + 1)))
    a, b = _stages(rt, f32_cfg, DAG_SEED, device)
    with InputNode() as inp:
        dag = b.logits.bind(a.forward.bind(inp))
    # One edge of 1 x 128 x 50304 f32 logits: 25.8 MB, past the default.
    compiled = dag.experimental_compile(buffer_size_bytes=32 << 20)
    try:
        got = compiled.execute(tok32).get(timeout=600)
    finally:
        compiled.teardown()
    want = _gpt2_here(f32_cfg, DAG_SEED, tok32, device).cpu()
    rep["f32_max_abs_err"] = max_err(got, want)
    if got.shape != want.shape or rep["f32_max_abs_err"] > TOL_F32:
        raise AssertionError(f"12a f32 logits: {rep['f32_max_abs_err']}")
    for stage in (a, b):
        rt.kill(stage)

    # bf16 at full depth: the ids.
    rep["lease_wait_s"] = wait_card_free(rt)
    tokens = torch.from_numpy(np.array(_token_rows(batch, seq - 1, vocab,
                                                   DAG_SEED + 2)))
    a, b = _stages(rt, cfg, DAG_SEED, device)
    want = _gpt2_here(cfg, DAG_SEED, tokens, device).argmax(-1).cpu()
    with InputNode() as inp:
        dag = b.forward.bind(a.forward.bind(inp))
    t0 = time.perf_counter()
    compiled = dag.experimental_compile()
    rep["compile_s"] = time.perf_counter() - t0
    try:
        t0 = time.perf_counter()
        got = compiled.execute(tokens).get(timeout=600)
        rep["first_execute_s"] = time.perf_counter() - t0
        if not torch.equal(got, want):
            raise AssertionError(
                f"12a ids differ from gpt2_apply here at "
                f"{int((got != want).sum())} of {want.numel()} positions")
        rep["execute_ms"] = _per_call_ms(
            lambda: compiled.execute(tokens).get(timeout=600), calls, warmup)
    finally:
        compiled.teardown()
    executes = 1 + warmup + calls
    got = rt.get(b.forward.remote(a.forward.remote(tokens)), timeout=600)
    if not torch.equal(got, want):
        raise AssertionError("12a: the .remote() chain's ids differ")
    rep["remote_ms"] = _per_call_ms(
        lambda: rt.get(b.forward.remote(a.forward.remote(tokens)),
                       timeout=600), calls, warmup)
    remote_calls = 1 + warmup + calls
    counts = rt.get([s.counts.remote() for s in (a, b)], timeout=60)
    per_stage = [cfg.n_layer // 2, cfg.n_layer - cfg.n_layer // 2]
    rep["launches"] = [c["flash_fwd"] for c in counts]
    rep["calls"] = [c["calls"] for c in counts]
    for c, n_layers in zip(counts, per_stage):
        if c["calls"] != executes + remote_calls or \
                c["flash_fwd"] != n_layers * c["calls"]:
            raise AssertionError(
                f"12a launches {counts}: want {n_layers} a call over "
                f"{executes} executes and {remote_calls} remote calls")
    rep["launches_per_execute"] = per_stage

    # One element on every edge: the DAG's own cost.
    one = torch.zeros(1, dtype=torch.bfloat16)
    with InputNode() as inp:
        dag = b.echo.bind(a.echo.bind(inp))
    compiled = dag.experimental_compile()
    try:
        rep["execute_ms_one_element"] = _per_call_ms(
            lambda: compiled.execute(one).get(timeout=60), calls, warmup)
    finally:
        compiled.teardown()
    rep["remote_ms_one_element"] = _per_call_ms(
        lambda: rt.get(b.echo.remote(a.echo.remote(one)), timeout=60),
        calls, warmup)
    for stage in (a, b):
        rt.kill(stage)
    rep["lease_free_s"] = wait_card_free(rt)

    # The edge's host copies, as the channel makes them: the residual to
    # bytes on the host, then back onto the card.
    g = torch.Generator(device).manual_seed(DAG_SEED + 3)
    x = torch.randn((batch, seq, cfg.d_model), generator=g,
                    device=device).to(torch.bfloat16)
    to_host, to_card = [], []
    for _ in range(10):
        _sync(device)
        t0 = time.perf_counter()
        data = serialize_to_bytes(x)
        t1 = time.perf_counter()
        back = deserialize_from_bytes(data).to(device)
        _sync(device)
        to_host.append((t1 - t0) * 1e3)
        to_card.append((time.perf_counter() - t1) * 1e3)
    if not torch.equal(back, x):
        raise AssertionError("the residual changed on its way through bytes")
    rep["edge"] = {"bytes": x.numel() * x.element_size(),
                   "to_host_ms": float(np.median(to_host)),
                   "to_card_ms": float(np.median(to_card))}
    rep["edge"]["host_copy_share"] = (
        (rep["edge"]["to_host_ms"] + rep["edge"]["to_card_ms"])
        / rep["execute_ms"]["median"])
    return rep


class _ReduceMember:
    """An allreduce participant holding seeded tensors on its card, one
    per (dtype, bytes)."""

    def __init__(self, rank: int, device, sizes, seed: int):
        self.device = device
        self.tensors = {key: _member_tensor(rank, key, device, seed)
                        for key in _reduce_keys(sizes)}

    def part(self, key):
        return self.tensors[tuple(key)]

    def visible(self):
        return os.environ.get("CUDA_VISIBLE_DEVICES")


def _reduce_keys(sizes):
    return [(dtype, size) for dtype in ("float32", "bfloat16")
            for size in sizes]


def _member_tensor(rank: int, key, device, seed: int):
    dtype, size = key
    elem = 4 if dtype == "float32" else 2
    g = torch.Generator(device).manual_seed(seed + rank)
    return torch.randn(size // elem, generator=g, device=device).to(
        getattr(torch, dtype))


def dag_allreduce(rt, sizes, calls: int, device) -> dict:
    """12a's in-graph allreduce over two half-card actors: by the host path
    (``apply_collective`` on the card) and through a gloo ``DistGroup`` of
    the two; the sum in participant order, exact at f32 and within 2e-2 at
    bf16; GB/s = bytes a rank over the execute's wall time."""
    from ray_tpu_torch.collective import (
        create_collective_group, destroy_actor_collective_group,
    )
    from ray_tpu_torch.dag import InputNode, MultiOutputNode, allreduce_bind

    seed = SEED + 95
    wait_card_free(rt)
    member = rt.remote(_ReduceMember).options(num_gpus=0.5, num_cpus=0)
    members = [member.remote(r, device, sizes, seed) for r in range(2)]
    visible = rt.get([m.visible.remote() for m in members], timeout=120)
    group = "dag_gloo"
    create_collective_group(members, backend="gloo", group_name=group)
    want = {key: (_member_tensor(0, key, device, seed)
                  + _member_tensor(1, key, device, seed)).cpu()
            for key in _reduce_keys(sizes)}
    rep = {"visible": visible}
    for path, group_name in (("host", None), ("gloo", group)):
        with InputNode() as inp:
            parts = [m.part.bind(inp) for m in members]
            dag = MultiOutputNode(allreduce_bind(parts, "sum",
                                                 group_name=group_name))
        # Every edge carries one tensor of the largest size and a header.
        compiled = dag.experimental_compile(
            buffer_size_bytes=max(sizes) + (1 << 20))
        try:
            for key in _reduce_keys(sizes):
                outs = compiled.execute(key).get(timeout=600)
                tol = 0.0 if key[0] == "float32" else TOL
                errs = [max_err(o, want[key]) for o in outs]
                if any(o.dtype != want[key].dtype or o.shape != want[key].shape
                       for o in outs) or max(errs) > tol:
                    raise AssertionError(f"12a allreduce {path} {key}: "
                                         f"errors {errs}")
                ms = _per_call_ms(
                    lambda: compiled.execute(key).get(timeout=600), calls, 1)
                rep[f"{path} {key[0]} {key[1]}"] = {
                    "max_abs_err": max(errs), "ms": ms["median"],
                    "gb_per_s": key[1] / ms["median"] / 1e6}
        finally:
            compiled.teardown()
    destroy_actor_collective_group(group)
    for m in members:
        rt.kill(m)
    wait_card_free(rt)
    return rep


def _trial_fit(config):
    """One ``TorchTrainer`` fit of ``_train_loop`` for 12b: one worker
    leasing half the card, ``config["lr"]`` for AdamW; a Tune trial runs
    it."""
    import ray_tpu_torch.data as rd
    import ray_tpu_torch.train as rtrain

    cfg = GPT2Config(**config["cfg"])
    loop = {"cfg": config["cfg"], "seed": config["seed"],
            "optimizer": "adamw", "lr": config["lr"],
            "batch": config["batch"], "warmup": 1, "steps": config["steps"],
            # no checkpoint: ``(step + 1) % ckpt_every`` never reaches 0
            "ckpt_every": config["steps"] + 1, "device": config["device"]}
    rows = _token_rows(config["batch"], config["seq"], cfg.vocab_size,
                       config["seed"] + 1)
    t0 = time.time()
    result = rtrain.TorchTrainer(
        _train_loop, train_loop_config=loop,
        scaling_config=rtrain.ScalingConfig(
            num_workers=1, use_gpu=True, gpus_per_worker=0.5),
        run_config=rtrain.RunConfig(
            name="phase12", storage_path=tempfile.mkdtemp(
                prefix="chip_smoke_tune_")),
        datasets={"train": rd.from_items(rows, parallelism=1)},
    ).fit()
    if result.error is not None:
        raise AssertionError(f"12b fit failed: {result.error!r}")
    result.span = (t0, time.time())
    return result


def _tune_trainable(config):
    """12b's trainable: a ``TorchTrainer`` fit whose worker's per-step
    losses and launches this trial reports to Tune, the last report with
    the fit's timed step and lease."""
    import ray_tpu_torch.train as train

    result = _trial_fit(config)
    steps = _steps(result)
    for s in sorted(steps):
        metrics = {"loss": steps[s]["loss"], "step": s,
                   "launches": steps[s]["launches"]}
        if s == max(steps):
            metrics.update(span=result.span,
                           timed_step_ms=result.metrics["timed_step_ms"],
                           visible=result.metrics["visible"],
                           backend=result.metrics["torch_backend"])
        train.report(metrics)


def tune_trials(rt, cfg, batch: int, seq: int, steps: int, device) -> dict:
    """12b: a ``Tuner`` over AdamW's lr, two trials at once, each a
    ``TorchTrainer`` on half the card.  Each trial's losses must equal, at
    1e-5 relative, the same steps of its config run in this process on the
    card, 24/12/12 launches a step
    (remat), the best trial the one with the lower last loss, and the
    leases back after."""
    from ray_tpu_torch import tune

    wait_card_free(rt)
    base = {"cfg": dataclasses.asdict(cfg), "seed": TUNE_SEED,
            "batch": batch, "seq": seq, "steps": steps, "device": device}
    tuner = tune.Tuner(
        _tune_trainable,
        param_space={"lr": tune.grid_search(list(TUNE_LRS)), **base},
        tune_config=tune.TuneConfig(max_concurrent_trials=2, metric="loss",
                                    mode="min"))
    t0 = time.perf_counter()
    grid = tuner.fit()
    fit_s = time.perf_counter() - t0
    lease_s = wait_card_free(rt)
    n = cfg.n_layer
    want_launches = [n * (2 if cfg.remat else 1), n, n]
    trials, problems = {}, []
    for r in grid.results:
        if r.error is not None:
            raise AssertionError(f"12b trial {r.trial_id}: {r.error}")
        hist = [m for m in r.metrics_history if "step" in m]
        last = r.metrics
        trials[r.config["lr"]] = {
            "trial_id": r.trial_id,
            "losses": [m["loss"] for m in hist],
            "launches": [sum(m["launches"][i] for m in hist)
                         for i in range(3)],
            "step_ms": last["timed_step_ms"],
            "tokens_per_s": batch * seq / last["timed_step_ms"] * 1e3,
            "span": last["span"], "visible": last["visible"],
            "backend": last["backend"]}
        if [m["step"] for m in hist] != list(range(steps)):
            problems.append(f"{r.trial_id} reported steps "
                            f"{[m['step'] for m in hist]}")
        problems += [f"{r.trial_id} step {m['step']}: launches "
                     f"{m['launches']}" for m in hist
                     if m["launches"] != want_launches]
    if sorted(trials) != sorted(TUNE_LRS):
        raise AssertionError(f"12b trials {sorted(trials)}")
    spans = [t["span"] for t in trials.values()]
    overlap = min(e for _, e in spans) - max(s for s, _ in spans)
    if overlap <= 0:
        problems.append(f"the trials did not run at once: {spans}")
    best = grid.get_best_result()
    lower = min(trials, key=lambda lr: trials[lr]["losses"][-1])
    if best.config["lr"] != lower:
        problems.append(f"best trial lr {best.config['lr']}, lower last "
                        f"loss at {lower}")
    # Each trial's steps run here on the card, from the same init, rows
    # and optimizer as the trial's worker.
    t0 = time.perf_counter()
    direct = {lr: _train_here(
        {"cfg": base["cfg"], "seed": TUNE_SEED, "optimizer": "adamw",
         "lr": lr, "batch": batch, "steps": steps},
        _token_rows(batch, seq, cfg.vocab_size, TUNE_SEED + 1), device)[0]
        for lr in TUNE_LRS}
    direct_s = time.perf_counter() - t0
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    for lr, t in trials.items():
        if t["visible"] != "0" or t["backend"] != "gloo":
            problems.append(f"lr {lr}: lease/backend {t}")
        t["direct_losses"] = direct[lr]
        t["max_rel_err_vs_direct"] = max(
            abs(x - y) / abs(y)
            for x, y in zip(t["losses"], t["direct_losses"]))
        if len(t["direct_losses"]) != steps or \
                t["max_rel_err_vs_direct"] > 1e-5:
            problems.append(f"lr {lr}: losses {t['losses']} against the "
                            f"same steps here {t['direct_losses']}")
    if problems:
        raise AssertionError(f"12b: {problems}")
    return {"trials": {str(lr): t for lr, t in trials.items()},
            "best_lr": best.config["lr"], "fit_s": fit_s,
            "direct_steps_s": direct_s,
            "overlap_s": overlap, "lease_free_s": lease_s,
            "launches_per_step": want_launches}


def _job_generate(model_cfg, prompts, max_tokens: int, device):
    """12c's task: phase 8's serving engine, in a task leasing the card."""
    return _EngineActor(model_cfg, len(prompts), model_cfg.max_seq, SEED,
                        device).generate(prompts, max_tokens)


def job_main(device: str, cfg_json: str, max_tokens: int) -> int:
    """12c's job entrypoint: joins the running cluster, runs
    ``_job_generate`` in one ``num_gpus=1`` task and prints its result on
    a ``job_result`` line."""
    import ray_tpu_torch as rt

    rt.init(address="auto")
    try:
        task = rt.remote(_job_generate).options(num_gpus=1)
        out = rt.get(task.remote(GPT2Config(**json.loads(cfg_json)),
                                 make_prompts(*JOB_PROMPTS), max_tokens,
                                 device), timeout=600)
    finally:
        rt.shutdown()
    out["entrypoint_visible"] = os.environ.get("CUDA_VISIBLE_DEVICES")
    print("job_result " + json.dumps(out), flush=True)
    return 0


def _cli(*args, timeout: float = 900.0) -> str:
    """``python -m ray_tpu_torch <args>`` from this checkout; its stdout.
    Fails unless it exits 0."""
    # A process that joins the cluster starts a node agent of its own,
    # which registers this host's cards again (as the JAX package's does
    # its TPU chips; ROADMAP C): the CLI joins seeing no card.
    proc = subprocess.run([sys.executable, "-m", "ray_tpu_torch", *args],
                          capture_output=True, text=True, timeout=timeout,
                          cwd=HERE, env={**os.environ,
                                         "CUDA_VISIBLE_DEVICES": ""})
    if proc.returncode != 0:
        raise AssertionError(f"ray-tpu-torch {' '.join(args[:3])} exited "
                             f"{proc.returncode}:\n{proc.stdout[-4000:]}\n"
                             f"{proc.stderr[-4000:]}")
    return proc.stdout


def _gpus(nodes):
    """The GPU totals of the live nodes that hold any."""
    return [n["total"]["GPU"] for n in nodes
            if n["alive"] and n["total"].get("GPU")]


def _get_json(url: str):
    import urllib.request

    with urllib.request.urlopen(url, timeout=60) as resp:
        return json.loads(resp.read())


def job_and_cli(rt, model_cfg, max_tokens: int, device) -> dict:
    """12c: ``ray-tpu-torch job submit`` of ``job_main``, whose task
    serves GPT-2 on the card; its logs' ids against the same engine here;
    ``status`` and ``list nodes`` name the GPU; a dashboard started here
    answers with it."""
    from ray_tpu_torch.dashboard import start_dashboard, stop_dashboard

    wait_card_free(rt)
    sid = f"chip-smoke-{os.getpid()}"
    code = (f"import sys, chip_smoke; sys.exit(chip_smoke.job_main("
            f"{device!r}, {json.dumps(dataclasses.asdict(model_cfg))!r}, "
            f"{max_tokens}))")
    t0 = time.perf_counter()
    submitted = _cli("job", "submit", "--submission-id", sid, "--timeout",
                     "600", "--", sys.executable, "-c", code)
    submit_s = time.perf_counter() - t0
    if f"job {sid}: SUCCEEDED" not in submitted:
        raise AssertionError(f"12c job: {submitted[-4000:]}")
    info = json.loads(_cli("job", "status", sid))
    logs = _cli("job", "logs", sid)
    lines = [l for l in logs.splitlines() if l.startswith("job_result ")]
    if info["status"] != "SUCCEEDED" or len(lines) != 1:
        raise AssertionError(f"12c job status {info}, logs {logs[-4000:]}")
    out = json.loads(lines[0][len("job_result "):])
    local = TorchLLMEngine(EngineConfig(
        model=model_cfg, max_batch_size=JOB_PROMPTS[0],
        max_seq_len=model_cfg.max_seq, seed=SEED), device=device)
    want = _greedy_tokens(local, make_prompts(*JOB_PROMPTS), max_tokens)
    del local
    if out["tokens"] != want:
        raise AssertionError(f"12c: the job's ids {out['tokens']} differ "
                             f"from this process's {want}")
    if min(out["launches"].values()) <= 0 or out["visible"] != "0" or \
            out["entrypoint_visible"] != "":
        raise AssertionError(f"12c job task: {out}")
    wait_card_free(rt)
    status = _cli("status")
    nodes = json.loads(_cli("list", "nodes", "--format", "json"))
    if "1/1 GPU" not in status or _gpus(nodes) != [1.0]:
        raise AssertionError(f"12c status:\n{status}\nnodes {nodes}")
    url = start_dashboard(port=_free_port())
    try:
        cluster = _get_json(url + "/api/cluster")
        dash_nodes = _get_json(url + "/api/nodes")
        jobs = _get_json(url + "/api/jobs")
    finally:
        stop_dashboard()
    if cluster["resources_total"].get("GPU") != 1.0 or \
            _gpus(dash_nodes) != [1.0] or \
            [j.get("status") for j in jobs
             if j.get("submission_id") == sid] != ["SUCCEEDED"]:
        raise AssertionError(f"12c dashboard: {cluster}, {dash_nodes}, "
                             f"{jobs}")
    return {"submit_to_succeeded_s": submit_s,
            "job_run_s": info["end_time"] - info["start_time"],
            "launches": out["launches"], "visible": out["visible"],
            "tokens": [len(t) for t in want],
            "status_gpu_line": [l.strip() for l in status.splitlines()
                                if l.strip().endswith(" GPU")],
            "dashboard_gpu": cluster["resources_total"]["GPU"]}


def dag_tune_phase(device="cuda", cfg=None, f32_cfg=None, dag_shape=None,
                   reduce_sizes=DAG_ALLREDUCE_SIZES, tune_shape=None,
                   job_cfg=None, job_tokens=JOB_TOKENS,
                   init_kwargs=None) -> dict:
    """Phase 12: compiled DAGs, Tune, a job, the CLI and the dashboard on
    the card, under a fresh ``ray_tpu_torch.init(num_cpus=8)`` (two trial
    actors, their two train workers and two dataset coordinators need six
    CPU slots at once).  Every process it starts is stopped before it
    returns."""
    import ray_tpu_torch as rt

    cfg = cfg or GPT2Config.small(dtype="bfloat16", attention="flash")
    f32_cfg = f32_cfg or dataclasses.replace(
        GPT2Config.small(dtype="float32", attention="flash"), n_layer=2)
    batch, seq = dag_shape or (DAG_BATCH, DAG_SEQ)
    tune_batch, tune_seq, tune_steps = tune_shape or (TUNE_BATCH, cfg.max_seq,
                                                      TUNE_STEPS)
    os.environ["PYTHONPATH"] = os.pathsep.join(
        p for p in (HERE, os.environ.get("PYTHONPATH")) if p)
    rep = {}
    rt.init(num_cpus=8, **(init_kwargs or {}))
    try:
        if rt.cluster_resources().get("GPU") != 1.0:
            raise AssertionError(f"detected {rt.cluster_resources()}")
        t0 = time.perf_counter()
        rep["dag"] = dag_pipeline(rt, cfg, f32_cfg, batch, seq, DAG_CALLS,
                                  DAG_WARMUP, device)
        rep["allreduce"] = dag_allreduce(rt, reduce_sizes,
                                         DAG_ALLREDUCE_CALLS, device)
        rep["dag_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rep["tune"] = tune_trials(rt, dataclasses.replace(cfg, remat=True),
                                  tune_batch, tune_seq, tune_steps, device)
        rep["tune_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rep["job"] = job_and_cli(rt, job_cfg or GPT2Config.small(),
                                 job_tokens, device)
        rep["job_s"] = time.perf_counter() - t0
    finally:
        rt.shutdown()
    return rep


def report_dag_tune_phase(card: str, dp: dict, tp: dict) -> None:
    """Phase 12's readings: one line of numbers, then the report as JSON."""
    d, t, j = dp["dag"], dp["tune"], dp["job"]
    ar = {k: round(v["gb_per_s"], 3) for k, v in dp["allreduce"].items()
          if isinstance(v, dict) and "gb_per_s" in v}
    print(f"dag/tune/job on {card}: 12a execute "
          f"{d['execute_ms']['median']:.3f} ms median against "
          f"{d['remote_ms']['median']:.3f} through .remote() at "
          f"{d['edge']['bytes']} B an edge, "
          f"{d['execute_ms_one_element']['median']:.3f} against "
          f"{d['remote_ms_one_element']['median']:.3f} at one element; "
          f"host copies {d['edge']['host_copy_share']:.3f} of an execute; "
          f"allreduce GB/s {ar}; 12b trial step ms "
          f"{ {lr: round(x['step_ms'], 2) for lr, x in t['trials'].items()} }"
          f" (11b, one worker on the card at B=32: "
          f"{tp['trainer']['step_ms']:.2f}), Tuner.fit {t['fit_s']:.1f} s; "
          f"12c submit to SUCCEEDED {j['submit_to_succeeded_s']:.1f} s; "
          f"phase {dp['dag_s'] + dp['tune_s'] + dp['job_s']:.1f} s",
          flush=True)
    print("dag_tune_job " + json.dumps(dp), flush=True)


# ----------------------------------------------------------------- phase 13
PIPE_SEED = SEED + 130
# 13a: GPT-2 small in two stages, 1F1B, B=8 x S=1024 in 4 microbatches.
PIPE_BATCH, PIPE_MICRO, PIPE_STEPS = 8, 4, 5
PIPE_LR = 3e-4
# Against the sequential run of the same chunks on the card: the same
# kernels in the same order, so a larger gap is a fault.
PIPE_TOL = 2e-3
# The first step against the plain path (dense attention), in bf16.
PIPE_PLAIN_TOL = 2e-2
# 13b: the autoscaled GPU node.
AUTOSCALE_SEED = SEED + 140
AUTOSCALE_IDLE_S = 5.0


def _pipe_data(vocab: int, batch: int, seq: int, seed: int):
    """Seeded next-token batches, new tokens each step."""
    def data(step):
        rng = np.random.default_rng(seed + step)
        toks = rng.integers(0, vocab, (batch, seq + 1)).astype(np.int32)
        return toks[:, :-1], toks[:, 1:]

    return data


class _CountedPipelineStage(train_pipeline.PipelineStage._cls):
    """The shipped stage, which also reports its own process's kernel
    launches (counters zeroed when the actor starts), its lease, its peak
    memory on the card, and the host copy of every tensor it sends."""

    def __init__(self, *args):
        super().__init__(*args)
        self._started_at = time.time()
        reset_counters()
        self._d2h_ms = []
        if torch.cuda.is_available():
            torch.cuda.reset_peak_memory_stats()

    def _to_host(self, tree):
        t0 = time.perf_counter()
        out = super()._to_host(tree)
        self._d2h_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def report(self, edge_shape) -> dict:
        """Counters and memory, then the two host copies of one edge tensor
        (``edge_shape``, bf16) timed alone on this stage's device."""
        device = next(iter(self.chunks.values())).device
        cuda = device.type == "cuda"
        rep = {"pid": os.getpid(), "device": str(device),
               "started_at": self._started_at,
               "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
               "launches": flash_counts(), "d2h_ms": list(self._d2h_ms),
               "peak_mb": (torch.cuda.max_memory_allocated(device) / 2 ** 20
                           if cuda else None)}
        x = torch.randn(edge_shape, device=device).to(torch.bfloat16)
        rep["edge_copy"] = _host_copies_ms(x)
        rep["edge_bytes"] = x.numel() * x.element_size()
        return rep


class _CountedPipelinedTrainer(train_pipeline.PipelinedTrainer):
    """The shipped trainer, its stage actors the counted subclass (the
    same lease and placement as ``PipelinedTrainer._spawn_stage``)."""

    def _spawn_stage(self, i: int):
        import ray_tpu_torch as rt
        from ray_tpu_torch.core.placement import placement_group_strategy

        return rt.remote(_CountedPipelineStage).options(
            num_cpus=self.resources_per_stage.get("CPU", 1),
            num_gpus=self.resources_per_stage.get("GPU", 0) or None,
            scheduling_strategy=placement_group_strategy(self._pg, i),
            max_concurrency=4,
        ).remote(i, self.cfg, self._run_id)


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-9)


def pipeline_train(rt, cfg, batch: int, seq: int, micro: int, steps: int,
                   stage_resources: dict, device) -> dict:
    """13a: ``cfg`` cut by ``gpt2_stage_modules`` into two stages, each an
    actor leasing ``stage_resources``, trained ``steps`` steps of 1F1B by
    ``PipelinedTrainer.fit``; every step's loss against ``reference_run``
    of the same chunks here, the first against the plain path; each stage
    process's launches, its stash, its peak memory and its edge copies."""
    from ray_tpu_torch.train import PipelineConfig

    data = _pipe_data(cfg.vocab_size, batch, seq, PIPE_SEED)
    builder = train_pipeline.gpt2_stage_modules(cfg, 2, seed=PIPE_SEED)
    rep = {"shape": {"batch": batch, "seq": seq, "microbatches": micro,
                     "steps": steps, "layers_per_stage": cfg.n_layer // 2}}
    ref, _ = train_pipeline.reference_run(
        builder, 2, data, steps, num_microbatches=micro,
        learning_rate=PIPE_LR, device=device)
    plain_cfg = dataclasses.replace(cfg, attention="dense")
    plain, _ = train_pipeline.reference_run(
        train_pipeline.gpt2_stage_modules(plain_cfg, 2, seed=PIPE_SEED), 2,
        data, 1, num_microbatches=micro, learning_rate=PIPE_LR,
        device=device)
    ref_ms = [w * 1e3 for w in ref.step_walls]
    rep["sequential"] = {"losses": list(ref), "step_ms": ref_ms,
                         "step_ms_median": float(np.median(ref_ms[1:]))}
    # The same batch in one microbatch: what a microbatch costs by itself.
    one, _ = train_pipeline.reference_run(
        builder, 2, data, 4, num_microbatches=1, learning_rate=PIPE_LR,
        device=device)
    rep["sequential"]["one_microbatch_step_ms_median"] = float(
        np.median(one.step_walls[1:])) * 1e3
    if torch.device(device).type == "cuda":
        # Three sequential steps under a kernel trace, less a run of one
        # (the chunks' init and the first step's warm-up): kernel time and
        # kernels a step, against the untraced step's wall time.  Copies
        # are left out: each run ends by copying its state to the host,
        # whose pageable copies take 0.5 s or so and vary from run to run.
        def traced(n):
            with kernel_trace() as prof:
                train_pipeline.reference_run(
                    builder, 2, data, n, num_microbatches=micro,
                    learning_rate=PIPE_LR, device=device)
            ev = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.key.startswith(("Memcpy", "Memset"))]
            return (sum(e.self_device_time_total for e in ev) / 1e3,
                    sum(e.count for e in ev))

        (ms3, k3), (ms1, k1) = traced(3), traced(1)
        sequential = rep["sequential"]
        sequential.update(kernel_ms_per_step=(ms3 - ms1) / 2,
                          kernels_per_step=(k3 - k1) / 2)
        sequential["busy_share"] = (sequential["kernel_ms_per_step"]
                                    / sequential["step_ms_median"])
    rep["plain_first_loss"] = plain[0]
    _sync(device)
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    tr = _CountedPipelinedTrainer(
        builder,
        pipeline_config=PipelineConfig(num_stages=2, num_microbatches=micro,
                                       recv_timeout_s=300.0),
        data_per_step=data, num_steps=steps, learning_rate=PIPE_LR,
        resources_per_stage=stage_resources)
    try:
        t0 = time.perf_counter()
        res = tr.fit()
        rep["fit_s"] = time.perf_counter() - t0
        if res.error is not None:
            raise AssertionError(f"13a: fit failed: {res.error!r}")
        stats = tr._last_step_stats
        stages = rt.get([s.report.remote((batch // micro, seq, cfg.d_model))
                         for s in tr.stages], timeout=300)
    finally:
        tr.shutdown()

    hist = res.metrics_history
    losses = [m["loss"] for m in hist]
    if len(losses) != steps or not all(np.isfinite(losses)):
        raise AssertionError(f"13a: losses {losses}")
    errs = [_rel(a, b) for a, b in zip(losses, ref)]
    if max(errs) > PIPE_TOL:
        raise AssertionError(f"13a: pipelined losses {losses} against the "
                             f"sequential run's {list(ref)}: relative "
                             f"errors {errs} (tolerance {PIPE_TOL})")
    plain_err = _rel(losses[0], plain[0])
    if plain_err > PIPE_PLAIN_TOL:
        raise AssertionError(f"13a: first loss {losses[0]} against the plain "
                             f"path's {plain[0]}: {plain_err} (tolerance "
                             f"{PIPE_PLAIN_TOL})")
    per_layer = (cfg.n_layer // 2) * micro * steps
    want = {"flash_fwd": 2 * per_layer, "flash_dq": per_layer,
            "flash_dkv": per_layer}
    for st in stages:
        if st["launches"] != want:
            raise AssertionError(f"13a: stage pid {st['pid']} launched "
                                 f"{st['launches']}, want {want}")
        if "GPU" in stage_resources and st["visible"] != "0":
            raise AssertionError(f"13a: stage lease {st['visible']!r}")
    hwm = [s["stash_hwm"] for s in stats]
    if hwm[0] > 2:
        raise AssertionError(f"13a: stage 0 held {hwm[0]} inputs, 1F1B "
                             "bounds it at 2")
    step_ms = [m["step_wall_s"] * 1e3 for m in hist[1:]]
    sends = micro  # each stage sends one tensor a microbatch
    rep.update(
        losses=losses, rel_err_sequential=errs, rel_err_plain=plain_err,
        step_ms=step_ms, step_ms_median=float(np.median(step_ms)),
        step_ms_min=min(step_ms),
        tokens_per_s=batch * seq / (float(np.median(step_ms)) / 1e3),
        # The same kernels run in the pipelined step: the sequential
        # step's kernel time over the pipelined step's wall time.
        busy_share_estimate=(rep["sequential"].get("kernel_ms_per_step",
                                                   float("nan"))
                             / float(np.median(step_ms))),
        bubble_fraction=[m["bubble_fraction"] for m in hist],
        bubble_fraction_median=float(np.median(
            [m["bubble_fraction"] for m in hist[1:]])),
        theoretical_bubble=train_pipeline.theoretical_bubble_fraction(
            2, micro),
        stash_hwm=hwm, launches=[st["launches"] for st in stages],
        stage_stats=[{k: s[k] for k in ("fwd_s", "bwd_s", "stall_s",
                                        "wall_s", "channel")}
                     for s in stats],
        edges={name: {"d2h_ms_median_on_path": float(np.median(
                          st["d2h_ms"][sends:])),
                      "alone": st["edge_copy"], "bytes": st["edge_bytes"]}
               for name, st in zip(("forward", "backward"), stages)},
        peak_mb=[st["peak_mb"] for st in stages],
        pids=[st["pid"] for st in stages])
    return rep


def _autoscaled_kernels(device: str, seed: int) -> dict:
    """13b's task, on the node the autoscaler launched: the flash forward
    (#1) at GPT-2 small's prefill width and decode (#4) at its serving
    shape, each against its plain version; its lease and launch counts."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the autoscaled task sees no CUDA device")
    reset_counters()
    gen = torch.Generator(device).manual_seed(seed)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=device).to(
            torch.bfloat16)

    q, k, v = rand(1, 1000, 12, 64), rand(1, 1000, 12, 64), rand(1, 1000,
                                                                 12, 64)
    flash_err = assert_close(flash_attention(q, k, v, causal=True),
                             reference_attention(q, k, v, causal=True),
                             "13b flash forward")
    n_layer, b, h, hkv, d = GPT2_DECODE
    qd = rand(b, h, d)
    kc, vc = rand(n_layer, b, hkv, 1024, d), rand(n_layer, b, hkv, 1024, d)
    pos = torch.tensor([0, 1, 63, 64, 333, 700, 1022, 1023],
                       dtype=torch.int32, device=device)
    dec_err = assert_close(
        decode_attention(qd, kc, vc, pos, n_layer - 1),
        reference_decode_attention(qd, kc, vc, pos, n_layer - 1),
        "13b decode")
    return {"visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "card": (torch.cuda.get_device_name(0)
                     if torch.device(device).type == "cuda" else "cpu"),
            "flash_max_abs_err": flash_err, "decode_max_abs_err": dec_err,
            "launches": {"flash_fwd": flash_attention.launches,
                         "decode_attention": decode_attention.launches}}


def _gpu_total(rt) -> float:
    return rt.cluster_resources().get("GPU", 0.0)


def autoscale_gpu_node(rt, ctx, device, idle_timeout_s: float) -> dict:
    """13b: a head with no card, an ``Autoscaler`` over
    ``FakeMultiNodeProvider`` with one node type ``{"CPU": 2, "GPU": 1}``
    (min 0, max 1), and a ``num_gpus=1`` task with nothing to run it on:
    the node is launched, the task runs #1 and #4 there, the card's lease
    comes back, and the node is drained and terminated."""
    from ray_tpu_torch.autoscaler import (
        Autoscaler,
        AutoscalingConfig,
        FakeMultiNodeProvider,
        NodeTypeConfig,
    )

    if _gpu_total(rt) != 0.0:
        raise AssertionError(f"13b: the head registered {rt.cluster_resources()}")
    cp = ctx.address_info["cp_address"]
    provider = FakeMultiNodeProvider(cp, ctx.address_info["session_id"])
    rep = {}
    try:
        scaler = Autoscaler(AutoscalingConfig(
            node_types={"gpu1": NodeTypeConfig(
                "gpu1", {"CPU": 2.0, "GPU": 1.0}, min_workers=0,
                max_workers=1)},
            idle_timeout_s=idle_timeout_s), provider, cp)
        task = rt.remote(num_cpus=1, num_gpus=1)(_autoscaled_kernels)
        t0 = time.perf_counter()
        ref = task.remote(device, AUTOSCALE_SEED)
        while True:
            decision = scaler.update()
            now = time.perf_counter() - t0
            if decision.to_launch and "launch_decided_s" not in rep:
                rep["launch_decided_s"] = now
            if _gpu_total(rt) == 1.0 and "node_up_s" not in rep:
                rep["node_up_s"] = now
            done, _ = rt.wait([ref], timeout=0.5)
            if done:
                break
            if now > 600:
                raise AssertionError("13b: the task found no GPU node")
        result = rt.get(ref, timeout=60)
        rep["result_s"] = time.perf_counter() - t0
        rep["gpu_total_up"] = _gpu_total(rt)
        if rep["gpu_total_up"] != 1.0:
            raise AssertionError(f"13b: GPU total {rep['gpu_total_up']} with "
                                 "the node up")
        if torch.device(device).type == "cuda" and result["visible"] != "0":
            raise AssertionError(f"13b: task lease {result['visible']!r}")
        if result["launches"] != {"flash_fwd": 1, "decode_attention": 1}:
            raise AssertionError(f"13b: task launched {result['launches']}")
        rep["card_free_wait_s"] = wait_card_free(rt)
        t1 = time.perf_counter()
        while provider.non_terminated_nodes() or _gpu_total(rt) != 0.0:
            if time.perf_counter() - t1 > 180:
                raise AssertionError(
                    f"13b: no scale-down: {provider.non_terminated_nodes()}, "
                    f"{rt.cluster_resources()}")
            time.sleep(0.5)
            scaler.update()
        rep["scale_down_s"] = time.perf_counter() - t1
        rep["gpu_total_down"] = _gpu_total(rt)
        rep["task"] = result
        rep["provider"] = {"create_calls": provider.create_calls,
                           "terminate_calls": provider.terminate_calls}
    finally:
        provider.shutdown()
    return rep


def pipeline_autoscale_phase(device="cuda", cfg=None, pipe_shape=None,
                             stage_resources=None,
                             idle_timeout_s=AUTOSCALE_IDLE_S,
                             init_kwargs=None, head_kwargs=None) -> dict:
    """Phase 13: 13a under a fresh ``ray_tpu_torch.init(num_cpus=4)``; 13b
    under another whose head registers no card.  Every process it starts
    is stopped before it returns."""
    import ray_tpu_torch as rt

    cfg = cfg or GPT2Config.small(dtype="bfloat16", attention="flash")
    batch, seq, micro, steps = pipe_shape or (PIPE_BATCH, cfg.max_seq,
                                              PIPE_MICRO, PIPE_STEPS)
    rep = {}
    t0 = time.perf_counter()
    rt.init(num_cpus=4, **(init_kwargs or {}))
    try:
        rep["pipeline"] = pipeline_train(
            rt, cfg, batch, seq, micro, steps,
            stage_resources or {"CPU": 1.0, "GPU": 0.5}, device)
        wait_card_free(rt)
    finally:
        rt.shutdown()
    rep["pipeline_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ctx = rt.init(num_cpus=2, **(head_kwargs or {"resources": {"GPU": 0.0}}))
    try:
        rep["autoscale"] = autoscale_gpu_node(rt, ctx, device, idle_timeout_s)
    finally:
        rt.shutdown()
    rep["autoscale_s"] = time.perf_counter() - t0
    return rep


def report_pipeline_autoscale_phase(card: str, rep: dict,
                                    train_rep: dict) -> None:
    """Phase 13's readings: one line of numbers, then the report as JSON."""
    p, a = rep["pipeline"], rep["autoscale"]
    edges = {k: {"d2h_ms_on_path": round(e["d2h_ms_median_on_path"], 3),
                 "d2h_ms_alone": round(e["alone"]["d2h_ms"], 3),
                 "h2d_ms_alone": round(e["alone"]["h2d_ms"], 3)}
             for k, e in p["edges"].items()}
    print(f"pipeline/autoscaler on {card}: 13a 1F1B step "
          f"{p['step_ms_median']:.3f} ms median, {p['step_ms_min']:.3f} min "
          f"({p['tokens_per_s']:.1f} tokens/s) against the sequential run's "
          f"{p['sequential']['step_ms_median']:.3f} ms here and phase 5's "
          f"{train_rep['mean_step_ms']:.3f} ms at B=32 (one microbatch of "
          f"B={p['shape']['batch']}: "
          f"{p['sequential']['one_microbatch_step_ms_median']:.3f} ms); "
          f"the sequential step's kernel time "
          f"{p['sequential'].get('kernel_ms_per_step', float('nan')):.3f} "
          f"ms over {p['sequential'].get('kernels_per_step', float('nan')):.0f}"
          f" kernels; bubble "
          f"{p['bubble_fraction_median']:.4f} (theory "
          f"{p['theoretical_bubble']:.4f}); losses within "
          f"{max(p['rel_err_sequential']):.2e} of the sequential run, "
          f"{p['rel_err_plain']:.2e} of the plain path; launches by stage "
          f"{p['launches']}; stash {p['stash_hwm']}; peak MB {p['peak_mb']};"
          f" edges {edges}; 13b node up {a.get('node_up_s', float('nan')):.1f}"
          f" s, task result {a['result_s']:.1f} s, scale-down "
          f"{a['scale_down_s']:.1f} s, GPU total {a['gpu_total_up']} -> "
          f"{a['gpu_total_down']}", flush=True)
    print("pipeline_autoscale " + json.dumps(rep), flush=True)


# ----------------------------------------------------------------- phase 14
SP_RANKS = 4  # 14a: ranks of the single-controller ring on cuda:0
SP_SHAPE = (4, 4096, 12, 64)  # B, global S, H, D: GPT-2 small's attention
SP_SEED = SEED + 150
SP_REPS = 5  # timed forward+backward calls of each route
SHARDED_STEPS = (2, 5)  # 14b: warm-up and timed steps
SHARDED_TOL = 2e-3  # 14b: |sharded loss - unsharded loss| in every step
# 14b: ||g_sharded - g_unsharded|| / ||g_unsharded||, each leaf's gradient
# of the first step, before any update.
SHARDED_GRAD_TOL = 2e-2


def _here(device: str):
    """This process's device: its current card, or the CPU."""
    if device == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def _slowest(ms: float) -> float:
    """The largest of every rank's ``ms`` in a world of several processes;
    ``ms`` itself outside one."""
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_world_size() == 1:
        return ms
    t = torch.tensor([ms], dtype=torch.float64)
    if dist.get_backend() == "nccl":
        t = t.cuda()
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t.item())


def _call_ms(fn, reps: int, device) -> float:
    """ms a call: CUDA events on the card, the host clock on the CPU (a
    rehearsal there), the slowest rank's in a world of several."""
    if device.type == "cuda":
        return _slowest(event_ms(fn, reps))
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return _slowest((time.perf_counter() - t0) / reps * 1e3)


def _fwd_bwd(attn, q, k, v, do):
    """One forward and backward of ``attn``: (out, dq, dk, dv)."""
    q, k, v = (x.detach().requires_grad_(True) for x in (q, k, v))
    out = attn(q, k, v)
    torch.autograd.backward(out, do)
    return out.detach(), q.grad, k.grad, v.grad


def _held(got, want, what: str, blocks: int) -> dict:
    """(out, dq, dk, dv) against ``want``, element by element at TOL
    (absolute and relative); beside each gradient's largest error, its
    relative error by norm in each of the ``blocks`` sequence blocks a
    rank holds (||got - want|| / ||want||), held at TOL too."""
    errs = {"out": assert_close(got[0], want[0], f"{what} out")}
    for name, g, w in zip(("dq", "dk", "dv"), got[1:], want[1:]):
        if not torch.isfinite(g).all():
            raise AssertionError(f"{what} {name}: non-finite gradient")
        errs[name] = assert_close(g, w, f"{what} {name}")
        rel = [float((gb.float() - wb.float()).norm() / wb.float().norm())
               for gb, wb in zip(g.chunk(blocks, 1), w.chunk(blocks, 1))]
        if max(rel) > TOL:
            raise AssertionError(f"{what} {name}: relative error by block "
                                 f"{rel} (tolerance {TOL})")
        errs[f"{name}_rel_by_block"] = rel
    return errs


def seq_parallel_attention(ranks: int = SP_RANKS, shape=SP_SHAPE,
                           reps: int = SP_REPS, device="cuda",
                           mesh=None) -> dict:
    """14a: ring and Ulysses attention, forward and backward, at GPT-2
    small's attention (bf16, causal), held against the whole-sequence
    flash kernels and, for the ring, against the plain ring on the same
    inputs; launches of one kernel-route call counted, each route timed
    against the whole-sequence flash forward+backward (the same causal
    FLOPs).  The ranks are a ``LocalGroup`` of ``ranks`` on cuda:0 (one
    process holds them all), or, given ``mesh``, the seq axis of a
    ``DeviceMesh`` of one process a card: each process then holds one
    rank, and its launches are its own (the ring's rank i runs i + 1
    blocks).  Launches are held on the card only: the CPU runs the
    kernels' plain versions, which count nothing."""
    import functools

    from ray_tpu_torch.collective import LocalGroup
    from ray_tpu_torch.parallel import ring_attention, ulysses_attention
    from ray_tpu_torch.parallel.mesh import axis_size

    if mesh is None:
        dev = torch.device(device, 0) if device == "cuda" else torch.device(
            device)
        group, held = LocalGroup("sp_phase", devices=[dev] * ranks), ranks
        ring_blocks = ranks * (ranks + 1) // 2
    else:
        dev, group, held = _here(device), mesh, 1
        ranks = axis_size(mesh, "seq")
        ring_blocks = mesh.get_local_rank("seq") + 1
    gen = torch.Generator(dev).manual_seed(SP_SEED)
    q, k, v, do = (torch.randn(shape, generator=gen, device=dev,
                               dtype=torch.bfloat16) for _ in range(4))
    whole = functools.partial(flash_attention, causal=True)
    routes = {
        "ring": functools.partial(ring_attention, mesh=group, causal=True,
                                  route="kernel"),
        "ulysses": functools.partial(ulysses_attention, mesh=group,
                                     causal=True, attn_fn=whole),
    }
    want_launches = {
        "ring": {k: ring_blocks for k in ("flash_fwd", "flash_dq",
                                          "flash_dkv")},
        "ulysses": {k: held for k in ("flash_fwd", "flash_dq",
                                      "flash_dkv")}}
    ref = _fwd_bwd(whole, q, k, v, do)
    rep = {"ranks": ranks, "shape": list(shape), "dtype": "bfloat16",
           "whole_ms": _call_ms(lambda: _fwd_bwd(whole, q, k, v, do), reps,
                                dev)}
    for name, attn in routes.items():
        reset_counters()
        got = _fwd_bwd(attn, q, k, v, do)
        launches = flash_counts()
        if dev.type == "cuda" and launches != want_launches[name]:
            raise AssertionError(f"{name}: launches {launches}, want "
                                 f"{want_launches[name]}")
        r = {"launches": launches,
             "vs_whole_kernel": _held(got, ref, f"{name} vs whole flash",
                                      ranks)}
        if name == "ring":
            plain = _fwd_bwd(functools.partial(ring_attention, mesh=group,
                                               causal=True, route="plain"),
                             q, k, v, do)
            r["vs_plain_ring"] = _held(got, plain, "ring vs plain ring",
                                       ranks)
        r["ms"] = _call_ms(lambda: _fwd_bwd(attn, q, k, v, do), reps, dev)
        r["ms_over_whole"] = r["ms"] / rep["whole_ms"]
        rep[name] = r
    return rep


def _grads(params) -> dict:
    """Each leaf's gradient, whole (a sharded one gathered), in f32."""
    from torch.distributed.tensor import DTensor

    out = {}
    for name, p in params.named_parameters():
        g = p.grad
        out[name] = (g.full_tensor() if isinstance(g, DTensor)
                     else g).detach().float()
    return out


def sharded_train(cfg, batch: int, seq: int, steps=SHARDED_STEPS,
                  lr: float = 1e-4, device="cuda", mesh_cfg=None,
                  loss_tol: float = SHARDED_TOL) -> dict:
    """14b: ``cfg`` (attention="ring") trained through ``shard_pytree``
    and ``gpt2_loss(..., mesh=mesh)``, beside the unsharded step with
    ``attention="flash"`` on the same params and tokens: the first step's
    gradient of every leaf within ``SHARDED_GRAD_TOL`` by norm, losses
    within ``loss_tol`` every step, ``cfg.n_layer`` launches of each
    flash kernel a step and a ring block (the ring's rank i runs i + 1
    blocks), ms a step and tokens/s of both.  The mesh is ``mesh_cfg``
    (default: every axis 1) over the caller's ``torch.distributed`` world,
    one process a card, or, when there is none, over a world of one made
    here (NCCL on the card) and ended after.  Every rank runs the
    unsharded step too, on its own card."""
    import torch.distributed as dist

    from ray_tpu_torch.models import gpt2_init, gpt2_loss, gpt2_param_axes
    from ray_tpu_torch.parallel import MeshConfig, build_mesh, shard_pytree
    from ray_tpu_torch.parallel.spmd import LocalShardOptimizer

    dev = _here(device)
    on_card = dev.type == "cuda"
    own_world = not dist.is_initialized()
    if own_world:
        dist.init_process_group(
            "nccl" if on_card else "gloo",
            init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
            world_size=1)
    mesh_cfg = mesh_cfg or MeshConfig()
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    try:
        mesh = build_mesh(mesh_cfg)
        blocks = mesh.get_local_rank("seq") + 1
        base = gpt2_init(torch.Generator(dev).manual_seed(SP_SEED + 1), cfg,
                         device=dev)
        rng = np.random.default_rng(SP_SEED + 2)
        tokens = torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (batch, seq + 1))).to(dev)
        adamw = dict(lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
        runs, first_grads = {}, {}
        for name in ("unsharded", "sharded"):
            if name == "sharded":
                params = shard_pytree(base, gpt2_param_axes(), mesh)
                run_cfg, run_mesh, per_block = cfg, mesh, blocks
            else:
                params = type(base)({
                    **{k: v.detach().clone()
                       for k, v in base.named_parameters(recurse=False)},
                    "blocks": {k: v.detach().clone()
                               for k, v in base.blocks.items()}})
                run_cfg = dataclasses.replace(cfg, attention="flash")
                run_mesh, per_block = None, 1
            params.requires_grad_(True)
            opt = LocalShardOptimizer(params.parameters(), torch.optim.AdamW,
                                      **adamw)
            losses, per_step = [], []
            sync()
            if on_card:
                torch.cuda.reset_peak_memory_stats()
            reset_counters()
            for i in range(sum(steps)):
                if i == steps[0]:
                    sync()
                    t0 = time.perf_counter()
                before = flash_counts()
                loss = gpt2_loss(params, tokens, run_cfg, run_mesh)
                loss.backward()
                if i == 0:
                    first_grads[name] = _grads(params)
                opt.step()
                opt.zero_grad()
                losses.append(loss.detach())
                per_step.append({k: n - before[k]
                                 for k, n in flash_counts().items()})
            sync()
            step_ms = _slowest((time.perf_counter() - t0) / steps[1] * 1e3)
            runs[name] = {
                "losses": torch.stack(losses).float().tolist(),
                "mean_step_ms": step_ms,
                "tokens_per_s": batch * seq / (step_ms / 1e3),
                "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                                if on_card else None),
                "launches": flash_counts(), "launches_per_step": per_step[0]}
            want = {k: cfg.n_layer * per_block for k in per_step[0]}
            if on_card and any(c != want for c in per_step):
                raise AssertionError(f"{name}: launches per step {per_step},"
                                     f" want {want}")
            del params, opt
            if on_card:
                torch.cuda.empty_cache()
    finally:
        if own_world:
            dist.destroy_process_group()
    grad_rel = {k: float((g - first_grads["unsharded"][k]).norm()
                         / first_grads["unsharded"][k].norm())
                for k, g in first_grads["sharded"].items()}
    del first_grads
    gaps = [abs(a - b) for a, b in zip(runs["sharded"]["losses"],
                                       runs["unsharded"]["losses"])]
    if not all(np.isfinite(runs["sharded"]["losses"])):
        raise AssertionError(f"non-finite loss: {runs['sharded']['losses']}")
    if max(grad_rel.values()) > SHARDED_GRAD_TOL:
        raise AssertionError(f"first-step gradients by leaf, relative to the "
                             f"unsharded step's: {grad_rel} (tolerance "
                             f"{SHARDED_GRAD_TOL})")
    if max(gaps) > loss_tol:
        raise AssertionError(f"sharded losses {runs['sharded']['losses']} "
                             f"against {runs['unsharded']['losses']}: gap "
                             f"{max(gaps)} > {loss_tol}")
    return {"batch": batch, "seq": seq, "dtype": cfg.dtype,
            "warmup_steps": steps[0], "timed_steps": steps[1],
            "mesh": list(mesh_cfg.shape), "loss_gaps": gaps,
            "loss_tol": loss_tol, "grad_rel_err": grad_rel,
            "max_grad_rel_err": max(grad_rel.values()), **runs}


def parallel_phase(cfg=None, batch: int = 32, seq: int = 1024) -> dict:
    """Phase 14: ``parallel/`` on the card.  14a ring and Ulysses over 4
    ranks on cuda:0; 14b GPT-2 small trained through the sharded path."""
    cfg = cfg or GPT2Config.small(dtype="bfloat16", attention="ring")
    return {"seq_parallel": seq_parallel_attention(),
            "sharded_train": sharded_train(cfg, batch, seq)}


def report_parallel_phase(card: str, rep: dict, phase5: dict) -> None:
    sp, st = rep["seq_parallel"], rep["sharded_train"]
    sh, un = st["sharded"], st["unsharded"]
    print(f"parallel on {card}: 14a {sp['ranks']} ranks on cuda:0, "
          f"B,S,H,D={sp['shape']} bf16 causal: ring forward+backward "
          f"{sp['ring']['ms']:.3f} ms, Ulysses {sp['ulysses']['ms']:.3f} ms, "
          f"whole-sequence flash {sp['whole_ms']:.3f} ms (ratios "
          f"{sp['ring']['ms_over_whole']:.3f}, "
          f"{sp['ulysses']['ms_over_whole']:.3f}); launches ring "
          f"{sp['ring']['launches']}, Ulysses {sp['ulysses']['launches']}; "
          f"14b GPT-2 small ring through shard_pytree on a world-of-one "
          f"mesh: {sh['mean_step_ms']:.2f} ms a step, "
          f"{sh['tokens_per_s']:.0f} tokens/s, against the unsharded flash "
          f"step {un['mean_step_ms']:.2f} ms ({un['tokens_per_s']:.0f} "
          f"tokens/s) and phase 5's remat step "
          f"{phase5['mean_step_ms']:.2f} ms; largest loss gap "
          f"{max(st['loss_gaps']):.2e}, largest first-step gradient error "
          f"{st['max_grad_rel_err']:.2e} (by norm)", flush=True)
    print("parallel " + json.dumps(rep), flush=True)


# ----------------------------------------------------------------- phase 15
# 15a: ViT-B/16 on one replica leasing the card; 16 client threads send
# 256 seeded images one a request (bf16, full depth), after 64 at f32 and
# 2 layers for the logit parity.
VIT_SEED = SEED + 160
VIT_REQUESTS = (256, 64)  # bf16 full depth, f32 2 layers
VIT_CLIENTS = 16
VIT_MAX_BATCH, VIT_WAIT_S = 32, 0.01
# 15b: ResNet-50 in one TorchTrainer worker leasing the card.
RESNET_SEED = SEED + 170
RESNET_SHAPE = (128, 224, 3, 10)  # batch, image size, warm-up and timed steps
RESNET_LR = 0.05
# 15c: the MoE LM's train step: B x S, warm-up and timed steps.
MOE_SEED = SEED + 180
MOE_SHAPE = (8, 1024, 2, 5)


class _ViTReplica:
    """15a's replica: ``vit_apply`` over each ``@serve.batch`` of images on
    the leased card, recording each batch's size, flash launches, calls of
    the plain attention (which must stay 0) and device ms."""

    def __init__(self, cfg_kw: dict, seed: int, device=None):
        from ray_tpu_torch.models import ViTConfig, vit, vit_init

        self.device = resolve_device(device)
        self.cfg = ViTConfig(**cfg_kw)
        gen = torch.Generator(self.device).manual_seed(seed)
        self.params = vit_init(gen, self.cfg, device=self.device)
        self.plain_calls = 0
        plain = vit.reference_attention

        def counted_plain(*args, **kwargs):
            self.plain_calls += 1
            return plain(*args, **kwargs)

        vit.reference_attention = counted_plain
        self.batches = []

    @serve_batch(max_batch_size=VIT_MAX_BATCH, batch_wait_timeout_s=VIT_WAIT_S)
    async def classify(self, images):
        from ray_tpu_torch.models import vit_apply

        x = torch.from_numpy(np.stack(images)).to(self.device)
        before = (flash_attention.launches, self.plain_calls)
        t0 = time.perf_counter()
        with torch.no_grad():
            logits = vit_apply(self.params, x, self.cfg)
        rows = logits.float().cpu().numpy()  # synchronises
        self.batches.append({
            "size": len(images), "ms": (time.perf_counter() - t0) * 1e3,
            "flash": flash_attention.launches - before[0],
            "plain": self.plain_calls - before[1]})
        return list(rows)

    async def __call__(self, image):
        return await self.classify(image)

    def stats(self, reset: bool = False) -> dict:
        out = {"batches": self.batches,
               "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
               "launches": flash_attention.launches}
        if reset:
            self.batches = []
            flash_attention.launches = 0
        return out


def _clients(send, items, n: int):
    """``send(item)`` for every item from ``n`` client threads; returns
    (results, per-request seconds, wall seconds)."""
    def timed(item):
        t = time.perf_counter()
        out = send(item)
        return out, time.perf_counter() - t

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(n) as pool:
        done = list(pool.map(timed, items))
    return [o for o, _ in done], [t for _, t in done], \
        time.perf_counter() - t0


def _vit_images(n: int, size: int, seed: int):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((size, size, 3)).astype(np.float32)
            for _ in range(n)]


def vit_serve(rt, serve, cfg, n_requests: int, device) -> dict:
    """One replica of ``cfg`` leasing the card; ``n_requests`` seeded
    images, one a request, from ``VIT_CLIENTS`` threads after one warm-up
    request.  Gates: every answer a class of ``cfg``, a batch above 1, the
    flash forward ``n_layer`` times a batch and the plain attention never.
    Returns the replica's logit rows with the readings."""
    from ray_tpu_torch.models import vit_apply, vit_init

    wait_card_free(rt)
    dep = serve.deployment(
        _ViTReplica, name="ViTReplica",
        ray_actor_options={"num_cpus": 0, "num_gpus": 1},
        max_ongoing_requests=2 * VIT_MAX_BATCH)
    images = _vit_images(n_requests, cfg.image_size, VIT_SEED + 1)
    t0 = time.perf_counter()
    handle = serve.run(dep.bind(dataclasses.asdict(cfg), VIT_SEED,
                                "cpu" if device == "cpu" else None))
    try:
        # The replica's start: deployed, weights made, first answer back.
        handle.remote(images[0]).result(timeout=600)
        start_s = time.perf_counter() - t0
        handle.stats.remote(reset=True).result(timeout=60)
        rows, lat, wall = _clients(
            lambda img: handle.remote(img).result(timeout=600), images,
            VIT_CLIENTS)
        st = handle.stats.remote().result(timeout=60)
    finally:
        serve.delete("ViTReplica")
    sizes = [b["size"] for b in st["batches"]]
    classes = [int(np.argmax(r)) for r in rows]
    problems = []
    if sum(sizes) != n_requests or max(sizes) <= 1:
        problems.append(f"batch sizes {sizes}")
    if any(b["flash"] != cfg.n_layer or b["plain"] for b in st["batches"]):
        problems.append(f"attention a batch {st['batches']}, want "
                        f"{cfg.n_layer} flash launches and no plain call")
    if not all(0 <= c < cfg.num_classes for c in classes) or any(
            not np.isfinite(r).all() for r in rows):
        problems.append("an answer is no class")
    if device != "cpu" and st["visible"] != "0":
        problems.append(f"replica lease {st['visible']!r}")
    if problems:
        raise AssertionError(f"15a {cfg.dtype} {cfg.n_layer} layers: "
                             f"{problems}")
    # The same weights and images through vit_apply here, VIT_MAX_BATCH
    # at a time.
    dev = resolve_device(device)
    params = vit_init(torch.Generator(dev).manual_seed(VIT_SEED), cfg,
                      device=dev)
    local = []
    with torch.no_grad():
        for i in range(0, n_requests, VIT_MAX_BATCH):
            x = torch.from_numpy(np.stack(images[i:i + VIT_MAX_BATCH]))
            local.append(vit_apply(params, x.to(dev), cfg).float().cpu()
                         .numpy())
    local = np.concatenate(local)
    del params
    if device != "cpu":
        torch.cuda.empty_cache()
    return {"requests": n_requests, "clients": VIT_CLIENTS,
            "images_per_s": n_requests / wall, "wall_s": wall,
            "latency_s": _percentiles(lat), "replica_start_s": start_s,
            "batch_sizes": sizes,
            "batch_ms": _percentiles([b["ms"] for b in st["batches"]]),
            "launches": st["launches"], "launches_per_batch": cfg.n_layer,
            "rows": np.stack(rows), "local_rows": local,
            "top1_agree": float(np.mean(np.argmax(local, -1) == classes))}


def resnet_flops(cfg, batch: int, size: int) -> dict:
    """Multiply-adds of one forward of ``cfg`` over ``batch`` images of
    ``size``, reckoned from the convolutions' and the head's shapes, and
    the FLOPs of a train step: forward, and backward's input and weight
    gradients (the stem's input gradient is not taken)."""
    from ray_tpu_torch.models.resnet import _layout

    def out(n, s):
        return -(-n // s)

    hw = out(size, 2)  # stem
    macs = stem = hw * hw * 7 * 7 * 3 * 64
    hw = out(hw, 2)  # max-pool
    blocks, cin = _layout(cfg)
    for _, _, stride, convs in blocks:
        o = out(hw, stride)
        for name, kh, kw, ci, co in convs:
            # The bottleneck's conv1 runs at the block's input size; every
            # other convolution of the block at its output size.
            at = hw if (name == "conv1" and cfg.bottleneck) else o
            macs += at * at * kh * kw * ci * co
        hw = o
    macs += cin * cfg.num_classes
    per_image = macs
    return {"macs_per_image": per_image,
            "train_flops": 2 * batch * (3 * per_image - stem)}


def _resnet_loop(config):
    """15b's ``train_loop_per_worker``: ResNet on the leased card, one
    seeded batch, SGD with momentum; each step's loss reported, then the
    readings and the train/eval checks of the running statistics."""
    import os

    import torch

    import ray_tpu_torch.train as train
    from ray_tpu_torch.device import resolve_device
    from ray_tpu_torch.models import (
        ResNetConfig, resnet_apply, resnet_init, resnet_loss,
    )

    ctx = train.get_context()
    device = resolve_device(config["device"])
    cuda = device.type == "cuda"
    cfg = ResNetConfig(**{k: tuple(map(tuple, v)) if k == "stages" else v
                          for k, v in config["cfg"].items()})
    gen = torch.Generator(device).manual_seed(config["seed"])
    params, state = resnet_init(gen, cfg, device=device)
    params.requires_grad_(True)
    b, size = config["batch"], config["size"]
    images = torch.randn((b, size, size, 3), generator=gen, device=device)
    labels = torch.randint(0, cfg.num_classes, (b,), generator=gen,
                           device=device)
    opt = torch.optim.SGD(params.parameters(), lr=config["lr"],
                          momentum=0.9)
    init_state = [t.clone() for t in _leaves(state)]

    def sync():
        if cuda:
            torch.cuda.synchronize()

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    losses, t_timed = [], None
    for step in range(config["warmup"] + config["steps"]):
        if step == config["warmup"]:
            sync()
            t_timed = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss, state = resnet_loss(params, state, images, labels, cfg)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
        train.report({"step": step})
    sync()
    step_ms = (time.perf_counter() - t_timed) / config["steps"] * 1e3
    losses = [float(x) for x in losses]
    moved = [not torch.equal(a, b) for a, b in zip(init_state,
                                                    _leaves(state))]
    with torch.no_grad():
        logits, eval_state = resnet_apply(params, state, images, cfg,
                                          train=False)
    fixed = all(a is b for a, b in zip(_leaves(state), _leaves(eval_state)))
    train.report({
        "losses": losses, "step_ms": step_ms,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9 if cuda
        else None,
        "stats_moved": sum(moved), "stats": len(moved),
        "stats_f32": all(t.dtype == torch.float32 for t in _leaves(state)),
        "eval_state_fixed": fixed,
        "eval_logits_finite": bool(torch.isfinite(logits).all()),
        "params_bf16": all(p.dtype == torch.bfloat16
                           for p in params.parameters()),
        "n_params": sum(p.numel() for p in params.parameters()),
        "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
        "backend": ctx.backend})


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def resnet_trainer(rt, cfg, shape, device) -> dict:
    """15b: ``_resnet_loop`` in one ``TorchTrainer`` worker leasing the
    whole card (NCCL, world 1; gloo in a rehearsal on the CPU)."""
    import ray_tpu_torch.train as rtrain

    batch, size, warmup, steps = shape
    wait_card_free(rt)
    config = {"cfg": dataclasses.asdict(cfg), "seed": RESNET_SEED,
              "batch": batch, "size": size, "warmup": warmup,
              "steps": steps, "lr": RESNET_LR, "device": device}
    t0 = time.perf_counter()
    result = rtrain.TorchTrainer(
        _resnet_loop, train_loop_config=config,
        scaling_config=rtrain.ScalingConfig(num_workers=1, use_gpu=True,
                                            gpus_per_worker=1.0),
        run_config=rtrain.RunConfig(name="phase15", storage_path=tempfile
                                    .mkdtemp(prefix="chip_smoke_resnet_")),
        backend=rtrain.TorchBackend("gloo" if device == "cpu" else None),
    ).fit()
    if result.error is not None:
        raise AssertionError(f"15b fit failed: {result.error!r}")
    m = result.metrics
    losses = m["losses"]
    backend = "gloo" if device == "cpu" else "nccl"
    problems = []
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        problems.append(f"losses {losses}")
    if m["stats_moved"] != m["stats"] or not m["stats_f32"]:
        problems.append(f"train mode moved {m['stats_moved']} of "
                        f"{m['stats']} statistics (f32: {m['stats_f32']})")
    if not (m["eval_state_fixed"] and m["eval_logits_finite"]):
        problems.append("eval mode changed the statistics or gave "
                        "non-finite logits")
    if not m["params_bf16"] or m["backend"] != backend or m.get(
            "torch_backend") != backend or (device != "cpu"
                                           and m["visible"] != "0"):
        problems.append(f"worker {m}")
    if problems:
        raise AssertionError(f"15b: {problems}")
    fl = resnet_flops(cfg, batch, size)
    bound_ms = fl["train_flops"] / BF16_FLOPS * 1e3
    return {"batch": batch, "image_size": size, "warmup_steps": warmup,
            "timed_steps": steps, "losses": losses, "step_ms": m["step_ms"],
            "images_per_s": batch / m["step_ms"] * 1e3,
            "peak_mem_gb": m["peak_mem_gb"], "n_params": m["n_params"],
            "macs_per_image": fl["macs_per_image"],
            "train_flops": fl["train_flops"], "bound_ms": bound_ms,
            "bound_by": "operations",
            "bound_share": bound_ms / m["step_ms"],
            "stats_moved": m["stats_moved"], "fit_s":
                time.perf_counter() - t0}


def _moe_family():
    from ray_tpu_torch.models import moe_init, moe_loss

    return types.SimpleNamespace(init=moe_init, loss=moe_loss)


def moe_train(cfg, shape) -> dict:
    """15c: the MoE LM's train step on the card (``train``, phase 5's
    harness: seeded tokens, AdamW, launch counts every step, a profiled
    step), then the aux loss of its initial weights on its batch."""
    from ray_tpu_torch.models import moe_apply, moe_init

    batch, seq, warmup, steps = shape
    rep = train(cfg, batch, seq, warmup, steps, fam=_moe_family())
    # The aux loss on train()'s initial weights and batch (its seeds).
    params = moe_init(torch.Generator("cuda").manual_seed(SEED + 4), cfg)
    tokens = torch.from_numpy(np.random.default_rng(SEED + 5).integers(
        0, cfg.vocab_size, (batch, seq + 1))).cuda()
    with torch.no_grad():
        _, aux = moe_apply(params, tokens[:, :-1], cfg)
    rep["aux"] = aux.item()
    if not rep["aux"] > 0:
        raise AssertionError(f"15c: aux loss {rep['aux']}")
    del params
    torch.cuda.empty_cache()
    return rep


def vision_moe_phase(device="cuda", vit_cfg=None, vit_f32_cfg=None,
                     vit_requests=VIT_REQUESTS, resnet_cfg=None,
                     resnet_shape=RESNET_SHAPE, init_kwargs=None) -> dict:
    """Phase 15 (a) and (b) under a fresh ``ray_tpu_torch.init(num_cpus=4)``:
    ViT-B/16 served in batches, then ResNet-50 in a ``TorchTrainer``.
    Every process it starts is stopped before it returns.  (c) runs in
    this process (``moe_train``, ``train_parity``)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.models import ResNetConfig, ViTConfig

    os.environ["PYTHONPATH"] = os.pathsep.join(
        p for p in (HERE, os.environ.get("PYTHONPATH")) if p)
    vit_cfg = vit_cfg or ViTConfig.b16(attention="flash")
    vit_f32_cfg = vit_f32_cfg or ViTConfig.b16(attention="flash", n_layer=2,
                                               dtype="float32")
    resnet_cfg = resnet_cfg or ResNetConfig.resnet50()
    rt.init(num_cpus=4, **(init_kwargs or {}))
    try:
        if rt.cluster_resources().get("GPU") != 1.0:
            raise AssertionError(f"detected {rt.cluster_resources()}")
        f32 = vit_serve(rt, serve, vit_f32_cfg, vit_requests[1], device)
        err = float(np.abs(f32["rows"] - f32["local_rows"]).max())
        if not np.allclose(f32["rows"], f32["local_rows"], rtol=TOL_F32,
                           atol=TOL_F32):
            raise AssertionError(f"15a f32: replica logits differ from "
                                 f"vit_apply here by up to {err}")
        f32["max_abs_err"] = err
        bf16 = vit_serve(rt, serve, vit_cfg, vit_requests[0], device)
        rep = {"vit_f32": f32, "vit": bf16}
        rep["resnet"] = resnet_trainer(rt, resnet_cfg, resnet_shape, device)
    finally:
        serve.shutdown()
        rt.shutdown()
    for key in ("vit_f32", "vit"):
        del rep[key]["rows"], rep[key]["local_rows"]
    return rep


def report_vision_moe_phase(card: str, rep: dict) -> None:
    """Phase 15's readings: one line of numbers, then the report as JSON."""
    vit, rn, moe = rep["vit"], rep["resnet"], rep["moe"]
    print(f"vision and moe on {card}: 15a ViT-B/16 bf16 "
          f"{vit['images_per_s']:.1f} images/s, request latency p50 "
          f"{vit['latency_s']['p50']:.3f} s p99 {vit['latency_s']['p99']:.3f}"
          f" s, batches {vit['batch_sizes']}, replica start "
          f"{vit['replica_start_s']:.1f} s, top-1 agreement with vit_apply "
          f"here {vit['top1_agree']:.3f} (f32 2 layers: every logit within "
          f"{rep['vit_f32']['max_abs_err']:.2e}); 15b ResNet-50 "
          f"{rn['images_per_s']:.1f} images/s, {rn['step_ms']:.2f} ms a step "
          f"(bound {rn['bound_ms']:.2f} ms: {rn['train_flops']:.4g} FLOPs at "
          f"989 TFLOP/s, share {rn['bound_share']:.3f}), peak "
          f"{rn['peak_mem_gb']} GB; 15c MoE {moe['tokens_per_s']:.1f} "
          f"tokens/s, {moe['mean_step_ms']:.2f} ms a step, aux "
          f"{moe['aux']:.4f}, peak {moe['peak_mem_gb']} GB", flush=True)
    print("vision_moe " + json.dumps(rep), flush=True)


# ----------------------------------------------------------------- phase 16
RL_SEED = SEED + 190
RL_ENV_CASES = 1000  # 16a: seeded states and actions a env
RL_TOL = 1e-5  # 16a obs; 16b every loss, aux and leaf, relative
RL_VTRACE_SHAPE = (64, 16)  # 16b: Anakin's E x T
RL_PPO_BATCH = 512  # 16b: 2 runners x 256 steps
RL_SAC_BATCH = 128
ANAKIN_TIMED = 3  # 16c: timed training_steps after one warm-up
ANAKIN_MAX_D2H = 2  # 16c: device-to-host copies a training_step
PPO_ITERS = 3  # 16f


def _rel_err(got, want) -> float:
    """Largest |got - want| over the largest |want| (0 when both are 0)."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    return err / scale if scale > 0 else err


def _tree_rel(got, want) -> float:
    from ray_tpu_torch.rllib.algorithm import tree_paths

    g, w = dict(tree_paths(got)), dict(tree_paths(want))
    if sorted(g) != sorted(w):
        raise AssertionError(f"leaves differ: {sorted(g)} vs {sorted(w)}")
    return max(_rel_err(g[k], w[k]) for k in w)


def rl_env_parity(device="cuda", n=RL_ENV_CASES, seed=RL_SEED) -> dict:
    """16a: ``CartPoleTorch`` and ``PendulumTorch`` stepping ``n`` seeded
    states, step counts and actions on ``device`` at once, against the
    numpy envs one state at a time.  The states straddle CartPole's x and
    angle thresholds and Pendulum's velocity clip, and 1 in 10 is on its
    last step, so done and the auto-reset run too.  Obs within 1e-5 where
    the step is not done; where it is, the torch env has reset itself (a
    fresh state within 0.05, or Pendulum's reset ranges, at step 0);
    CartPole's rewards and every done equal; Pendulum's rewards within
    1e-5 (f32 here, f64 in numpy)."""
    from ray_tpu_torch.rllib import CartPole, Pendulum
    from ray_tpu_torch.rllib.algorithm import seeded_generator
    from ray_tpu_torch.rllib.env import CartPoleTorch, PendulumTorch

    rng = np.random.default_rng(seed)
    rep = {}
    last = lambda: np.where(rng.random(n) < 0.1, 199,  # noqa: E731
                            rng.integers(0, 199, n)).astype(np.int32)
    cases = {
        "cartpole": (CartPoleTorch(), CartPole(seed=0),
                     rng.uniform([-2.5, -1.0, -0.25, -1.0],
                                 [2.5, 1.0, 0.25, 1.0], (n, 4))
                     .astype(np.float32), last(), rng.integers(0, 2, n)),
        "pendulum": (PendulumTorch(), Pendulum(seed=0),
                     np.stack([rng.uniform(-np.pi, np.pi, n),
                               rng.uniform(-8.0, 8.0, n)], -1)
                     .astype(np.float32), last(),
                     rng.uniform(-2.5, 2.5, n).astype(np.float32)),
    }
    for name, (tenv, nenv, phys, steps, actions) in cases.items():
        state = {"phys": torch.from_numpy(phys).to(device),
                 "steps": torch.from_numpy(steps).to(device)}
        new, obs, rew, done = tenv.step(
            seeded_generator(device, seed), state,
            torch.from_numpy(actions).to(device))
        obs, rew, done = obs.cpu().numpy(), rew.cpu().numpy(), \
            done.cpu().numpy()
        new_phys, new_steps = (new["phys"].cpu().numpy(),
                               new["steps"].cpu().numpy())
        want = []
        for i in range(n):
            nenv.state = phys[i].astype(
                np.float32 if name == "cartpole" else np.float64)
            nenv.steps = int(steps[i])
            a = int(actions[i]) if name == "cartpole" else actions[i]
            want.append(nenv.step(a))
        wobs = np.stack([w[0] for w in want])
        wrew = np.asarray([w[1] for w in want])
        wdone = np.asarray([w[2] for w in want])
        if not np.array_equal(done, wdone):
            raise AssertionError(f"16a {name}: dones differ at "
                                 f"{np.flatnonzero(done != wdone)[:8]}")
        live = ~wdone
        obs_err = float(np.abs(obs[live] - wobs[live]).max())
        rew_err = float(np.abs(rew - wrew).max())
        if obs_err > RL_TOL or (rew_err > RL_TOL if name == "pendulum"
                                else rew_err != 0.0):
            raise AssertionError(f"16a {name}: obs err {obs_err}, reward "
                                 f"err {rew_err}")
        bound = (np.full(4, 0.05) if name == "cartpole"
                 else np.array([np.pi, 1.0]))
        reset_ok = (np.all(new_steps[wdone] == 0)
                    and np.all(np.abs(new_phys[wdone]) <= bound)
                    and np.array_equal(new_steps[live], steps[live] + 1))
        if not (wdone.sum() > 0 and live.sum() > 0 and reset_ok):
            raise AssertionError(f"16a {name}: {int(wdone.sum())} done, the "
                                 f"auto-reset {'held' if reset_ok else 'failed'}")
        rep[name] = {"cases": n, "live": int(live.sum()),
                     "done": int(wdone.sum()),
                     "obs_max_abs_err": obs_err,
                     "reward_max_abs_err": rew_err}
    return rep


def _rl_batch(n, t, seed):
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.normal(size=(n, t, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, (n, t)).astype(np.int64),
        "rewards": np.ones((n, t), np.float32),
        "dones": (rng.random((n, t)) < 0.05).astype(np.float32),
        "logp_old": np.log(rng.uniform(0.3, 0.7, (n, t))).astype(np.float32),
        "last_value": rng.normal(size=n).astype(np.float32),
    }


def rl_learner_parity(device="cuda", seed=RL_SEED) -> dict:
    """16b: the same computations on ``device`` and on the CPU from the
    same params and inputs, every loss, aux and leaf within 1e-5 of the
    CPU's, relative to its largest magnitude: the batched v-trace loss and
    its gradients at Anakin's E x T (with and without the APPO clip);
    ``TorchLearner.update_minibatches`` on one 2 x 256-step batch; one SAC
    update with its noise passed in."""
    from ray_tpu_torch.rllib import PPOConfig, RLModuleSpec, SACModule
    from ray_tpu_torch.rllib.algorithm import (
        Adam, seeded_generator, to_tensors, tree_map, value_and_grad)
    from ray_tpu_torch.rllib.impala import make_vtrace_loss
    from ray_tpu_torch.rllib.ppo import TorchLearner, _init_policy
    from ray_tpu_torch.rllib.sac import make_sac_update

    rep = {}
    on = lambda tree, dev: to_tensors(tree, dev)  # noqa: E731
    params = _init_policy(seeded_generator("cpu", seed), 4, 2, 32)
    params["wp"] = params["wp"] * 100.0  # ratios away from 1: clips bite
    e, t = RL_VTRACE_SHAPE
    batch = {k: torch.from_numpy(v) for k, v in
             _rl_batch(e, t, seed + 1).items()}
    for appo in (False, True):
        loss_fn = make_vtrace_loss(gamma=0.99, c_bar=0.9,
                                   use_appo_clip=appo)
        out = {}
        for dev in ("cpu", device):
            loss, aux, grads = value_and_grad(
                loss_fn, on(params, dev),
                {k: v.to(dev) for k, v in batch.items()})
            out[dev] = (loss, aux, grads)
        errs = {"loss": _rel_err(out[device][0], out["cpu"][0]),
                "aux": max(_rel_err(a, b) for a, b in
                           zip(out[device][1], out["cpu"][1])),
                "grads": _tree_rel(out[device][2], out["cpu"][2])}
        if max(errs.values()) > RL_TOL:
            raise AssertionError(f"16b vtrace appo={appo}: {errs}")
        rep[f"vtrace_appo_{appo}".lower()] = errs

    rng = np.random.default_rng(seed + 2)
    n = RL_PPO_BATCH
    ppo_batch = {
        "obs": rng.normal(size=(n, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, n).astype(np.int32),
        "logp_old": np.log(rng.uniform(0.3, 0.7, n)).astype(np.float32),
        "advantages": rng.normal(size=n).astype(np.float32),
        "returns": rng.normal(1.0, 1.0, n).astype(np.float32),
    }
    learners = {dev: TorchLearner(PPOConfig(device=dev, seed=seed), 4, 2)
                for dev in ("cpu", device)}
    learners[device].params = on(learners["cpu"].params, device)
    learners[device].opt_state = learners[device].tx.init(
        learners[device].params)
    stats = {dev: lrn.update_minibatches(ppo_batch)
             for dev, lrn in learners.items()}
    errs = {"params": _tree_rel(learners[device].params,
                                learners["cpu"].params)}
    errs["stats"] = max(abs(stats[device][k] - stats["cpu"][k])
                        / max(abs(stats["cpu"][k]), 1e-12)
                        for k in stats["cpu"])
    if max(errs.values()) > RL_TOL:
        raise AssertionError(f"16b TorchLearner: {errs}")
    rep["torch_learner"] = {**errs, "updates": 4 * (n // 128)}

    mod = RLModuleSpec(SACModule, {"hidden": 64}).build(3, 1)
    gen = seeded_generator("cpu", seed + 3)
    sac_params = mod.init_state(gen)
    b = RL_SAC_BATCH
    sac_batch = {
        "obs": torch.randn((b, 3), generator=gen),
        "actions": torch.rand((b, 1), generator=gen) * 1.98 - 0.99,
        "rewards": torch.randn(b, generator=gen) - 2.0,
        "next_obs": torch.randn((b, 3), generator=gen),
        "dones": torch.rand(b, generator=gen) < 0.1,
    }
    noise = {"next": torch.randn((b, 1), generator=gen),
             "actor": torch.randn((b, 1), generator=gen)}
    tx = Adam(3e-3)
    update = make_sac_update(mod, tx, tx, 0.99, 0.01, -1.0)
    outs = {}
    for dev in ("cpu", device):
        p = on(sac_params, dev)
        la = torch.tensor(np.log(0.1), dtype=torch.float32, device=dev)
        outs[dev] = update(p, tree_map(torch.clone, p), la, tx.init(p),
                           tx.init(la),
                           {k: v.to(dev) for k, v in sac_batch.items()},
                           None, {k: v.to(dev) for k, v in noise.items()})
    errs = {"params": _tree_rel(outs[device][0], outs["cpu"][0]),
            "target": _tree_rel(outs[device][1], outs["cpu"][1]),
            "log_alpha": _rel_err(outs[device][2], outs["cpu"][2]),
            "stats": max(_rel_err(outs[device][5][k], outs["cpu"][5][k])
                         for k in outs["cpu"][5])}
    if max(errs.values()) > RL_TOL:
        raise AssertionError(f"16b SAC update: {errs}")
    rep["sac_update"] = errs
    return rep


def _d2h_copies(events) -> int:
    return sum(e.count for e in events if "DtoH" in e.key)


def anakin_run(device="cuda", seed=RL_SEED) -> dict:
    """16c: Anakin at bench_rl's full sizes on one replica: 1 warm-up and
    ``ANAKIN_TIMED`` timed ``training_step``s (env-steps/s, ms a step), one
    profiled update (device ms, kernels, busy share) and one profiled
    whole ``training_step`` (its device-to-host copies: at most
    ``ANAKIN_MAX_D2H``); then the learning gate of
    ``test_anakin_learns_cartpole``'s configuration."""
    from torch.profiler import ProfilerActivity

    from ray_tpu_torch.rllib.podracer import AnakinConfig
    from ray_tpu_torch.rllib.podracer.bench_rl import _anakin_config

    cfg = _anakin_config(1, quick=False, device=None if device == "cuda"
                         else device)
    algo = cfg.build()
    if algo.devices[0].type != torch.device(device).type:
        raise AssertionError(f"16c: Anakin on {algo.devices}")
    algo.train()  # warm-up
    _sync(device)
    steps = [algo.train() for _ in range(ANAKIN_TIMED)]
    rep = {"envs": cfg.num_envs_per_device, "unroll": cfg.unroll_length,
           "updates_per_step": cfg.updates_per_step,
           "env_steps_per_s": [s["env_steps_per_s"] for s in steps],
           "ms_per_step": [s["num_env_steps_sampled"]
                           / s["env_steps_per_s"] * 1e3 for s in steps]}
    rep["ms_per_update"] = float(np.mean(rep["ms_per_step"])) \
        / cfg.updates_per_step
    if device == "cuda":
        with kernel_trace(ProfilerActivity.CPU) as prof:
            algo._one_update()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        kernels = [e for e in events if "Memcpy" not in e.key
                   and "Memset" not in e.key]
        device_ms = sum(e.self_device_time_total for e in events) / 1e3
        rep["profiled_update"] = {
            "device_ms": device_ms,
            "kernels": sum(e.count for e in kernels),
            "busy_share": device_ms / rep["ms_per_update"],
            "d2h_copies": _d2h_copies(events),
            "top_kernels_ms": [[e.key[:60], e.self_device_time_total / 1e3]
                               for e in sorted(
                                   kernels, key=lambda e: e.self_device_time_total,
                                   reverse=True)[:5]]}
        with kernel_trace(ProfilerActivity.CPU) as prof:
            algo.train()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        rep["d2h_copies_per_step"] = _d2h_copies(events)
        if not 1 <= rep["d2h_copies_per_step"] <= ANAKIN_MAX_D2H:
            raise AssertionError(
                f"16c: {rep['d2h_copies_per_step']} device-to-host copies "
                f"in one training_step (at most {ANAKIN_MAX_D2H})")
        if rep["profiled_update"]["kernels"] <= 0:
            raise AssertionError("16c: the profiler saw no kernel")
    # The learning gate (tests/test_rllib_podracer.py's configuration on
    # one replica): greedy evaluate above the seeded threshold.
    lc = AnakinConfig()
    lc.num_envs_per_device, lc.unroll_length = 32, 16
    lc.updates_per_step, lc.num_devices = 50, 1
    lc.device = None if device == "cuda" else device
    lc.seed = 0
    learn = lc.build()
    base = learn.evaluate(num_envs=16, seed=3)
    threshold = base + 0.2 * (200.0 - base)
    best, tried = base, 0
    t0 = time.perf_counter()
    for _ in range(6):
        result = learn.train()
        tried += 1
        best = max(best, learn.evaluate(num_envs=16, seed=3))
        if best > threshold:
            break
    if not (np.isfinite(result["loss"]) and best > threshold):
        raise AssertionError(f"16c learning gate: best {best}, threshold "
                             f"{threshold}, random {base}")
    rep["learning"] = {"random_return": base, "threshold": threshold,
                       "best_return": best, "training_steps": tried,
                       "seconds": time.perf_counter() - t0}
    return rep


def _timed_sebulba(device):
    """``Sebulba`` that times each runner's start (spawn to its address)
    and counts the bytes its parameter broadcasts serialize."""
    from ray_tpu_torch.rllib.podracer.sebulba import Sebulba

    class _TimedSebulba(Sebulba):
        def setup(self, config):
            self.runner_start_s, self.broadcast_bytes = {}, 0
            super().setup(config)
            send = self._channel.broadcast

            def counted(*a, **k):
                nbytes = send(*a, **k)
                self.broadcast_bytes += nbytes
                return nbytes

            self._channel.broadcast = counted

        def _make_runner(self, i):
            t0 = time.perf_counter()
            actor = super()._make_runner(i)
            self.runner_start_s.setdefault(i, time.perf_counter() - t0)
            return actor

    return _TimedSebulba


def rl_cluster_phase(device="cuda", init_kwargs=None) -> dict:
    """16d-f under a fresh ``ray_tpu_torch.init(num_cpus=4)``: Anakin
    against the host-loop IMPALA (2 CPU runners, learner on the card);
    Sebulba at bench_rl's sizes, its 2 runners' forwards on a quarter of
    the card each; PPO with 2 CPU runners x 256 steps, learner on the
    card.  Every process it starts is stopped before it returns."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.rllib import PPOConfig
    from ray_tpu_torch.rllib.algorithm import tree_paths
    from ray_tpu_torch.rllib.podracer import bench_rl

    named = None if device == "cuda" else device
    rep = {}
    rt.init(num_cpus=4, **(init_kwargs or {}))
    try:
        if rt.cluster_resources().get("GPU") != 1.0:
            raise AssertionError(f"detected {rt.cluster_resources()}")
        (row,) = bench_rl.bench_anakin_vs_host_loop(quick=False,
                                                    device=named)
        if not row["ratio"] > 1.0:
            raise AssertionError(f"16d: {row}")
        rep["anakin_vs_host_loop"] = row

        cfg = bench_rl.sebulba_config(quick=False, device=named)
        t0 = time.perf_counter()
        algo = _timed_sebulba(device)(cfg)
        build_s = time.perf_counter() - t0
        try:
            info = rt.get([a.describe.remote()
                           for a in algo.runner_group.actors], timeout=120)
            for i in info:
                if not i["forward_device"].startswith(
                        torch.device(device).type):
                    raise AssertionError(f"16e: a runner's forward: {i}")
            if algo.device.type != torch.device(device).type:
                raise AssertionError(f"16e: learner on {algo.device}")
            algo.train()  # warm-up
            bytes0 = algo.broadcast_bytes
            runs = [algo.train() for _ in range(ANAKIN_TIMED)]
            rep["sebulba"] = {
                "runners": info, "build_s": build_s,
                "runner_start_s": algo.runner_start_s,
                "learner_steps_per_s": [r["learner_steps_per_s"]
                                        for r in runs],
                "env_steps": [r["num_env_steps_sampled"] for r in runs],
                "staleness_mean": float(np.mean([r["staleness_mean"]
                                                 for r in runs])),
                "staleness_max": max(r["staleness_max"] for r in runs),
                "broadcast_bytes_per_update": (
                    (algo.broadcast_bytes - bytes0)
                    / sum(r["num_learner_updates"] for r in runs)),
                "loss": runs[-1]["loss"]}
            if not all(np.isfinite(r["loss"]) for r in runs):
                raise AssertionError(f"16e: losses {runs}")
        finally:
            algo.stop()
        wait_card_free(rt)

        ppo = PPOConfig(num_env_runners=2, rollout_steps=256,
                        device=named, seed=RL_SEED).build()
        try:
            lrn = ppo.learner
            upd_ms, inner = [], lrn.update_minibatches

            def timed(batch):
                t = time.perf_counter()
                out = inner(batch)  # its float() stats end on the host
                upd_ms.append((time.perf_counter() - t) * 1e3)
                return out

            lrn.update_minibatches = timed
            iter_s, results = [], []
            for _ in range(PPO_ITERS):
                t = time.perf_counter()
                results.append(ppo.train())
                iter_s.append(time.perf_counter() - t)
            where = {str(x.device) for _, x in tree_paths(
                {"params": lrn.params, "mu": lrn.opt_state["mu"],
                 "nu": lrn.opt_state["nu"]})}
            if not all(np.isfinite(r["total_loss"]) for r in results) or \
                    {torch.device(d).type for d in where} != {
                        torch.device(device).type}:
                raise AssertionError(f"16f: losses {results}, tensors on "
                                     f"{where}")
            rep["ppo"] = {"update_minibatches_ms": upd_ms,
                          "iteration_s": iter_s,
                          "total_loss": [r["total_loss"] for r in results],
                          "episode_return_mean": [
                              r["episode_return_mean"] for r in results],
                          "learner_tensors_on": sorted(where)}
        finally:
            ppo.stop()
    finally:
        rt.shutdown()
    return rep


def rl_phase(device="cuda", init_kwargs=None) -> dict:
    """Phase 16: RLlib's environments and learners on the card (a, b, c in
    this process), then its cluster paths (d, e, f)."""
    rep = {"envs": rl_env_parity(device),
           "learner_parity": rl_learner_parity(device),
           "anakin": anakin_run(device)}
    rep.update(rl_cluster_phase(device, init_kwargs))
    return rep


def report_rl_phase(card: str, rep: dict) -> None:
    """Phase 16's readings: one line of numbers, then the report as JSON."""
    an, host, seb, ppo = (rep["anakin"], rep["anakin_vs_host_loop"],
                          rep["sebulba"], rep["ppo"])
    prof = an.get("profiled_update", {})
    print(f"rllib on {card}: 16c Anakin {np.mean(an['env_steps_per_s']):.1f} "
          f"env-steps/s, {np.mean(an['ms_per_step']):.2f} ms a step of "
          f"{an['updates_per_step']} updates; one update "
          f"{an['ms_per_update']:.3f} ms wall, "
          f"{prof.get('device_ms', float('nan')):.3f} ms device in "
          f"{prof.get('kernels')} kernels (busy share "
          f"{prof.get('busy_share', float('nan')):.3f}), "
          f"{an.get('d2h_copies_per_step')} device-to-host copies a step; "
          f"learned to {an['learning']['best_return']:.1f} (threshold "
          f"{an['learning']['threshold']:.1f}) in "
          f"{an['learning']['training_steps']} steps; 16d ratio "
          f"{host['ratio']} ({host['value']} against {host['baseline']} "
          f"env-steps/s); 16e Sebulba "
          f"{np.mean(seb['learner_steps_per_s']):.2f} learner steps/s, "
          f"staleness {seb['staleness_mean']:.2f}, "
          f"{seb['broadcast_bytes_per_update']:.0f} broadcast bytes an "
          f"update, runner starts {seb['runner_start_s']} s; 16f PPO "
          f"{np.mean(ppo['update_minibatches_ms']):.1f} ms an "
          f"update_minibatches, {np.mean(ppo['iteration_s']):.2f} s an "
          f"iteration", flush=True)
    print("rllib " + json.dumps(rep, default=str), flush=True)

# ----------------------------------------------------------------- phase 17
DREAMER_SEED = SEED + 200
# 17a: card against CPU, each number relative to its leaf's largest
# magnitude.
DREAMER_TOL = 1e-5
DREAMER_TIMED = 10  # timed updates of the trained learner
DREAMER_TRAIN = 6  # train() calls of test_dreamer_world_model_learns_cartpole
# 17b: stage 1 is killed once this many steps have completed; the trainer
# checkpoints every CHAOS_CKPT_EVERY steps.  The trainer's fit notices a
# dead stage when the surviving stage's receive times out, so the receive
# timeout bounds the recovery's start: CHAOS_RECV_S, against 13a's 300 s.
CHAOS_KILL_AFTER, CHAOS_CKPT_EVERY, CHAOS_RECV_S = 3, 2, 10.0


def _dreamer_inputs(hp, env, seed: int):
    """The learner's init from a seeded generator, a seeded batch of
    ``hp.batch_size`` x ``hp.seq_len`` transitions and one update's draws,
    all on the CPU."""
    from ray_tpu_torch.rllib import dreamerv3 as dv
    from ray_tpu_torch.rllib.algorithm import seeded_generator

    probe = env()
    discrete = hasattr(probe, "num_actions")
    act = probe.num_actions if discrete else probe.action_size
    gen = seeded_generator("cpu", seed)
    wm = dv.init_world_model(gen, hp, probe.observation_size, act)
    ac = dv.init_actor_critic(gen, hp, act, discrete)
    rng = np.random.default_rng(seed)
    b, t = hp.batch_size, hp.seq_len
    actions = (np.eye(act, dtype=np.float32)[rng.integers(act, size=(b, t))]
               if discrete else
               rng.uniform(-1, 1, (b, t, act)).astype(np.float32))
    dones = (rng.random((b, t)) < 0.05).astype(np.float32)
    batch = {
        "obs": rng.normal(size=(b, t, probe.observation_size)).astype(
            np.float32),
        "actions": actions,
        "rewards": rng.normal(size=(b, t)).astype(np.float32),
        "dones": dones,
        "is_first": np.concatenate([np.ones((b, 1), np.float32),
                                    dones[:, :-1]], 1),
    }
    noise = {"wm": dv.gumbel((t, b, hp.stoch, hp.classes), gen),
             "ac": dv.ac_noise(hp, discrete, act, b * t, gen)}
    return wm, ac, batch, noise, discrete, act


def dreamer_parity(device="cuda", seed=DREAMER_SEED) -> dict:
    """17a: DreamerV3's update on ``device`` and on the CPU from the same
    params, batch and noise, CartPole and Pendulum, at ``_Hyper``'s
    defaults: the world-model loss, its metrics and every gradient leaf,
    the actor-critic loss, its return statistics and every gradient leaf
    (from the world model after its step), and one whole ``train_once``
    (both clipped Adam steps).  In f64 every number is held at
    ``DREAMER_TOL``; in f32 all but the parameters after Adam, which are
    printed: Adam's first steps divide each gradient by its own magnitude,
    so an element whose gradient is near Adam's eps turns a rounding of
    the gradient into a visible change of its step."""
    from ray_tpu_torch.rllib import CartPole, Pendulum
    from ray_tpu_torch.rllib import dreamerv3 as dv
    from ray_tpu_torch.rllib.algorithm import tree_map, value_and_grad

    hp = dv._Hyper()
    rep = {}
    for name, env in (("cartpole", CartPole), ("pendulum", Pendulum)):
        wm, ac, batch, noise, discrete, act = _dreamer_inputs(hp, env, seed)
        for dtype in (torch.float64, torch.float32):
            out = {}
            for dev in ("cpu", device):
                on = lambda tree: tree_map(  # noqa: E731
                    lambda x: torch.as_tensor(x).to(dev, dtype), tree)
                w, a, b, nz = on(wm), on(ac), on(batch), on(noise)
                wm_tx, ac_tx = dv.ClippedAdam(hp.wm_lr), dv.ClippedAdam(
                    hp.ac_lr)
                wl, (feat, met), wg = value_and_grad(
                    dv.make_wm_loss(hp), w, b, None, nz["wm"])
                w_next, _ = wm_tx.step(w, wg, wm_tx.init(w))
                _, _, update = dv.make_ac_update(hp, discrete, act)
                al, ag, ret_mean, new_std = update(
                    w_next, a, feat.reshape(-1, feat.shape[-1]).detach(),
                    1.0, noise=nz["ac"])
                train_once = dv.make_train_once(hp, discrete, act, wm_tx,
                                                ac_tx)
                tw, ta, _, _, t_std, t_met = train_once(
                    w, a, wm_tx.init(w), ac_tx.init(a), b, 1.0, None, nz)
                out[dev] = {"wm_loss": wl, "metrics": met, "wm_grads": wg,
                            "ac_loss": al, "ac_grads": ag,
                            "ret": (ret_mean, new_std), "wm_after": tw,
                            "ac_after": ta, "once": (t_std, t_met)}
            c, g = out["cpu"], out[device]
            errs = {
                "wm_loss": _rel_err(g["wm_loss"], c["wm_loss"]),
                "wm_metrics": max(_rel_err(g["metrics"][k], c["metrics"][k])
                                  for k in c["metrics"]),
                "wm_grads": _tree_rel(g["wm_grads"], c["wm_grads"]),
                "ac_loss": _rel_err(g["ac_loss"], c["ac_loss"]),
                "ac_returns": max(_rel_err(x, y)
                                  for x, y in zip(g["ret"], c["ret"])),
                "ac_grads": _tree_rel(g["ac_grads"], c["ac_grads"]),
                "train_once_metrics": max(
                    [_rel_err(g["once"][0], c["once"][0])]
                    + [_rel_err(g["once"][1][k], c["once"][1][k])
                       for k in c["once"][1]]),
                "wm_params": _tree_rel(g["wm_after"], c["wm_after"]),
                "ac_params": _tree_rel(g["ac_after"], c["ac_after"]),
            }
            gated = {k: v for k, v in errs.items()
                     if dtype == torch.float64 or not k.endswith("_params")}
            if not max(gated.values()) <= DREAMER_TOL:
                raise AssertionError(f"17a {name} {dtype}: {errs} (tolerance "
                                     f"{DREAMER_TOL} on {sorted(gated)})")
            rep[f"{name} {str(dtype)[6:]}"] = errs
    return rep


def dreamer_train(rt, device="cuda") -> dict:
    """17a: ``test_dreamer_world_model_learns_cartpole``'s configuration
    with its learner on ``device``: ``DREAMER_TRAIN`` ``train()`` calls
    (the world-model loss finite and falling, ``imag_return`` finite,
    every learner tensor on ``device``), then ``DREAMER_TIMED`` timed
    updates as ``training_step`` makes them (a sampled batch to the card,
    ``train_once``, the read of the return spread) and one profiled
    (kernels, device ms, busy share, device-to-host copies: exactly one)."""
    from torch.profiler import ProfilerActivity

    from ray_tpu_torch.rllib import CartPole, DreamerV3Config
    from ray_tpu_torch.rllib.algorithm import to_tensors, tree_paths

    algo = (DreamerV3Config().environment(CartPole)
            .env_runners(1, rollout_steps=128).debugging(seed=7)
            .training(min_buffer=256, train_ratio=4, batch_size=8,
                      seq_len=12,
                      device=None if device == "cuda" else device)
            .build())
    try:
        hp = algo.hp
        results, train_s = [], []
        for _ in range(DREAMER_TRAIN):
            t0 = time.perf_counter()
            results.append(algo.train())
            train_s.append(time.perf_counter() - t0)
        losses = [r["wm_loss"] for r in results if "wm_loss" in r]
        where = {x.device.type for tree in (
            algo.wm, algo.ac, algo.wm_opt["mu"], algo.wm_opt["nu"],
            algo.ac_opt["mu"], algo.ac_opt["nu"]) for _, x in tree_paths(tree)}
        last = results[-1]
        if (len(losses) < 4 or not all(np.isfinite(losses))
                or not losses[-1] < losses[0]
                or not np.isfinite(last["imag_return"])
                or where != {torch.device(device).type}):
            raise AssertionError(f"17a: world-model losses {losses}, last "
                                 f"result {last}, tensors on {where}")

        def update():
            batch = to_tensors(algo.buffer.sample(hp.batch_size, hp.seq_len),
                               algo.device)
            (algo.wm, algo.ac, algo.wm_opt, algo.ac_opt, new_std,
             _) = algo._train_once(algo.wm, algo.ac, algo.wm_opt,
                                   algo.ac_opt, batch, algo.ret_std,
                                   algo._gen)
            algo.ret_std = 0.99 * algo.ret_std + 0.01 * float(new_std)

        for _ in range(2):
            update()
        update_ms = []
        for _ in range(DREAMER_TIMED):
            _sync(device)
            t0 = time.perf_counter()
            update()
            update_ms.append((time.perf_counter() - t0) * 1e3)
        rep = {"wm_losses": losses, "imag_return": last["imag_return"],
               "episode_return_mean": [r["episode_return_mean"]
                                       for r in results],
               "train_s": train_s, "update_ms": update_ms,
               "update_ms_median": float(np.median(update_ms)),
               "learner_tensors_on": sorted(where)}
        if torch.device(device).type == "cuda":
            with kernel_trace(ProfilerActivity.CPU) as prof:
                update()
            events = [e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA]
            kernels = [e for e in events if "Memcpy" not in e.key
                       and "Memset" not in e.key]
            device_ms = sum(e.self_device_time_total for e in events) / 1e3
            rep["profiled_update"] = {
                "kernels": sum(e.count for e in kernels),
                "device_ms": device_ms,
                "busy_share": device_ms / rep["update_ms_median"],
                "d2h_copies": _d2h_copies(events),
                "top_kernels_ms": [
                    [e.key[:60], e.self_device_time_total / 1e3]
                    for e in sorted(kernels,
                                    key=lambda e: e.self_device_time_total,
                                    reverse=True)[:5]]}
            if rep["profiled_update"]["d2h_copies"] != 1 or \
                    rep["profiled_update"]["kernels"] <= 0:
                raise AssertionError(f"17a: {rep['profiled_update']} (one "
                                     "device-to-host copy an update)")
        return rep
    finally:
        algo.stop()


class _ChaosPipelinedTrainer(_CountedPipelinedTrainer):
    """13a's counted trainer that logs every completed step (re-runs
    included) with its time, kills stage 1 through
    ``devtools.chaos.KilledStageActor`` once ``CHAOS_KILL_AFTER`` steps
    have completed (and waits until the stage no longer answers, so the
    next step meets a dead stage), and notes each stage spawn."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.step_log, self.spawns = [], []
        self.kill_at, self.killed = None, None

    def _spawn_stage(self, i: int):
        self.spawns.append({"stage": i, "at": time.time(),
                            "restarts": self._restarts})
        return super()._spawn_stage(i)

    def _record_step_metrics(self, stats):
        import ray_tpu_torch as rt
        from ray_tpu_torch.devtools import chaos

        bubble = super()._record_step_metrics(stats)
        losses = stats[-1].get("losses") or []
        self.step_log.append({"step": stats[0]["step"],
                              "loss": sum(losses) / len(losses),
                              "at": time.perf_counter(),
                              "restarts": self._restarts})
        if self.kill_at is None and len(self.step_log) == CHAOS_KILL_AFTER:
            victim = self.stages[1]
            self.killed = rt.get(victim.report.remote((1, 1, 1)),
                                 timeout=120)
            self.kill_at = time.perf_counter()
            chaos.KilledStageActor(self, stage=1).apply()
            deadline = time.monotonic() + 60
            while True:
                try:
                    rt.get(victim.ping.remote(), timeout=5)
                except Exception:  # noqa: BLE001 — the kill landed
                    break
                if time.monotonic() > deadline:
                    raise AssertionError("17b: stage 1 still answers 60 s "
                                         "after its kill")
                time.sleep(0.1)
        return bubble


def pipeline_chaos(rt, cfg, batch: int, seq: int, micro: int, steps: int,
                   stage_resources: dict, device, reference=None) -> dict:
    """17b: 13a's pipelined run with stage 1 killed after
    ``CHAOS_KILL_AFTER`` steps; the trainer recovers it by itself from its
    last checkpoint.  One restart; the new stage process's lease and
    launches; every completed step's loss, re-runs included, against
    ``reference`` (13a's sequential losses; run here when not given)."""
    from ray_tpu_torch.train import PipelineConfig, RunConfig
    from ray_tpu_torch.train.config import FailureConfig

    data = _pipe_data(cfg.vocab_size, batch, seq, PIPE_SEED)
    builder = train_pipeline.gpt2_stage_modules(cfg, 2, seed=PIPE_SEED)
    if reference is None:
        ref, _ = train_pipeline.reference_run(
            builder, 2, data, steps, num_microbatches=micro,
            learning_rate=PIPE_LR, device=device)
        reference = list(ref)
        _sync(device)
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    wait_card_free(rt)
    tr = _ChaosPipelinedTrainer(
        builder,
        pipeline_config=PipelineConfig(
            num_stages=2, num_microbatches=micro,
            recv_timeout_s=CHAOS_RECV_S,
            checkpoint_every_n_steps=CHAOS_CKPT_EVERY),
        data_per_step=data, num_steps=steps, learning_rate=PIPE_LR,
        run_config=RunConfig(failure_config=FailureConfig(max_failures=1)),
        resources_per_stage=stage_resources)
    try:
        t0 = time.perf_counter()
        res = tr.fit()
        fit_s = time.perf_counter() - t0
        if res.error is not None:
            raise AssertionError(f"17b: fit failed: {res.error!r}")
        stages = rt.get([s.report.remote((1, 1, 1)) for s in tr.stages],
                        timeout=300)
    finally:
        tr.shutdown()
    log, new = tr.step_log, stages[1]
    after = [e for e in log if e["at"] > tr.kill_at]
    errs = [_rel(e["loss"], reference[e["step"]]) for e in log]
    per_step = {k: (cfg.n_layer // 2) * micro * n
                for k, n in (("flash_fwd", 2), ("flash_dq", 1),
                             ("flash_dkv", 1))}
    want = {k: v * len(after) for k, v in per_step.items()}
    respawn = [s for s in tr.spawns if s["restarts"] > 0]
    final = [m["loss"] for m in res.metrics_history]
    problems = []
    if tr._restarts != 1 or len(respawn) != 1 or respawn[0]["stage"] != 1:
        problems.append(f"restarts {tr._restarts}, spawns {tr.spawns}")
    if new["pid"] == tr.killed["pid"]:
        problems.append(f"stage 1 is still pid {new['pid']}")
    if "GPU" in stage_resources and new["visible"] != "0":
        problems.append(f"the new stage's lease {new['visible']!r}")
    if new["launches"] != want or not all(new["launches"].values()):
        problems.append(f"the new stage launched {new['launches']}, want "
                        f"{want} ({len(after)} steps)")
    if len(final) != steps or not all(np.isfinite([e["loss"] for e in log])):
        problems.append(f"final losses {final}, log {log}")
    if max(errs) > PIPE_TOL:
        problems.append(f"losses {[(e['step'], e['loss']) for e in log]} "
                        f"against {reference}: {errs} (tolerance "
                        f"{PIPE_TOL})")
    if problems:
        raise AssertionError(f"17b: {problems}")
    return {
        "steps_completed": [e["step"] for e in log],
        "losses": [e["loss"] for e in log], "reference": reference,
        "rel_err": errs, "restarts": tr._restarts, "fit_s": fit_s,
        "kill_to_next_step_s": after[0]["at"] - tr.kill_at,
        "respawn_to_constructor_s": new["started_at"] - respawn[0]["at"],
        "killed_pid": tr.killed["pid"], "new_pid": new["pid"],
        "new_stage_visible": new["visible"],
        "new_stage_launches": new["launches"],
        "launches_per_step": per_step, "steps_on_new_stage": len(after),
        "stage0_launches": stages[0]["launches"]}


def dreamer_chaos_phase(device="cuda", cfg=None, pipe_shape=None,
                        stage_resources=None, reference=None,
                        init_kwargs=None) -> dict:
    """Phase 17: 17a's parity here, then 17a's training and 17b under a
    fresh ``ray_tpu_torch.init(num_cpus=4)``.  Every process it starts is
    stopped before it returns."""
    import ray_tpu_torch as rt

    cfg = cfg or GPT2Config.small(dtype="bfloat16", attention="flash")
    batch, seq, micro, steps = pipe_shape or (PIPE_BATCH, cfg.max_seq,
                                              PIPE_MICRO, PIPE_STEPS)
    os.environ["PYTHONPATH"] = os.pathsep.join(
        p for p in (HERE, os.environ.get("PYTHONPATH")) if p)
    t0 = time.perf_counter()
    rep = {"dreamer_parity": dreamer_parity(device)}
    rt.init(num_cpus=4, **(init_kwargs or {}))
    try:
        rep["dreamer"] = dreamer_train(rt, device)
        rep["dreamer_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rep["pipeline_chaos"] = pipeline_chaos(
            rt, cfg, batch, seq, micro, steps,
            stage_resources or {"CPU": 1.0, "GPU": 0.5}, device, reference)
        wait_card_free(rt)
        rep["pipeline_chaos_s"] = time.perf_counter() - t0
    finally:
        rt.shutdown()
    return rep


def report_dreamer_chaos_phase(card: str, rep: dict) -> None:
    """Phase 17's readings: one line of numbers, then the report as JSON."""
    d, pc = rep["dreamer"], rep["pipeline_chaos"]
    prof = d.get("profiled_update", {})
    f32_params = max(max(v["wm_params"], v["ac_params"])
                     for k, v in rep["dreamer_parity"].items()
                     if k.endswith("float32"))
    gated = max(v for k, e in rep["dreamer_parity"].items()
                for n, v in e.items()
                if k.endswith("float64") or not n.endswith("_params"))
    print(f"dreamer/chaos on {card}: 17a card against CPU within "
          f"{gated:.2e} (f32 parameters after Adam {f32_params:.2e}); "
          f"world-model loss {d['wm_losses'][0]:.3f} -> "
          f"{d['wm_losses'][-1]:.3f}; an update {d['update_ms_median']:.3f} "
          f"ms (median of {DREAMER_TIMED}), "
          f"{prof.get('device_ms', float('nan')):.3f} ms device in "
          f"{prof.get('kernels')} kernels (busy share "
          f"{prof.get('busy_share', float('nan')):.3f}), "
          f"{prof.get('d2h_copies')} device-to-host copy; s a train() "
          f"{[round(s, 2) for s in d['train_s']]}; 17b stage 1 (pid "
          f"{pc['killed_pid']}) killed after {CHAOS_KILL_AFTER} steps, "
          f"{pc['restarts']} restart, next step "
          f"{pc['kill_to_next_step_s']:.2f} s after the kill, respawn to "
          f"the new stage's constructor {pc['respawn_to_constructor_s']:.2f}"
          f" s; steps {pc['steps_completed']} within "
          f"{max(pc['rel_err']):.2e} of the sequential run; new stage "
          f"(pid {pc['new_pid']}, CUDA_VISIBLE_DEVICES="
          f"{pc['new_stage_visible']!r}) launched {pc['new_stage_launches']}"
          f" over {pc['steps_on_new_stage']} steps ({pc['launches_per_step']}"
          f" a step)", flush=True)
    print("dreamer_chaos " + json.dumps(rep, default=str), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # plain f32 stays f32
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    phase_s, last = {}, [t_start]

    def lap(phase: int):
        now = time.perf_counter()
        phase_s[phase] = round(now - last[0], 1)
        last[0] = now

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

    lap(1)
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
    # ViT-B/16's attention (phase 15a): B=32 x S=197 (no multiple of the
    # 64-row tile) x H=12 x D=64, not causal, forward and backward.
    flash_vit = check_flash(gen, 197, False, h=12, b=32, timed=True)
    check_flash(gen, 197, False, h=12, b=32, **f32)
    bwd_vit = check_flash_bwd(gen, 32, 12, 197, False, timed=True)
    bwd_runs += [bwd_vit,
                 check_flash_bwd(gen, 32, 12, 197, False, torch.float32)]
    print("phase2 " + json.dumps({"decode": dec, "decode_gpt2": dec_gpt2,
                                  "decode_buckets": dec_buckets,
                                  "flash": flash_runs,
                                  "flash_train_shape": flash_train,
                                  "flash_vit_shape": flash_vit,
                                  "flash_d128": flash_d128,
                                  "flash_bwd": bwd_runs}), flush=True)

    lap(2)
    # Phase 3: serving at full width.
    llama = serve(LlamaConfig.tinyllama_1b(), 8, 2048,
                  make_prompts(12, 100, 1500, SEED), 64, stagger=4,
                  profile_steps=10)
    print("serve tinyllama_1b " + json.dumps(llama), flush=True)
    main_launches = llama["launches"]
    gpt2 = serve(GPT2Config.small(), 8, 1024,
                 make_prompts(12, 100, 800, SEED + 1), 64, stagger=4)
    print("serve gpt2_small " + json.dumps(gpt2), flush=True)

    lap(3)
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

    lap(4)
    # Phase 5: training at full width (this slice's path).
    train_rep = train(GPT2Config.small(dtype="bfloat16", attention="flash",
                                       remat=True), 32, 1024, 3, 10)
    print("train gpt2_small " + json.dumps(train_rep), flush=True)
    train_launches = train_rep["launches"]

    lap(5)
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

    lap(6)
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

    lap(7)
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

    lap(8)
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

    lap(9)
    # Phase 10: the Data layer and batch inference, each engine in a
    # GPU-leased data actor.
    dp = data_phase()
    report_data_phase(card, dp)
    c1, c2 = dp["counted"]["n=1"], dp["counted"]["n=2"]

    lap(10)
    # Phase 11: the collective layer and Train, the training step in a
    # TorchTrainer worker that leases the card.
    tp = train_phase(GPT2Config.small(dtype="bfloat16", attention="flash",
                                      remat=True), 32, 1024, 3, 5)
    report_train_phase(card, tp, train_rep)
    worker_launches = dict(zip(("flash_fwd", "flash_dq", "flash_dkv"),
                               tp["trainer"]["launches"]))
    dp_ranks = tp["data_parallel"]["launches_by_rank"]

    lap(11)
    # Phase 12: compiled DAGs, Tune, a job, the CLI and the dashboard, each
    # kernel launched from a DAG stage, a trial's train worker or a job's
    # task.
    gp = dag_tune_phase()
    report_dag_tune_phase(card, gp, tp)
    dag_launches = gp["dag"]["launches"]
    tune_launches = {lr: dict(zip(("flash_fwd", "flash_dq", "flash_dkv"),
                                  t["launches"]))
                     for lr, t in gp["tune"]["trials"].items()}
    job_launches = gp["job"]["launches"]
    lap(12)
    # Phase 13: the pipeline-parallel trainer, each stage a half-card actor,
    # and the autoscaler, its task on a GPU node launched on demand.
    pa = pipeline_autoscale_phase()
    report_pipeline_autoscale_phase(card, pa, train_rep)
    pipe_launches = pa["pipeline"]["launches"]
    task_launches = pa["autoscale"]["task"]["launches"]
    lap(13)
    # Phase 14: parallel/ on the card: ring and Ulysses over 4 ranks on
    # cuda:0, and GPT-2 small trained through the sharded path.
    pp = parallel_phase()
    report_parallel_phase(card, pp, train_rep)
    sp_launches = {k: pp["seq_parallel"][k]["launches"]
                   for k in ("ring", "ulysses")}
    sharded_launches = pp["sharded_train"]["sharded"]["launches"]
    lap(14)
    # Phase 15: the vision models and the MoE LM: ViT-B/16 served in
    # batches from a replica leasing the card, ResNet-50 in a TorchTrainer
    # worker, then the MoE LM's train step here and its parity.
    from ray_tpu_torch.models import MoEConfig

    vm = vision_moe_phase()
    vm["moe"] = moe_train(MoEConfig(attention="flash"), MOE_SHAPE)
    vm["moe_parity"] = {}
    for dtype in ("float32", "bfloat16"):
        vm["moe_parity"][dtype] = train_parity(
            MoEConfig(n_layer=2, dtype=dtype, attention="flash"), 2, 1024,
            fam=_moe_family())
    report_vision_moe_phase(card, vm)
    vit_launches = vm["vit"]["launches"]
    moe_launches = vm["moe"]["launches"]
    lap(15)
    # Phase 16: RLlib's learners and Anakin on the card, Sebulba's runners
    # forwarding on card shares, PPO's learner on the card.  None of the
    # four kernels is on this path.
    rl = rl_phase()
    report_rl_phase(card, rl)
    lap(16)
    # Phase 17: DreamerV3's learner on the card, then 13a's pipelined run
    # with a stage killed and recovered (the flash kernels launched in the
    # respawned stage).
    dc = dreamer_chaos_phase(
        reference=pa["pipeline"]["sequential"]["losses"])
    report_dreamer_chaos_phase(card, dc)
    chaos_launches = dc["pipeline_chaos"]["new_stage_launches"]
    lap(17)

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
         # Phase 12: in 12c's job task.
         "launches_job": job_launches["decode_attention"],
         # Phase 13: in 13b's task on the autoscaled node.
         "launches_autoscaled_task": task_launches["decode_attention"],
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
         # Phase 11: in the TorchTrainer worker (11b), and in each of
         # 11d's two half-card ranks.
         "launches_train_worker": worker_launches["flash_fwd"],
         "launches_dp_ranks": [int(r[0]) for r in dp_ranks],
         "launches_cb": cb["launches"]["flash_fwd"],
         "launches_runtime_actor": actor_launches["flash_fwd"],
         # Phase 9: the OpenAI app's replica, and the prefill actor.
         "launches_serve_app": oa["launches"]["flash_fwd"],
         "launches_disagg_actor": ar["launches"]["flash_fwd_prefill_actor"],
         # Phase 10: the prompts 10b's data actors prefilled.
         "launches_data_n1": c1["launches"]["flash_fwd"],
         "launches_data_n2": c2["launches"]["flash_fwd"],
         # Phase 12: in 12a's two DAG stages, 12b's trial workers (by
         # learning rate) and 12c's job task.
         "launches_dag": dag_launches,
         "launches_tune": {lr: t["flash_fwd"]
                           for lr, t in tune_launches.items()},
         "launches_job": job_launches["flash_fwd"],
         # Phase 13: in 13a's two stage actors, and 13b's autoscaled task.
         "launches_pipeline": [s["flash_fwd"] for s in pipe_launches],
         # Phase 17: in 17b's respawned stage 1.
         "launches_respawned_stage": chaos_launches["flash_fwd"],
         "launches_autoscaled_task": task_launches["flash_fwd"],
         # Phase 14: one kernel-route call of 14a's ring and of its
         # Ulysses, and 14b's sharded steps.
         "launches_ring": sp_launches["ring"]["flash_fwd"],
         "launches_ulysses": sp_launches["ulysses"]["flash_fwd"],
         "launches_sharded_train": sharded_launches["flash_fwd"],
         # Phase 15: 15a's bf16 replica (12 a batch), 15c's MoE steps.
         "launches_vit_serve": vit_launches,
         "launches_moe_train": moe_launches["flash_fwd"],
         "max_abs_err": flash_main["max_abs_err"],
         "ms": flash_main["ms"], "plain_ms": flash_main["plain_ms"],
         "bound_ms": flash_main["bound_ms"],
         "bound_by": flash_main["bound_by"],
         "library_ms": flash_main["library_ms"],
         "event_ms": flash_main["event_ms"],
         "train_shape": {k: flash_train[k] for k in (
             "ms", "event_ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms", "max_abs_err")},
         "vit_shape": {k: flash_vit[k] for k in (
             "ms", "event_ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms", "max_abs_err")}},
    ]
    for i, (name, key, line, design) in enumerate((
            ("flash_dq", "dq", 144, "wgmma+tma"),
            ("flash_dkv", "dkv", 191, "wgmma+tma")), start=1):
        rec = bwd_train[key]
        errs = [bwd_train["max_abs_err"][g]
                for g in (("dq",) if key == "dq" else ("dk", "dv"))]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "ray_tpu_torch/csrc/flash_bwd.cu",
            "replaces": f"ray_tpu/ops/attention.py:{line}", "design": design,
            "launches": train_launches[name],
            "launches_train_worker": worker_launches[name],
            "launches_dp_ranks": [int(r[i]) for r in dp_ranks],
            "launches_tune": {lr: t[name] for lr, t in tune_launches.items()},
            "launches_pipeline": [s[name] for s in pipe_launches],
            "launches_respawned_stage": chaos_launches[name],
            "launches_ring": sp_launches["ring"][name],
            "launches_ulysses": sp_launches["ulysses"][name],
            "launches_sharded_train": sharded_launches[name],
            "launches_moe_train": moe_launches[name],
            "max_abs_err": max(errs),
            "ms": rec["ms"], "event_ms": rec["event_ms"],
            "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": bwd_train["library_ms"],
            "library": f"one SDPA backward (dq, dk, dv): "
                       f"{bwd_train['library_backend']}",
            "vit_shape": {
                "ms": bwd_vit[key]["ms"], "event_ms": bwd_vit[key]["event_ms"],
                "plain_ms": bwd_vit[key]["plain_ms"],
                "bound_ms": bwd_vit[key]["bound_ms"],
                "bound_by": bwd_vit[key]["bound_by"],
                "library_ms": bwd_vit["library_ms"],
                "max_abs_err": max(bwd_vit["max_abs_err"][g] for g in (
                    ("dq",) if key == "dq" else ("dk", "dv")))}})
    print(f"seconds by phase {json.dumps(phase_s)}", flush=True)
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

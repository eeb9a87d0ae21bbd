"""Scaling-efficiency harness: step-time curve over growing meshes — port
of ``ray_tpu/parallel/scaling_bench.py``.

Each device count is a world of that many processes
(``parallel.launch``): one NCCL process a card by default, as the JAX
harness runs on the chips, or, when the caller asks for the CPU, gloo
processes, where the retention reflects the partitioning overhead (the
collectives and reshards the sharded step adds, and per-rank dispatch)
rather than a fabric's bandwidth.  Also checks ring/Ulysses
sequence-parallel attention against the dense baseline for numerical
parity.

Run standalone (JSON lines on stdout):

    python -m ray_tpu_torch.parallel.scaling_bench [--device cpu]
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Sequence

import torch


def _optimizer(params):
    """optax.adamw(1e-3)'s defaults, spelled out, on the local shards."""
    from .spmd import LocalShardOptimizer

    return LocalShardOptimizer(params.parameters(), torch.optim.AdamW,
                               lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                               weight_decay=1e-4)


WORLD_TIMEOUT_S = 600.0  # one world's deadline (``run_world``)


def _build_step(cfg, mesh, device):
    from ..models import gpt2_init, gpt2_loss, gpt2_param_axes
    from .sharding import shard_pytree

    params = gpt2_init(torch.Generator(device).manual_seed(0), cfg,
                       device=device)
    if mesh is not None:
        params = shard_pytree(params, gpt2_param_axes(), mesh)
    params.requires_grad_(True)
    opt = _optimizer(params)

    def train_step(tokens):
        loss = gpt2_loss(params, tokens, cfg, mesh)
        loss.backward()
        opt.step()
        opt.zero_grad()
        return loss.detach()

    return train_step


def _world(device, counts: Sequence[int]):
    """(backend, counts that fit): a world per count on the cards, or on
    the CPU's cores when ``device`` is the CPU."""
    from ..device import resolve_device

    if resolve_device(device).type == "cpu":
        return "gloo", [n for n in counts if n <= (os.cpu_count() or 1)]
    return "nccl", [n for n in counts if n <= torch.cuda.device_count()]


def _time_step(step, tokens, n_steps: int) -> float:
    """Mean seconds/step after two warm-up steps, ending in a host sync."""
    for _ in range(2):
        float(step(tokens))
    t0 = time.perf_counter()
    for _ in range(n_steps):
        loss = step(tokens)
    float(loss)
    return (time.perf_counter() - t0) / n_steps


def _mesh_for(n: int, seq_parallel: bool):
    from .mesh import MeshConfig, build_mesh

    if seq_parallel and n >= 2:
        cfg = MeshConfig(data=1, fsdp=n // 2, seq=2, model=1)
    else:
        cfg = MeshConfig(data=1, fsdp=n, seq=1, model=1)
    return build_mesh(cfg)


def _curve_cfg(seq_len: int):
    from ..models import GPT2Config

    return GPT2Config(
        vocab_size=512, max_seq=seq_len, n_layer=4, n_head=8,
        d_model=256, dtype="float32", attention="dense",
    )


def _curve_point(n: int, n_steps: int, batch_per_device: int,
                 seq_len: int) -> Dict:
    """One rank of the world of ``n``: the partitioned step on the n-rank
    mesh; then rank 0 alone runs the same global batch unpartitioned."""
    import torch.distributed as dist

    from .launch import rank_device

    device = rank_device()
    cfg = _curve_cfg(seq_len)
    batch = batch_per_device * n
    tokens = torch.zeros((batch, seq_len + 1), dtype=torch.int64,
                         device=device)
    step = _build_step(cfg, _mesh_for(n, seq_parallel=False), device)
    dt = _time_step(step, tokens, n_steps)
    dist.barrier()
    if dist.get_rank() != 0:
        return {}
    dt_ref = _time_step(_build_step(cfg, None, device), tokens, n_steps)
    return {"step_time_s": dt, "step_time_unpartitioned_s": dt_ref}


def run_scaling_curve(
    device_counts: Sequence[int] = (1, 2, 4, 8),
    n_steps: int = 8,
    batch_per_device: int = 2,
    seq_len: int = 128,
    device=None,
) -> List[Dict]:
    """Weak-scaling partition retention across mesh sizes (fsdp axis), on
    the cards unless ``device`` is the CPU; counts beyond the cards (or
    the CPU's cores) are left out, as the JAX harness leaves out counts
    beyond its devices.

    METHODOLOGY (the JAX harness's, one definition): per-rank batch is
    FIXED at ``batch_per_device`` (weak scaling).  For each mesh size n
    the same global batch (n * batch_per_device) also runs UNPARTITIONED
    on one rank — identical total compute, zero partitioning — and

        retention(n) = t_unpartitioned(n) / t_partitioned(n)

    clipped at 1.0: 1.0 means the sharding machinery is free.
    """
    from .launch import run_world

    backend, counts = _world(device, device_counts)
    out: List[Dict] = []
    for n in counts:
        row = run_world("ray_tpu_torch.parallel.scaling_bench:_curve_point",
                        n, args=(n, n_steps, batch_per_device, seq_len),
                        timeout=WORLD_TIMEOUT_S, backend=backend)[0]
        dt, dt_ref = row["step_time_s"], row["step_time_unpartitioned_s"]
        retention = round(min(dt_ref / dt, 1.0), 4)
        # The interconnect gauge takes card figures only: a CPU world's
        # retention is dispatch overhead, not a fabric's.
        try:
            if backend == "nccl":
                from ..util import flight_recorder

                flight_recorder.record_scaling_efficiency(n, retention)
        except Exception:  # noqa: BLE001 — bench must not die on telemetry
            pass
        out.append({
            "devices": n,
            "step_time_s": round(dt, 6),
            "step_time_unpartitioned_s": round(dt_ref, 6),
            "tokens_per_sec_per_device": round(
                batch_per_device * n * seq_len / dt / n, 1),
            "retention": retention,
        })
    return out


def _sp_losses(n: int, seq_len: int) -> Dict[str, float]:
    """One rank: the dense, ring and Ulysses losses on the same params and
    tokens (dense over an fsdp mesh, the other two over seq=2).  On the
    cards the ring runs the flash kernels, which take head dims of 64 or
    128, so there the 8 heads of 16 become 2 heads of 64."""
    import dataclasses

    from ..models import gpt2_init, gpt2_loss, gpt2_param_axes
    from ..models import GPT2Config
    from .launch import rank_device
    from .sharding import shard_pytree

    device = rank_device()
    base = GPT2Config(vocab_size=512, max_seq=seq_len, n_layer=2,
                      n_head=8 if device.type == "cpu" else 2,
                      d_model=128, dtype="float32", attention="dense")
    tokens = torch.randint(0, base.vocab_size, (4, seq_len + 1),
                           generator=torch.Generator().manual_seed(7))
    tokens = tokens.to(device)
    params = gpt2_init(torch.Generator(device).manual_seed(0), base,
                       device=device)
    losses = {}
    for attention in ("dense", "ring", "ulysses"):
        cfg = dataclasses.replace(base, attention=attention)
        mesh = _mesh_for(n, seq_parallel=(attention != "dense"))
        sharded = shard_pytree(params, gpt2_param_axes(), mesh)
        with torch.no_grad():
            losses[attention] = float(gpt2_loss(sharded, tokens, cfg, mesh))
    return losses


def run_sp_parity(seq_len: int = 128, device=None) -> Dict:
    """Ring vs Ulysses vs dense: same loss on the same sharded inputs, on
    the cards unless ``device`` is the CPU."""
    from .launch import run_world

    backend, counts = _world(device, (2, 4))
    if not counts:
        return {"skipped": "needs >=2 devices"}
    n = counts[-1]
    losses = run_world("ray_tpu_torch.parallel.scaling_bench:_sp_losses", n,
                       args=(n, seq_len), timeout=WORLD_TIMEOUT_S,
                       backend=backend)[0]
    dense = losses["dense"]
    return {
        "losses": {k: round(v, 6) for k, v in losses.items()},
        "ring_matches_dense": abs(losses["ring"] - dense) < 1e-3,
        "ulysses_matches_dense": abs(losses["ulysses"] - dense) < 1e-3,
    }


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cpu for gloo processes (default: one process a "
                         "card)")
    device = ap.parse_args(argv).device
    curve = run_scaling_curve(device=device)
    for row in curve:
        print(json.dumps({"scaling": row}), flush=True)
    if len(curve) > 1:
        print(
            json.dumps(
                {
                    "scaling_summary": {
                        "max_devices": curve[-1]["devices"],
                        "retention_at_max": curve[-1]["retention"],
                    }
                }
            ),
            flush=True,
        )
    print(json.dumps({"sp_parity": run_sp_parity(device=device)}),
          flush=True)


if __name__ == "__main__":
    main()

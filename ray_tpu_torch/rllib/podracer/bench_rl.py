"""Podracer throughput stages, on the card.

``python -m ray_tpu_torch.rllib.podracer.bench_rl [--quick] [--device
cpu]``; each stage prints one ``{"rl": {...}}`` JSON line, the JAX
bench's rows key for key.  The learners and Anakin run on the card
unless ``--device`` names another device (the CPU tests pass ``cpu``);
Sebulba's runners then lease a quarter of the card each for their
batched forwards.

Stages:

- ``rl_anakin_env_steps_per_s`` across 1→2→4→8 devices (the cards
  present; on a named device, that many replicas of it; rate measured
  post-warmup) plus the widest width's scaling efficiency vs linear;
- ``rl_anakin_vs_host_loop`` — Anakin against the host-loop IMPALA
  (Python envs in runner actors, learner on the driver), both measured
  as end-to-end env-steps/s in ONE interleaved window (this box swings
  ~2x window-to-window, so A and B alternate within the same window and
  the ratio is trustworthy even when the absolute rates are not);
- ``rl_sebulba_learner_steps_per_s`` — Sebulba learner updates/s with
  env throughput and mean staleness alongside.

``--quick`` shrinks everything to a smoke (1 device, tiny unrolls) —
that's the path tier-1 pins via tests/test_torch_rllib_podracer.py.
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict, List


def _emit(row: Dict[str, Any]) -> Dict[str, Any]:
    print(json.dumps({"rl": row}), flush=True)
    return row


def _anakin_config(num_devices: int, quick: bool, device=None):
    from .anakin import AnakinConfig

    cfg = AnakinConfig()
    cfg.num_devices = num_devices
    cfg.device = device
    cfg.num_envs_per_device = 16 if quick else 64
    cfg.unroll_length = 8 if quick else 16
    cfg.updates_per_step = 4 if quick else 20
    cfg.seed = 0
    return cfg


def _anakin_rate(algo, trials: int) -> float:
    """Mean post-warmup env-steps/s over ``trials`` training_steps."""
    rates = []
    for _ in range(trials):
        rates.append(algo.train()["env_steps_per_s"])
    return float(sum(rates) / len(rates))


def _widths(quick: bool, device) -> List[int]:
    """1, 2, 4, 8 (1 with ``quick``): on the cards, those the host has."""
    import torch

    widths = [1] if quick else [1, 2, 4, 8]
    if device is None:
        widths = [w for w in widths if w <= torch.cuda.device_count()]
    return widths


def bench_anakin_scaling(quick: bool = False,
                         device=None) -> List[Dict[str, Any]]:
    """Anakin env-step throughput at 1, 2, 4, 8 devices."""
    widths = _widths(quick, device)
    trials = 2 if quick else 3
    rows = []
    rates = {}
    for d in widths:
        algo = _anakin_config(d, quick, device).build()
        algo.train()  # warmup: first chunk
        rate = _anakin_rate(algo, trials)
        rates[d] = rate
        cfg = algo.config
        # Device count in the NAME: bench.py's one-line summary keys by
        # metric, and the scaling story needs every width to survive.
        rows.append(_emit({
            "metric": f"rl_anakin_env_steps_per_s_{d}dev",
            "value": round(rate, 1),
            "devices": d,
            "envs_per_device": cfg.num_envs_per_device,
            "unroll": cfg.unroll_length,
        }))
    if len(widths) > 1:
        top = widths[-1]
        rows.append(_emit({
            "metric": "rl_anakin_scaling_efficiency",
            "value": round(rates[top] / (top * rates[1]), 4),
            "devices": top,
        }))
    return rows


def bench_anakin_vs_host_loop(quick: bool = False,
                              device=None) -> List[Dict[str, Any]]:
    """Anakin vs host-loop IMPALA, end-to-end env-steps/s, interleaved.

    Needs a running ray_tpu_torch cluster (IMPALA's env runners are
    actors).  Both sides include their learner update, on the same
    device — this is trainer throughput, not bare env stepping.
    """
    from ray_tpu_torch.rllib import IMPALAConfig

    anakin = _anakin_config(1, quick, device).build()
    anakin.train()  # warmup outside the measured window

    icfg = (
        IMPALAConfig()
        .env_runners(2, rollout_steps=32 if quick else 128)
        .training(batches_per_step=2 if quick else 4, device=device)
    )
    impala = icfg.build()
    impala.train()  # warmup: runner spin-up

    trials = 2 if quick else 3
    anakin_rates, impala_rates = [], []
    for _ in range(trials):
        # ONE window, A/B interleaved back-to-back.
        anakin_rates.append(anakin.train()["env_steps_per_s"])
        t0 = time.perf_counter()
        r = impala.train()
        impala_rates.append(
            r["num_env_steps_sampled"] / max(time.perf_counter() - t0, 1e-9)
        )
    impala.stop()
    a = sum(anakin_rates) / len(anakin_rates)
    b = sum(impala_rates) / len(impala_rates)
    return [_emit({
        "metric": "rl_anakin_vs_host_loop",
        "value": round(a, 1),
        "baseline": round(b, 1),
        "ratio": round(a / b, 3),
        "guard": ">1.0",
        "anakin_devices": 1,
        "impala_runners": 2,
        "trials": trials,
    })]


def sebulba_config(quick: bool = False, device=None):
    """The bench's Sebulba: 2 runners.  On the card each runner leases a
    quarter of it for its forwards; on a named device the runners'
    forwards run there."""
    from .sebulba import SebulbaConfig

    cfg = SebulbaConfig()
    cfg.device = device
    if device is None:
        cfg.num_gpus_per_env_runner = 0.25
    else:
        cfg.runner_device = device
    cfg.num_env_runners = 2
    cfg.envs_per_runner = 2 if quick else 4
    cfg.rollout_steps = 16 if quick else 64
    cfg.batches_per_step = 4 if quick else 8
    cfg.seed = 0
    return cfg


def bench_sebulba(quick: bool = False,
                  device=None) -> List[Dict[str, Any]]:
    """Sebulba learner-update and env-step throughput (needs cluster)."""
    cfg = sebulba_config(quick, device)
    algo = cfg.build()
    algo.train()  # warmup: actor spin-up
    trials = 1 if quick else 3
    lps, eps, stale = [], [], []
    for _ in range(trials):
        r = algo.train()
        lps.append(r["learner_steps_per_s"])
        eps.append(r["num_env_steps_sampled"])
        stale.append(r["staleness_mean"])
    algo.stop()
    return [_emit({
        "metric": "rl_sebulba_learner_steps_per_s",
        "value": round(sum(lps) / len(lps), 2),
        "runners": cfg.num_env_runners,
        "envs_per_runner": cfg.envs_per_runner,
        "staleness_mean": round(sum(stale) / len(stale), 2),
    })]


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="bench_rl")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default=None,
                    help="run on this device instead of the card (cpu)")
    args = ap.parse_args(argv)
    bench_anakin_scaling(args.quick, args.device)

    import ray_tpu_torch

    ray_tpu_torch.init(num_cpus=4)
    try:
        bench_anakin_vs_host_loop(args.quick, args.device)
        bench_sebulba(args.quick, args.device)
    finally:
        ray_tpu_torch.shutdown()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())

"""Collective algorithm-selection bench: bandwidth per op and algorithm.

Port of ``ray_tpu/collective/bench_collective.py``.  Prints one JSON line
per record.  Full mode runs 8 ranks of one ``LocalGroup`` on the card (or
the device asked for) as 2 "slices" of 4 (``slice_size=4``), so the
inter-slice axis stands in for the second slice and the two-level
algorithms run; ``op_bandwidth`` measures any group, ``LocalGroup`` or a
member of a ``DistGroup`` (called in each member process).

Stages:
  1. **per-algorithm A/B** — steady-state bandwidth of every eligible
     allreduce algorithm, run through the algorithm functions on the
     group's own exchange (no selection, no recorder).  The flat row is
     the pre-selection baseline.
  2. **tuner loop** — the production feedback cycle against those real
     measurements: ``select`` -> run the selected algorithm -> ``observe``
     the achieved bandwidth, until the tuner commits; the committed
     algorithm's bandwidth against flat, read in one window.
  3. **quantized** — the opt-in block-quantized allreduce: bandwidth,
     wire-byte reduction, max abs error vs the exact sum.
  4. **group end-to-end** — the user-facing ``allreduce()`` path
     exercising selection + stats + metrics.
  5. **per op** — ``op_bandwidth`` of the group: allreduce, allgather and
     reducescatter under each of their algorithms, broadcast, alltoall.

``--quick`` is the tier-1 smoke: 4 ranks as 2 slices of 2, tiny payloads,
a handful of iterations — checks the machinery end to end, makes no
bandwidth claims.  ``--device cpu`` runs it without a card.
"""

from __future__ import annotations

import json
import sys
import time


def _emit(record: dict) -> None:
    print(json.dumps({"collective": record}), flush=True)


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _steady_bw(fn, nbytes: int, device, warmup: int = 2,
               iters: int = 8) -> float:
    """Steady-state bandwidth (best-of-iters sheds scheduler noise)."""
    for _ in range(warmup):
        fn()
    _sync(device)
    best = 0.0
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        _sync(device)
        dt = time.perf_counter() - t0
        if dt > 0:
            best = max(best, nbytes / dt)
    return best


def _one_bw(fn, nbytes: int, device) -> float:
    t0 = time.perf_counter()
    fn()
    _sync(device)
    return nbytes / max(time.perf_counter() - t0, 1e-9)


def _force(group, algo: str):
    """Pin ``group``'s selection to ``algo`` for the calls inside."""
    import contextlib

    @contextlib.contextmanager
    def pinned():
        group._select = lambda op, nbytes, quantized: algo
        try:
            yield
        finally:
            del group._select

    return pinned()


def op_bandwidth(group, x, iters: int = 4) -> dict:
    """Bytes/s of each op of ``group`` on the payload ``x`` (a per-rank
    list for a ``LocalGroup``, this member's tensor for a ``DistGroup``):
    ``{"allreduce/ring": bw, ..., "broadcast": bw, "alltoall": bw}``.
    Bytes are the payload per rank.  In a ``DistGroup`` every member
    calls it with the same shapes, in step."""
    from . import algorithms as alg

    local = isinstance(x, list)
    first = x[0] if local else x
    device, nbytes = first.device, first.nbytes
    n = group.world_size
    # alltoall takes n chunks on axis 0: the payload, viewed so.
    a2a = ([t.reshape(n, -1) for t in x] if local else x.reshape(n, -1))
    out = {}
    for op in ("allreduce", "allgather", "reducescatter"):
        for algo in alg.candidates_for(op, n, group.topology):
            with _force(group, algo):
                fn = getattr(group, op)
                out[f"{op}/{algo}"] = _steady_bw(
                    lambda: fn(x), nbytes, device, warmup=1, iters=iters)
    out["broadcast"] = _steady_bw(lambda: group.broadcast(x), nbytes,
                                  device, warmup=1, iters=iters)
    out["alltoall"] = _steady_bw(lambda: group.alltoall(a2a), nbytes,
                                 device, warmup=1, iters=iters)
    return out


def main(quick: bool = False, device=None) -> None:
    import numpy as np
    import torch

    import ray_tpu_torch.collective as col
    from ray_tpu_torch.collective import algorithms as alg
    from ray_tpu_torch.collective.local_group import LocalGroup
    from ray_tpu_torch.collective.tuner import get_tuner, reset_tuner
    from ray_tpu_torch.device import resolve_device

    device = resolve_device(device)
    n, ici = (4, 2) if quick else (8, 4)
    elems = 4 * 1024 if quick else 256 * 1024  # fp32/rank: 16KiB / 1MiB
    iters = 4 if quick else 8
    stack = np.random.default_rng(0).normal(size=(n, elems)).astype(
        np.float32
    )
    total_bytes = stack.nbytes
    xs = [torch.from_numpy(row).to(device) for row in stack]
    group = LocalGroup("bench_ab", [device] * n, slice_size=ici)
    topo = group.topology
    comm = group._comm

    def build(algo: str):
        """A callable running one allreduce through ``algo`` directly."""
        if algo in (alg.TWO_LEVEL, alg.TWO_LEVEL_Q8):
            return lambda: alg.two_level_allreduce(
                comm, xs, topo.ici_size, quantized=algo == alg.TWO_LEVEL_Q8)
        return {
            alg.FLAT: lambda: comm.psum(xs, "world"),
            alg.RING: lambda: alg.ring_allreduce(comm, xs),
            alg.TREE: lambda: alg.tree_allreduce(comm, xs),
            alg.FLAT_Q8: lambda: alg.quantized_allreduce(comm, xs),
        }[algo]

    # ---- stage 1: per-algorithm A/B ---------------------------------------
    candidates = alg.allreduce_candidates(n, topo)
    runners = {a: build(a) for a in candidates}
    ab = {a: _steady_bw(runners[a], total_bytes, device, iters=iters)
          for a in candidates}
    _emit({
        "metric": "collective_allreduce_algo_ab",
        "bandwidth_bytes_per_s": {a: round(bw, 1) for a, bw in ab.items()},
        "world": n, "slices": topo.dcn_size,
        "payload_bytes_per_rank": elems * 4, "device": str(device),
    })

    # ---- stage 2: tuner loop on real measurements ------------------------
    reset_tuner()
    tuner = get_tuner()
    nbytes_rank = elems * 4
    committed = None
    # Explore every candidate min_attempts times, then commit.
    rounds = len(candidates) * tuner.min_attempts + 2
    for _ in range(48 if not quick else rounds):
        dec = tuner.select("allreduce", nbytes_rank, n, topo, candidates)
        bw = _one_bw(runners[dec["algo"]], total_bytes, device)
        tuner.observe("allreduce", nbytes_rank, n, topo, dec["algo"], bw)
        committed = dec["algo"] if not dec["explored"] else committed
    chosen = next(iter(tuner.stats().values()))["chosen"] or committed
    # Same-window interleaved comparison: chosen == flat means the tuner
    # kept the baseline — ratio exactly 1.0.
    if chosen == alg.FLAT:
        chosen_bw = flat_same = _steady_bw(
            runners[alg.FLAT], total_bytes, device, iters=iters
        )
    else:
        flat_w, chosen_w = [], []
        for _ in range(max(iters, 6)):
            flat_w.append(_one_bw(runners[alg.FLAT], total_bytes, device))
            chosen_w.append(_one_bw(runners[chosen], total_bytes, device))
        flat_same, chosen_bw = max(flat_w), max(chosen_w)
    _emit({
        "metric": "collective_dcn_allreduce_bytes_per_s"
        if topo.is_two_level else "collective_allreduce_bytes_per_s",
        "value": chosen_bw, "baseline": flat_same, "chosen": chosen,
        "topology": topo.kind, "decisions": tuner.stats(),
    })

    # ---- stage 3: quantized allreduce ------------------------------------
    qalgo = alg.TWO_LEVEL_Q8 if topo.is_two_level else alg.FLAT_Q8
    qrun = build(qalgo)
    quant_bw = _steady_bw(qrun, total_bytes, device, iters=iters)
    ref = stack.sum(axis=0)
    got = qrun()[0].cpu().numpy()
    err = float(np.abs(got - ref).max())
    rel = err / max(float(np.abs(ref).max()), 1e-9)
    _emit({
        "metric": "collective_allreduce_quantized_bytes_per_s",
        "value": quant_bw, "algo": qalgo, "max_abs_error": round(err, 6),
        "max_rel_error": round(rel, 6),
        "wire_bytes_per_rank": alg.quantized_wire_bytes(
            nbytes_rank, np.dtype(np.float32)),
        "logical_bytes_per_rank": nbytes_rank,
    })

    # ---- stage 4: user-facing group path (selection + stats + metrics) ---
    reset_tuner()
    col.init_local_group("bench", devices=[device] * n, slice_size=ici)
    x = [torch.full((elems,), float(i + 1), device=device) for i in range(n)]
    expected = n * (n + 1) / 2.0

    def run_group():
        out = col.allreduce(x, "bench")
        assert float(out[0].reshape(-1)[0]) == expected

    for _ in range(24 if not quick else 6):
        run_group()
    e2e_bw = _steady_bw(run_group, total_bytes, device, iters=iters)
    stats = col.collective_stats()
    _emit({
        "metric": "collective_group_allreduce_e2e_bytes_per_s",
        "value": e2e_bw,
        "tuner_buckets": sum(
            1 for r in stats["tuner"].values() if r["chosen"]
        ),
        "ops_recorded": stats.get("allreduce", {}).get("ops", 0),
    })
    col.destroy_collective_group("bench")

    # ---- stage 5: every op under each of its algorithms -------------------
    _emit({
        "metric": "collective_op_bytes_per_s",
        "bandwidth_bytes_per_s": {
            k: round(v, 1) for k, v in
            op_bandwidth(group, xs, iters=2 if quick else iters).items()},
        "world": n, "payload_bytes_per_rank": elems * 4,
        "device": str(device),
    })


if __name__ == "__main__":
    dev = sys.argv[sys.argv.index("--device") + 1] \
        if "--device" in sys.argv else None
    main(quick="--quick" in sys.argv, device=dev)

"""Online collective-algorithm autotuner.

Per (op, message-size bucket, world size, ICI-vs-DCN topology) the tuner
picks one of the algorithms in ``algorithms.py``.  It starts from a
static size/topology heuristic table, explores every eligible candidate
a fixed number of times on a deterministic round-robin schedule, commits
to the measured-best algorithm (achieved bandwidth fed back from the
flight recorder's per-op capture), and keeps re-probing alternatives on
a geometrically decaying schedule so a drifting fabric can flip the
decision later.  Every decision is observable: ``collective_stats()``
returns the per-bucket table (chosen algorithm, per-algorithm attempts,
samples, mean bandwidth) and the ``ray_tpu_collective_tuner_*`` /
``ray_tpu_collective_algo_ops_total`` metrics ride the Prometheus
endpoint.

Determinism contract (the SPMD caveat): selection depends only on the
CALL SEQUENCE (per-bucket call counts and attempt counts), never on
wall-clock or randomness, so group members that issue the same
collectives in the same order — the same contract the groups' compiled-
function caches already assume — stay in lockstep through the explore
phase.  Measured bandwidths DO differ across member processes, so
multi-member groups pass a ``sync`` callback (a small always-flat
allreduce) that averages the measurement table at the deterministic
commit points; every member then computes the same argmax and compiles
the same program.  Single-process groups pass ``sync=None``.

If the flight recorder is disabled no bandwidth ever arrives and the
tuner commits to the heuristic choice — the static table is the
fallback, not an error.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from . import algorithms as alg

# Message-size buckets (bytes, per-rank payload).  Boundaries follow the
# classic latency->bandwidth crossover decades; labels are stable metric
# tag values.
SIZE_BUCKET_EDGES: Tuple[int, ...] = (4 << 10, 64 << 10, 1 << 20, 16 << 20)
SIZE_BUCKET_LABELS: Tuple[str, ...] = (
    "le4KiB", "le64KiB", "le1MiB", "le16MiB", "gt16MiB",
)

# Explore each candidate this many times before committing.
MIN_ATTEMPTS = 2
# After commit, re-probe at call counts committed_at * 2^k (geometric
# decay), capped so a long-running job still re-probes occasionally.
REPROBE_MAX_INTERVAL = 4096


def size_bucket(nbytes: int) -> str:
    for edge, label in zip(SIZE_BUCKET_EDGES, SIZE_BUCKET_LABELS):
        if nbytes <= edge:
            return label
    return SIZE_BUCKET_LABELS[-1]


def heuristic_choice(op: str, nbytes: int, world_size: int, topology,
                     candidates: Tuple[str, ...]) -> str:
    """Static seed table: small messages are latency-bound (one fused
    XLA op wins), large messages are bandwidth-bound (ring), mid sizes
    on power-of-two worlds take the log-round tree, and any two-level
    topology prefers the hierarchical decomposition for non-small
    payloads (the DCN hop carries 1/n_ici of the bytes)."""
    if alg.TWO_LEVEL_Q8 in candidates:
        return alg.TWO_LEVEL_Q8
    if alg.FLAT_Q8 in candidates:
        return alg.FLAT_Q8
    if topology is not None and topology.is_two_level and nbytes > (64 << 10) \
            and alg.TWO_LEVEL in candidates:
        return alg.TWO_LEVEL
    if nbytes <= (64 << 10):
        return alg.FLAT
    if nbytes <= (1 << 20) and alg.TREE in candidates:
        return alg.TREE
    if alg.RING in candidates:
        return alg.RING
    return candidates[0]


@dataclass
class _AlgoStats:
    attempts: int = 0          # selections (deterministic, select-side)
    samples: int = 0           # warm bandwidth observations
    bw_sum: float = 0.0

    @property
    def mean_bw(self) -> float:
        return self.bw_sum / self.samples if self.samples else 0.0


@dataclass
class _Bucket:
    op: str
    size_label: str
    world_size: int
    topology: str
    candidates: Tuple[str, ...]
    calls: int = 0
    explorations: int = 0
    commits: int = 0
    committed: Optional[str] = None
    committed_at: int = 0
    next_probe: int = 0
    pending_recommit: bool = False
    algos: Dict[str, _AlgoStats] = field(default_factory=dict)

    def stats_for(self, a: str) -> _AlgoStats:
        st = self.algos.get(a)
        if st is None:
            st = self.algos[a] = _AlgoStats()
        return st

    @property
    def quantized(self) -> bool:
        return any(c.endswith("_q8") for c in self.candidates)

    @property
    def key(self) -> str:
        base = f"{self.op}|{self.size_label}|w{self.world_size}|{self.topology}"
        return base + ("|q8" if self.quantized else "")


class CollectiveTuner:
    """Process-wide selection state, bucketed by
    (op, size bucket, world size, topology kind)."""

    def __init__(self, enabled: Optional[bool] = None,
                 min_attempts: int = MIN_ATTEMPTS):
        self._lock = threading.Lock()
        self._buckets: Dict[tuple, _Bucket] = {}
        self._enabled = enabled
        self.min_attempts = min_attempts

    # ------------------------------------------------------------- config
    @property
    def enabled(self) -> bool:
        if self._enabled is not None:
            return self._enabled
        from ..core.config import GlobalConfig

        return GlobalConfig.collective_autotune

    # ------------------------------------------------------------ selection
    def _bucket(self, op: str, nbytes: int, world_size: int, topology,
                candidates: Tuple[str, ...]) -> _Bucket:
        label = size_bucket(nbytes)
        kind = topology.kind if topology is not None else "ici"
        key = (op, label, world_size, kind, candidates)
        b = self._buckets.get(key)
        if b is None:
            b = self._buckets[key] = _Bucket(
                op, label, world_size, kind, candidates
            )
        return b

    def select(self, op: str, nbytes: int, world_size: int, topology,
               candidates: Tuple[str, ...],
               sync: Optional[Callable] = None) -> dict:
        """Pick the algorithm for one op call.  Returns a decision dict
        ``{algo, bucket, topology, explored}``; ``sync``, when given, is
        an allreduce-MEAN over group members used at commit points (see
        module docstring)."""
        heuristic = heuristic_choice(op, nbytes, world_size, topology,
                                     candidates)
        with self._lock:
            b = self._bucket(op, nbytes, world_size, topology, candidates)
            b.calls += 1
            explored = False
            if len(candidates) == 1:
                algo = candidates[0]
                b.committed = algo  # nothing to tune
            elif not self.enabled:
                algo = heuristic  # static table only
            elif b.committed is None:
                # Explore phase: round-robin the least-attempted candidate
                # (heuristic first on ties via ordering below); commit once
                # every candidate has min_attempts attempts.
                if all(
                    b.stats_for(c).attempts >= self.min_attempts
                    for c in candidates
                ):
                    algo = self._commit(b, heuristic, sync)
                else:
                    order = [heuristic] + [
                        c for c in candidates if c != heuristic
                    ]
                    algo = min(order, key=lambda c: b.stats_for(c).attempts)
                    explored = True
                    b.explorations += 1
            else:
                if b.pending_recommit:
                    # The call after a decayed probe: fold the probe's
                    # measurement in and re-evaluate the argmax (synced).
                    b.pending_recommit = False
                    algo = self._commit(b, heuristic, sync)
                elif b.calls >= b.next_probe:
                    # Decaying re-exploration: probe the least-recently
                    # attempted non-committed candidate.
                    others = [c for c in candidates if c != b.committed]
                    algo = min(
                        others, key=lambda c: b.stats_for(c).attempts
                    )
                    explored = True
                    b.explorations += 1
                    b.pending_recommit = True
                    interval = min(
                        max(b.next_probe - b.committed_at, 1) * 2,
                        REPROBE_MAX_INTERVAL,
                    )
                    b.next_probe = b.calls + interval
                else:
                    algo = b.committed
            b.stats_for(algo).attempts += 1
            decision = {
                "algo": algo,
                "bucket": b.size_label,
                "topology": b.topology,
                "explored": explored,
            }
        self._record_decision(op, decision)
        return decision

    def _commit(self, b: _Bucket, heuristic: str,
                sync: Optional[Callable]) -> str:
        """Commit (or re-commit) to the measured-best algorithm.  With a
        ``sync`` callback the per-candidate (bw_sum, samples) table is
        averaged across group members first so every member computes the
        same argmax.  Called under the lock at deterministic call
        indices."""
        sums = np.array(
            [b.stats_for(c).bw_sum for c in b.candidates], np.float64
        )
        counts = np.array(
            [b.stats_for(c).samples for c in b.candidates], np.float64
        )
        if sync is not None:
            # One vector, one tiny allreduce; MEAN keeps magnitudes sane.
            vec = np.concatenate([sums, counts])
            try:
                vec = np.asarray(sync(vec), np.float64)
                sums, counts = vec[: len(sums)], vec[len(sums):]
            except Exception:  # noqa: BLE001 — a failed sync must not
                # break the op; fall back to local measurements (members
                # may then diverge only if their local argmaxes differ,
                # which the next synced commit repairs).
                from ..util import flight_recorder

                flight_recorder.count_suppressed("collective_tuner_sync")
        means = np.where(counts > 0, sums / np.maximum(counts, 1), 0.0)
        if means.max() > 0:
            chosen = b.candidates[int(np.argmax(means))]
        else:
            chosen = heuristic  # no measurements (recorder off)
        b.committed = chosen
        b.committed_at = b.calls
        b.commits += 1
        if not b.next_probe or b.next_probe <= b.calls:
            b.next_probe = b.calls * 2
        self._record_commit(b, chosen, float(means.max()))
        return chosen

    # ----------------------------------------------------------- feedback
    def observe(self, op: str, nbytes: int, world_size: int, topology,
                algo: str, bandwidth: float, cold: bool = False) -> None:
        """One achieved-bandwidth sample from the flight recorder's
        per-op capture.  Cold samples (first call of a compiled shape —
        the duration is trace+compile) are excluded from the tuner's
        bandwidth table."""
        if cold or bandwidth <= 0:
            return
        candidates = alg.candidates_for(
            op, world_size, topology,
            quantized=algo in (alg.FLAT_Q8, alg.TWO_LEVEL_Q8),
        )
        with self._lock:
            b = self._bucket(op, nbytes, world_size, topology, candidates)
            st = b.stats_for(algo)
            st.samples += 1
            st.bw_sum += bandwidth

    def force_reprobe(self, op: Optional[str] = None) -> int:
        """Arm an immediate re-probe on every committed multi-candidate
        bucket (optionally restricted to one ``op``): the next call in
        each bucket explores an alternative and the call after re-commits
        to the measured argmax — the SLO remediation path for bandwidth
        drift, skipping the geometric wait.

        SPMD caveat: arming ONE member of a multi-member group makes its
        call sequence diverge from its peers until the next synced
        commit.  The remediation broadcast therefore fans the directive
        to EVERY worker process (node-agent ``remediate`` fan-out), so
        members re-probe in lockstep and the synced re-commit realigns
        any residue.  Returns the number of buckets armed."""
        armed = 0
        with self._lock:
            for b in self._buckets.values():
                if op is not None and b.op != op:
                    continue
                if b.committed is None or len(b.candidates) <= 1:
                    continue
                b.next_probe = b.calls + 1
                b.pending_recommit = False
                armed += 1
        return armed

    # -------------------------------------------------------------- export
    def stats(self) -> Dict[str, dict]:
        """Per-bucket decision table keyed ``op|bucket|w<world>|<topo>``:
        chosen algorithm, call/exploration counts, and the per-algorithm
        attempts/samples/mean-bandwidth table."""
        out: Dict[str, dict] = {}
        with self._lock:
            for b in self._buckets.values():
                out[b.key] = {
                    "op": b.op,
                    "bucket": b.size_label,
                    "world_size": b.world_size,
                    "topology": b.topology,
                    "quantized": b.quantized,
                    "chosen": b.committed,
                    "calls": b.calls,
                    "explorations": b.explorations,
                    "commits": b.commits,
                    "algorithms": {
                        a: {
                            "attempts": st.attempts,
                            "samples": st.samples,
                            "mean_bandwidth_bytes_per_s": round(st.mean_bw, 1),
                        }
                        for a, st in sorted(b.algos.items())
                    },
                }
        return out

    def reset(self) -> None:
        with self._lock:
            self._buckets.clear()

    # ------------------------------------------------------------- metrics
    def _record_decision(self, op: str, decision: dict) -> None:
        from ..util import flight_recorder

        flight_recorder.counter(
            flight_recorder.COLLECTIVE_ALGO_OPS_TOTAL, 1.0,
            {"op": op, "algo": decision["algo"],
             "bucket": decision["bucket"],
             "topology": decision["topology"]},
        )
        if decision["explored"]:
            flight_recorder.counter(
                flight_recorder.COLLECTIVE_TUNER_EXPLORATIONS_TOTAL, 1.0,
                {"op": op, "bucket": decision["bucket"]},
            )

    def _record_commit(self, b: _Bucket, chosen: str, best_bw: float) -> None:
        from ..util import flight_recorder

        tags = {"op": b.op, "bucket": b.size_label, "topology": b.topology}
        flight_recorder.counter(
            flight_recorder.COLLECTIVE_TUNER_COMMITS_TOTAL, 1.0,
            {**tags, "algo": chosen},
        )
        if best_bw > 0:
            flight_recorder.gauge(
                flight_recorder.COLLECTIVE_TUNER_BEST_BANDWIDTH, best_bw,
                tags,
            )


_tuner: Optional[CollectiveTuner] = None
_tuner_lock = threading.Lock()


def get_tuner() -> CollectiveTuner:
    global _tuner
    if _tuner is None:
        with _tuner_lock:
            if _tuner is None:
                _tuner = CollectiveTuner()
    return _tuner


def select_for_group(group, op: str, per_rank_nbytes: int,
                     quantized: bool = False,
                     sync: Optional[Callable] = None) -> str:
    """One tuner decision for a group op: build the candidate set from
    the group's world/topology, select, and stamp the decision on
    ``group._last_decision`` where the flight-recorder wrapper picks it
    up (record tags + the bandwidth observation feed).  Shared by both
    group backends."""
    cands = alg.candidates_for(
        op, group.world_size, group.topology, quantized
    )
    dec = get_tuner().select(
        op, per_rank_nbytes, group.world_size, group.topology, cands,
        sync=sync,
    )
    dec["nbytes"] = per_rank_nbytes
    dec["world_size"] = group.world_size
    dec["quantized"] = quantized
    group._last_decision = dec
    return dec["algo"]


def reset_tuner() -> None:
    """Drop all buckets (tests / bench stages)."""
    get_tuner().reset()

"""Dataset plan nodes + the plan optimizer.

Reference architecture: ray ``python/ray/data/_internal/execution/
streaming_executor.py:67`` + physical operators (``operators/map_operator.py``,
``actor_pool_map_operator.py``, ``hash_shuffle.py``).  This module holds the
LOGICAL plan pieces — stage descriptions (``MapStage`` / ``AllToAllStage`` /
``LimitStage``), the rewrite rules (fusion, pushdown, repartition elision),
the exchange substrate (``_shuffle_map`` / ``_shuffle_reduce``), and per-op
stats.  The PHYSICAL execution lives in ``streaming.py``: an operator-graph
scheduler that drives these stages as nodes with bounded input/output
queues, out-of-order completion harvesting, actor-pool autoscaling, and
dynamic block shaping.

Deliberate TPU-native semantics:
  - ordered emission is the default (``take`` and train ingest stay
    deterministic); out-of-order streaming is opt-in via
    ``ExecutionOptions(preserve_order=False)``;
  - narrow transforms are fused into a single stage (the reference's
    OperatorFusionRule) and also fused into the map phase of a following
    shuffle;
  - wide ops (shuffle/sort/groupby/repartition) are an internal barrier: a
    distributed map/reduce exchange over ``num_returns=n`` tasks.

The scheduler runs in whatever process iterates the dataset; blocks live in
the object store and move node-to-node only when a consumer pulls them.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Iterator, List, Optional

import numpy as np

import ray_tpu_torch

from .block import Block
from .datasource import ReadTask

Transform = Callable[[Block], Block]


# ------------------------------------------------------------ remote helpers
def apply_chain(item, transforms: List[Transform]) -> Block:
    """Materialize one input item (ReadTask or block) through a fused
    transform chain."""
    block = item() if isinstance(item, ReadTask) else item
    for t in transforms:
        block = t(block)
    return block


@ray_tpu_torch.remote
def _run_item(item, transforms: List[Transform]) -> Block:
    return apply_chain(item, transforms)


class HashPartition:
    """Hash-on-key partitioner.  As a plain callable it is the per-row
    generic path; ``vector_parts`` is the columnar fast path _shuffle_map
    recognizes — numeric key columns hash in a few numpy passes
    (scalar/vector equality guaranteed by block._splitmix64) instead of a
    per-row Python loop (reference: native hash_shuffle partitioning)."""

    def __init__(self, key):
        self.key = key

    def __call__(self, row, i, bidx):
        from .block import row_key, stable_hash

        return stable_hash(row_key(row, self.key))

    def vector_parts(self, block, n_out: int, bidx: int):
        from .block import hash_column

        if not isinstance(self.key, str):
            return None
        col = block.columns.get(self.key)
        if col is None:
            return None
        hashes = hash_column(col)
        if hashes is None:
            return None
        return (hashes % np.uint64(n_out)).astype(np.int64)


class RoundRobinPartition:
    """Deterministic row->partition striping (repartition)."""

    def __init__(self, num_blocks: int):
        self.num_blocks = num_blocks

    def __call__(self, row, i, bidx):
        return (bidx * 1000003 + i) % self.num_blocks

    def vector_parts(self, block, n_out: int, bidx: int):
        return (bidx * 1000003 + np.arange(len(block))) % n_out


@ray_tpu_torch.remote
def _shuffle_map(item, transforms, n_out: int, part_fn, block_idx: int):
    """Map phase of an exchange: apply fused chain, split rows into n_out
    partitions (returned as n_out separate objects via num_returns)."""
    from .block import ColumnarBlock

    block = apply_chain(item, transforms)
    if isinstance(block, ColumnarBlock) and hasattr(part_fn, "vector_parts"):
        pidx = part_fn.vector_parts(block, n_out, block_idx)
        if pidx is not None:
            # Columnar all the way: no row materialization on the map
            # side, and reducers that do no row work (repartition)
            # re-concatenate columnar.
            from .block import partition_columnar

            parts = partition_columnar(block, pidx, n_out)
            return parts if n_out > 1 else parts[0]
    parts: List[Block] = [[] for _ in range(n_out)]
    for i, row in enumerate(block):
        parts[part_fn(row, i, block_idx) % n_out].append(row)
    # num_returns=n_out>1 splits the returned list into one object per
    # partition; num_returns=1 returns the value VERBATIM, so the single
    # partition must be returned bare or every 1-reducer exchange (e.g.
    # repartition(1)) would emit a nested [rows] block.
    return parts if n_out > 1 else parts[0]


@ray_tpu_torch.remote
def _shuffle_reduce(reduce_fn, reducer_idx: int, *parts: Block) -> Block:
    if reduce_fn is not None and getattr(reduce_fn, "wants_blocks", False):
        # Block-aware reducers (groupby aggregation) see the raw parts:
        # columnar parts aggregate vectorized instead of being rowified
        # here first.
        return reduce_fn(list(parts), reducer_idx)
    if reduce_fn is None:
        # Pure concatenation exchanges (repartition) stay columnar when
        # every non-empty part is (parquet -> repartition -> write never
        # rowifies).
        from .block import concat_columnar

        cat = concat_columnar(parts)
        if cat is not None:
            return cat
    rows = [r for p in parts for r in p]
    if reduce_fn is not None:
        rows = reduce_fn(rows, reducer_idx)
    return rows


class _MapWorker:
    """Actor applying a fused chain (reference ``actor_pool_map_operator``'s
    ``_MapWorker``); holds user state (e.g. a loaded model) across blocks."""

    def __init__(self, transforms: List[Transform]):
        self._transforms = transforms

    def apply(self, item) -> Block:
        return apply_chain(item, self._transforms)

    def prepare_evict(self) -> None:
        """Checkpoint-then-evict hook (docs/scheduling.md): a map chain
        holds no durable pool state — in-flight blocks are simply
        re-dispatched by the streaming scheduler after the kill — but a
        stateful user transform (loaded model, buffered writer) gets its
        flush if it exposes ``prepare_evict`` itself."""
        for t in self._transforms:
            fn = getattr(t, "prepare_evict", None)
            if callable(fn):
                fn()


class ActorPoolStrategy:
    """``map_batches(..., compute=ActorPoolStrategy(size=4))`` (reference
    ``python/ray/data/_internal/compute.py``).

    ``min_size``/``max_size`` turn the pool into an autoscaling one under
    the streaming scheduler: it grows toward ``max_size`` on sustained
    input-queue pressure and shrinks back to ``min_size`` when actors
    starve.  Plain ``size`` pins both bounds (fixed pool, the round-1
    behavior)."""

    def __init__(
        self,
        size: int = 2,
        max_tasks_in_flight_per_actor: int = 2,
        num_gpus: float = 0,
        num_cpus: Optional[float] = None,
        min_size: Optional[int] = None,
        max_size: Optional[int] = None,
    ):
        self.size = size
        self.min_size = min_size if min_size is not None else size
        self.max_size = max_size if max_size is not None else max(
            self.min_size, size
        )
        if self.min_size < 1 or self.max_size < self.min_size:
            raise ValueError(
                f"invalid pool bounds: min_size={self.min_size} "
                f"max_size={self.max_size}"
            )
        self.max_tasks_in_flight_per_actor = max_tasks_in_flight_per_actor
        self.num_gpus = num_gpus
        self.num_cpus = num_cpus


# ------------------------------------------------------------------- stages
class OpStats:
    """Per-operator execution accounting.

    ``wall_s`` measures OPERATOR time — first input/launch to last output
    *produced* (completion harvested by the scheduler), not to last output
    consumed downstream.  (The former generator chain folded downstream
    consume time into every upstream ``yield``; the operator-graph
    scheduler closes the interval at production.)"""

    QUEUE_WAIT_SAMPLE_CAP = 4096

    def __init__(self, name: str):
        self.name = name
        self.num_tasks = 0
        self.wall_s = 0.0
        # Streaming-scheduler extensions (zeros under barrier stages).
        self.queue_wait_s: List[float] = []  # per-block input-queue waits
        self.straggler_wait_s = 0.0  # scheduler blocked on this op's tasks
        self.blocks_emitted = 0
        self.blocks_split = 0
        self.blocks_coalesced = 0
        self.autoscale_up_events = 0
        self.autoscale_down_events = 0
        # Autoscaling pools: TARGET size (actor handles held).  Actor
        # creation is async, so a just-spawned entry may still be starting.
        self.pool_size = 0
        self.pool_size_peak = 0
        # Every pool-size change in order (ends with 0 at teardown):
        # lets tests/stats assert "reached max_size, returned to min_size"
        # without sampling races.
        self.pool_size_timeline: List[int] = []
        # Cancel REQUESTS issued for this op's in-flight tasks on early
        # exit.  ray_tpu_torch.cancel is best-effort: an already-executing task
        # runs to completion, so this is not a count of tasks killed.
        self.tasks_cancel_requested = 0

    def add_queue_wait(self, dt: float):
        if len(self.queue_wait_s) < self.QUEUE_WAIT_SAMPLE_CAP:
            self.queue_wait_s.append(dt)

    def queue_wait_pct(self, q: float) -> float:
        if not self.queue_wait_s:
            return 0.0
        s = sorted(self.queue_wait_s)
        return s[min(len(s) - 1, int(q * len(s)))]

    def summary(self) -> str:
        parts = [
            f"{self.name}: {self.num_tasks} tasks, {self.wall_s:.3f}s wall",
            f"queue wait p50/p95 {self.queue_wait_pct(0.5) * 1e3:.1f}/"
            f"{self.queue_wait_pct(0.95) * 1e3:.1f}ms",
            f"{self.blocks_emitted} blocks out",
        ]
        if self.straggler_wait_s:
            parts.append(f"straggler wait {self.straggler_wait_s:.3f}s")
        if self.blocks_split or self.blocks_coalesced:
            parts.append(
                f"split/coalesced {self.blocks_split}/{self.blocks_coalesced}"
            )
        if self.autoscale_up_events or self.autoscale_down_events:
            parts.append(
                f"autoscale +{self.autoscale_up_events}/"
                f"-{self.autoscale_down_events} "
                f"(peak {self.pool_size_peak})"
            )
        if self.tasks_cancel_requested:
            parts.append(f"{self.tasks_cancel_requested} cancel requested")
        return ", ".join(parts)

    def __repr__(self):
        return f"{self.name}: {self.num_tasks} tasks, {self.wall_s:.3f}s"


class MapStage:
    """Fused narrow transforms executed by tasks (or an actor pool).

    ``projection`` / ``predicate`` mark pushdown-eligible stages (set by
    ``select_columns`` / ``filter(predicate=...)``) for the plan optimizer.
    """

    def __init__(
        self,
        transforms: List[Transform],
        names: Optional[List[str]] = None,
        compute: Optional[ActorPoolStrategy] = None,
    ):
        self.transforms = list(transforms)
        self.names = list(names or [])
        self.compute = compute
        self.projection: Optional[List[str]] = None
        self.predicate: Optional[list] = None

    @property
    def name(self) -> str:
        return "+".join(self.names) if self.names else "Map"

    def fuse(self, other: "MapStage") -> Optional["MapStage"]:
        """Adjacent task-compute map stages fuse into one."""
        if self.compute is not None or other.compute is not None:
            return None
        return MapStage(
            self.transforms + other.transforms, self.names + other.names
        )


class AllToAllStage:
    """Internal-barrier exchange: consumes every upstream ref, emits
    reducer outputs (hash shuffle substrate for shuffle/sort/groupby/
    repartition)."""

    def __init__(
        self,
        name: str,
        n_out: Optional[int],
        part_fn: Callable,
        reduce_fn: Optional[Callable] = None,
        prepare: Optional[Callable[[List], dict]] = None,
        fused_transforms: Optional[List[Transform]] = None,
        reverse_out: bool = False,
    ):
        self.name = name
        self.n_out = n_out
        self.part_fn = part_fn
        self.reduce_fn = reduce_fn
        # Optional driver-side hook run on the materialized input refs
        # before the exchange (e.g. sort boundary sampling); returns extra
        # kwargs threaded into part_fn via functools.partial.
        self.prepare = prepare
        self.fused_transforms = list(fused_transforms or [])
        # Emit reducer outputs in reverse index order (descending sort).
        self.reverse_out = reverse_out

    def with_fused(self, transforms: List[Transform]) -> "AllToAllStage":
        """Copy with a fused upstream chain — stages are shared between
        derived Datasets, so fusion must never mutate in place."""
        return AllToAllStage(
            self.name,
            self.n_out,
            self.part_fn,
            self.reduce_fn,
            self.prepare,
            transforms,
            self.reverse_out,
        )

    def run(self, upstream: Iterator, stats: List[OpStats]) -> Iterator:
        st = OpStats(self.name)
        stats.append(st)
        t0 = time.perf_counter()
        items = list(upstream)  # barrier
        n_out = self.n_out or max(1, len(items))
        part_fn = self.part_fn
        if self.prepare is not None:
            # Materialize inputs for sampling (refs only; sampling getter
            # decides what to fetch).
            refs = _ensure_refs(items, self.fused_transforms)
            items = refs
            extra = self.prepare(refs)
            if extra:
                import functools

                part_fn = functools.partial(part_fn, **extra)
            fused: List[Transform] = []
        else:
            fused = self.fused_transforms
        map_out = []
        for idx, item in enumerate(items):
            st.num_tasks += 1
            refs = _shuffle_map.options(num_returns=n_out).remote(
                item, fused, n_out, part_fn, idx
            )
            if n_out == 1:
                refs = [refs]
            map_out.append(refs)
        order = range(n_out - 1, -1, -1) if self.reverse_out else range(n_out)
        for j in order:
            st.num_tasks += 1
            parts_j = [map_out[i][j] for i in range(len(map_out))]
            st.wall_s = time.perf_counter() - t0
            yield _shuffle_reduce.remote(self.reduce_fn, j, *parts_j)
        st.wall_s = time.perf_counter() - t0


class LimitStage:
    """Global row limit (plan node; executed by the scheduler's limit
    operator).  When the limit is satisfied the scheduler cancels every
    still-in-flight upstream task and tears down actor pools — early-exit
    cancellation, not just launch-stoppage."""

    def __init__(self, n: int):
        self.n = n

    @property
    def name(self) -> str:
        return f"Limit[{self.n}]"


def _ensure_refs(items: List[Any], transforms: List[Transform]) -> List:
    """Convert any ReadTasks/plain items into block refs (applying a fused
    chain remotely)."""
    out = []
    for item in items:
        if isinstance(item, ray_tpu_torch.ObjectRef) and not transforms:
            out.append(item)
        else:
            out.append(_run_item.remote(item, transforms))
    return out


class StreamingExecutor:
    """Facade over the operator-graph scheduler (``streaming.py``): the
    optimized plan's stages become operator nodes with bounded input/
    output queues, driven by one completion-harvesting scheduler loop
    instead of a chain of head-of-line-blocking generators."""

    def __init__(self, inputs: List[Any], stages: List[Any], options=None):
        self.inputs = list(inputs)
        self.stages = list(stages)
        self.options = options
        self.stats: List[OpStats] = []

    def run(self) -> Iterator:
        from .streaming import StreamingScheduler

        inputs, stages = _optimize(self.inputs, self.stages)
        sched = StreamingScheduler(
            inputs, stages, self.stats, options=self.options
        )
        return sched.run_stream()


def _pushdown_rules(inputs: List[Any], stages: List[Any]):
    """Projection/predicate pushdown into pushdown-capable read tasks
    (reference ``data/_internal/logical/rules/``: projection + filter
    pushdown into ParquetDatasource).  Walks the leading marker stages:
    a predicate pushes into the read AND its stage is dropped (the scan
    is row-exact); a projection narrows the read but the stage stays (it
    is a cheap column slice and also covers non-pushdown inputs)."""
    from .datasource import ParquetReadTask

    if not stages or not inputs or not all(
        isinstance(i, ParquetReadTask) for i in inputs
    ):
        return inputs, stages
    stages = list(stages)
    out_inputs = list(inputs)
    idx = 0
    needed_cols: Optional[set] = None
    while idx < len(stages):
        st = stages[idx]
        if not isinstance(st, MapStage):
            break
        if st.predicate is not None:
            out_inputs = [t.with_predicate(st.predicate) for t in out_inputs]
            # Predicate columns must survive any projection pushed later.
            pred_cols = {c for c, _op, _v in st.predicate}
            if needed_cols is not None:
                needed_cols |= pred_cols
            stages.pop(idx)
            continue
        if st.projection is not None:
            cols = set(st.projection)
            needed_cols = cols if needed_cols is None else needed_cols | cols
            idx += 1
            continue
        break
    if needed_cols is not None:
        out_inputs = [
            t.with_projection(sorted(needed_cols)) for t in out_inputs
        ]
    return out_inputs, stages


def _elide_repartitions(inputs: List[Any], stages: List[Any]) -> List[Any]:
    """Repartition elision (reference fuse/elide-repartition rules):
    consecutive repartitions collapse to the last (the earlier exchange's
    block assignment is fully overwritten by the later one).  A repartition
    matching the current block COUNT is deliberately NOT elided — it also
    rebalances row counts across blocks."""
    out: List[Any] = []
    for stage in stages:
        is_rep = isinstance(stage, AllToAllStage) and stage.name == "Repartition"
        if (
            is_rep
            and out
            and isinstance(out[-1], AllToAllStage)
            and out[-1].name == "Repartition"
        ):
            out[-1] = stage  # last repartition wins
            continue
        out.append(stage)
    return out


def _optimize(inputs: List[Any], stages: List[Any]):
    """Plan rewriting (reference ``data/_internal/logical/rules/``):
    (0) projection/predicate pushdown into parquet reads and repartition
    elision; (1) adjacent task-compute MapStages fuse; (2) a MapStage
    directly before an AllToAllStage fuses into its map phase; (3) a
    leading non-map stage over ReadTasks gets a normalization MapStage."""
    inputs, stages = _pushdown_rules(inputs, stages)
    stages = _elide_repartitions(inputs, stages)
    fused: List[Any] = []
    for stage in stages:
        if fused and isinstance(stage, MapStage) and isinstance(fused[-1], MapStage):
            merged = fused[-1].fuse(stage)
            if merged is not None:
                fused[-1] = merged
                continue
        if (
            fused
            and hasattr(stage, "with_fused")
            and isinstance(fused[-1], MapStage)
            and fused[-1].compute is None
            and not stage.fused_transforms
        ):
            # Copy, never mutate: the stage object is shared by every
            # Dataset derived from the same plan.
            fused.append(stage.with_fused(fused.pop().transforms))
            continue
        fused.append(stage)
    needs_norm = any(isinstance(i, ReadTask) for i in inputs)
    if needs_norm and not (
        fused
        and (isinstance(fused[0], MapStage) or hasattr(fused[0], "with_fused"))
    ):
        fused.insert(0, MapStage([], ["Read"]))
    return inputs, fused

"""Streaming datasets — the Ray Data equivalent.

Reference architecture (ray ``python/ray/data/dataset.py:184``): a lazy
plan over *blocks* in the object store, executed by a pull-based streaming
executor (``execution.py`` here; reference ``_internal/execution/
streaming_executor.py:67``), with narrow transforms fused and wide ops
(shuffle/sort/groupby/repartition) as distributed hash exchanges, consumed
by trainers via ``streaming_split`` per-worker shards (reference
``dataset.py:1881``).

TPU note: ``iter_batches(batch_format="numpy")`` yields stacked column
arrays ready for ``jax.device_put``; device placement belongs to the train
loop so host→HBM transfers overlap compute.
"""

from __future__ import annotations

import dataclasses
import random as _random
from bisect import bisect_left
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Union

import numpy as np

import ray_tpu_torch

from .aggregate import (
    AggregateFn,
    GroupedData,
    aggregate_block,
    finalize_partials,
    merge_partials,
)
from .block import (
    Block,
    ColumnarBlock,
    from_batch,
    row_key,
    to_batch,
)
from .datasource import (
    BinaryFilesDatasource,
    CSVDatasource,
    Datasource,
    ItemsDatasource,
    JSONDatasource,
    NumpyDatasource,
    ParquetDatasource,
    RangeDatasource,
    ReadTask,
    TextDatasource,
)
from .execution import (
    ActorPoolStrategy,
    AllToAllStage,
    LimitStage,
    MapStage,
    OpStats,
    StreamingExecutor,
    _ensure_refs,
    _run_item,
    apply_chain,
)
from .streaming import ExecutionOptions


@ray_tpu_torch.remote
def _write_block(item, transforms, writer, path: str) -> dict:
    from .filesystem import is_uri, resolve

    block = apply_chain(item, transforms)
    if is_uri(path):
        # Remote destination: sinks write a real local file (their codecs
        # are path-based), then the finished parts publish to the URI —
        # write-then-upload, the reference's remote-sink pattern.
        import os
        import tempfile

        import shutil

        fs, _ = resolve(path)
        tmpdir = tempfile.mkdtemp(prefix="rtpu_sink_")
        try:
            local = os.path.join(tmpdir, os.path.basename(path.rstrip("/")))
            meta = writer(block, local)
            if not isinstance(meta, dict):
                meta = {}
            produced = meta.get("files") or (
                [local] if os.path.exists(local) else []
            )
            base = path.rsplit("/", 1)[0]
            published = []
            for f in produced:
                dest = (
                    path if f == local else f"{base}/{os.path.basename(f)}"
                )
                fs.publish(f, dest)
                published.append(dest)
            if meta.get("files"):
                meta["files"] = published
            meta["path"] = path
            meta.setdefault("num_rows", len(block))
            return meta
        finally:
            # A failing codec or publish must not strand a full block copy
            # in the (long-lived, pooled) worker's tmpdir.
            shutil.rmtree(tmpdir, ignore_errors=True)
    meta = writer(block, path)
    if not isinstance(meta, dict):
        meta = {}
    meta.setdefault("path", path)
    meta.setdefault("num_rows", len(block))
    return meta


class Dataset:
    """A lazy, distributed collection of rows."""

    def __init__(self, inputs: List[Any], stages: Optional[List[Any]] = None,
                 options: Optional[ExecutionOptions] = None):
        self._inputs = list(inputs)  # ObjectRefs and/or ReadTasks
        self._stages = list(stages or [])
        self._options = options
        self._last_stats: List[OpStats] = []

    # ---------------------------------------------------------- plan builder
    def _with_stage(self, stage) -> "Dataset":
        return Dataset(self._inputs, self._stages + [stage], self._options)

    def execution_options(self, options: Optional[ExecutionOptions] = None,
                          **kwargs) -> "Dataset":
        """Return a copy of this dataset executing under the given
        ``ExecutionOptions`` (or keyword fields thereof) — e.g.
        ``ds.execution_options(preserve_order=False)`` opts into
        out-of-order streaming, ``target_block_size_bytes=...`` enables
        dynamic block shaping for this plan.  Keyword fields MERGE into
        the options already set on this dataset, so chained calls
        compose instead of silently resetting earlier choices."""
        if options is not None:
            if kwargs:
                raise ValueError(
                    "pass either an ExecutionOptions object or keyword "
                    "fields, not both"
                )
            opts = options
        else:
            opts = dataclasses.replace(
                self._options or ExecutionOptions(), **kwargs
            )
        return Dataset(self._inputs, self._stages, opts)

    def _narrow(self, name: str, fn: Callable[[Block], Block],
                compute=None) -> "Dataset":
        return self._with_stage(MapStage([fn], [name], compute))

    # ------------------------------------------------------------ transforms
    def map(self, fn: Callable[[Any], Any]) -> "Dataset":
        return self._narrow("Map", lambda block: [fn(r) for r in block])

    def filter(self, fn=None, *, predicate=None) -> "Dataset":
        """Keep rows where ``fn(row)`` is true — or, with ``predicate``, a
        structured comparison ``(col, op, value)`` (or a list of them,
        ANDed; op in ==/!=/>/>=/</<=) that the plan optimizer can push
        down into columnar datasources (parquet predicate pushdown)."""
        if predicate is not None:
            preds = (
                [predicate] if isinstance(predicate, tuple) else list(predicate)
            )
            import operator as _op

            ops = {
                "==": _op.eq, "!=": _op.ne, ">": _op.gt,
                ">=": _op.ge, "<": _op.lt, "<=": _op.le,
            }

            def pred_filter(block: Block) -> Block:
                if isinstance(block, ColumnarBlock):
                    import numpy as _np

                    mask = _np.ones(len(block), dtype=bool)
                    for col, op, val in preds:
                        mask &= ops[op](block.columns[col], val)
                    return ColumnarBlock(
                        {k: v[mask] for k, v in block.columns.items()}
                    )
                return [
                    r for r in block
                    if all(ops[op](r[col], val) for col, op, val in preds)
                ]

            stage = MapStage([pred_filter], [f"Filter{preds}"])
            stage.predicate = preds
            return self._with_stage(stage)
        return self._narrow("Filter", lambda block: [r for r in block if fn(r)])

    def flat_map(self, fn: Callable[[Any], Sequence[Any]]) -> "Dataset":
        return self._narrow(
            "FlatMap", lambda block: [o for r in block for o in fn(r)]
        )

    def map_batches(
        self,
        fn: Callable,
        *,
        batch_format: str = "default",
        compute: Optional[ActorPoolStrategy] = None,
        fn_constructor_args: Optional[tuple] = None,
    ) -> "Dataset":
        """Apply ``fn`` per block.  ``batch_format="numpy"`` converts blocks
        to dict-of-arrays for the UDF and back.  ``compute=ActorPoolStrategy``
        runs the UDF in a pool of actors (stateful/expensive setup, e.g. a
        loaded model); a *class* UDF is constructed once per actor."""
        if isinstance(fn, type):
            if compute is None:
                # Task compute would silently reconstruct the instance per
                # block (each task pickles the wrapper fresh) — the whole
                # point of a class UDF is amortized setup, so require the
                # pool (the reference raises here too).
                raise ValueError(
                    "map_batches with a callable class requires "
                    "compute=ActorPoolStrategy(...) so the class is "
                    "constructed once per actor"
                )
            ctor_args = fn_constructor_args or ()
            cls = fn

            class _Stateful:
                _instance = None

                @staticmethod
                def apply(block):
                    if _Stateful._instance is None:
                        _Stateful._instance = cls(*ctor_args)
                    return _Stateful._instance(block)

            call = _Stateful.apply
        else:
            call = fn

        def transform(block: Block) -> Block:
            batch = to_batch(block, batch_format)
            out = call(batch)
            return from_batch(out)

        return self._narrow("MapBatches", transform, compute)

    def add_column(self, name: str, fn: Callable[[dict], Any]) -> "Dataset":
        def add(row):
            row = dict(row)
            row[name] = fn(row)
            return row

        return self.map(add)

    def select_columns(self, cols: List[str]) -> "Dataset":
        def proj(block: Block) -> Block:
            if isinstance(block, ColumnarBlock):
                return block.select(cols)
            return [{c: r[c] for c in cols} for r in block]

        stage = MapStage([proj], [f"Select{cols}"])
        stage.projection = list(cols)
        return self._with_stage(stage)

    def drop_columns(self, cols: List[str]) -> "Dataset":
        drop = set(cols)
        return self.map(lambda r: {k: v for k, v in r.items() if k not in drop})

    def limit(self, n: int) -> "Dataset":
        """Global row limit; the pull-based executor stops upstream work
        once n rows have been emitted."""
        return self._with_stage(LimitStage(n))

    # --------------------------------------------------------------- wide ops
    def repartition(self, num_blocks: int) -> "Dataset":
        from .execution import RoundRobinPartition

        return self._with_stage(
            AllToAllStage(
                "Repartition",
                num_blocks,
                part_fn=RoundRobinPartition(num_blocks),
            )
        )

    def random_shuffle(self, seed: Optional[int] = None) -> "Dataset":
        base = seed if seed is not None else _random.randrange(1 << 30)

        def part(row, i, bidx):
            return _random.Random(base * 1000003 + bidx * 8191 + i).randrange(
                1 << 30
            )

        def reduce_fn(rows, ridx):
            _random.Random(base * 7919 + ridx).shuffle(rows)
            return rows

        return self._with_stage(
            AllToAllStage("RandomShuffle", None, part, reduce_fn)
        )

    def join(
        self,
        other: "Dataset",
        on: Union[str, Callable],
        *,
        right_on: Union[str, Callable, None] = None,
        how: str = "inner",
        num_partitions: Optional[int] = None,
    ) -> "Dataset":
        """Distributed hash join (reference
        ``data/_internal/execution/operators/join.py``): both sides are
        hash-partitioned on the key, one reduce task joins each partition
        (build right, probe left).  ``how``: "inner" | "left".  Dict rows
        merge columns (left wins clashes); other rows pair as tuples."""
        from .joins import JoinStage

        return self._with_stage(
            JoinStage(other, on, right_on, how, num_partitions)
        )

    def sort(self, key: Union[str, Callable, None] = None,
             descending: bool = False) -> "Dataset":
        """Distributed sample-partitioned sort (reference
        ``data/_internal/planner/exchange/sort_task_spec.py``)."""

        def prepare(refs):
            # Sample keys to pick range boundaries.
            sample_refs = [
                _run_item.remote(
                    r,
                    [lambda b: sorted(row_key(x, key) for x in b[:: max(1, len(b) // 20)])],
                )
                for r in refs
            ]
            keys = sorted(
                k for s in ray_tpu_torch.get(sample_refs, timeout=300) for k in s
            )
            n_out = max(1, len(refs))
            bounds = [
                keys[int(len(keys) * (i + 1) / n_out)]
                for i in range(n_out - 1)
            ] if keys else []
            return {"bounds": bounds}

        def part(row, i, bidx, bounds=None):
            return bisect_left(bounds, row_key(row, key)) if bounds else 0

        def reduce_fn(rows, ridx):
            rows.sort(key=lambda r: row_key(r, key), reverse=descending)
            return rows

        # Partitions ascend by boundary; for descending order each reducer
        # sorts descending and the stage emits reducers in reverse order.
        stage = AllToAllStage(
            "Sort", None, part, reduce_fn, prepare=prepare,
            reverse_out=descending,
        )
        return self._with_stage(stage)

    def _groupby_aggregate(self, key, aggs: List[AggregateFn]) -> "Dataset":
        from .execution import HashPartition

        part = HashPartition(key)

        def reduce_fn(parts, ridx):
            # Block-aware (wants_blocks): each part aggregates on its own
            # representation — columnar parts take the vectorized path in
            # aggregate_block — and the partials merge exactly as the
            # distributed (init, accumulate, merge, finalize) contract
            # prescribes.
            partial_list = [
                aggregate_block(p, key, aggs) for p in parts if len(p)
            ]
            merged = merge_partials(partial_list, aggs)
            return finalize_partials(merged, key, aggs)

        reduce_fn.wants_blocks = True

        return self._with_stage(
            AllToAllStage(f"GroupBy({key})", None, part, reduce_fn)
        )

    def _map_groups(self, key, fn: Callable[[list], list]) -> "Dataset":
        from .execution import HashPartition

        part = HashPartition(key)

        def reduce_fn(rows, ridx):
            groups: Dict[Any, list] = {}
            for r in rows:
                groups.setdefault(row_key(r, key), []).append(r)
            out = []
            for k in sorted(groups.keys(), key=lambda x: (x is None, x)):
                out.extend(fn(groups[k]))
            return out

        return self._with_stage(
            AllToAllStage(f"MapGroups({key})", None, part, reduce_fn)
        )

    def groupby(self, key: Union[str, Callable]) -> GroupedData:
        return GroupedData(self, key)

    def aggregate(self, *aggs: AggregateFn):
        """Global (ungrouped) aggregation, returned as a plain value."""
        try:
            chain = self._narrow_chain()
            items = self._frontier()
        except ValueError:  # wide plan: materialize first
            chain = []
            items = list(self._execute())
        partial_refs = [
            _run_item.remote(item, chain + [
                lambda b, aggs=aggs: [aggregate_block(b, None, list(aggs))]
            ])
            for item in items
        ]
        partials = [
            p[0] for p in ray_tpu_torch.get(partial_refs, timeout=600)
        ]
        merged = merge_partials(partials, list(aggs))
        rows = finalize_partials(merged, None, list(aggs))
        return rows[0] if rows else None

    def sum(self, on=None):
        from .aggregate import Sum

        return self.aggregate(Sum(on))

    def min(self, on=None):
        from .aggregate import Min

        return self.aggregate(Min(on))

    def max(self, on=None):
        from .aggregate import Max

        return self.aggregate(Max(on))

    def mean(self, on=None):
        from .aggregate import Mean

        return self.aggregate(Mean(on))

    def std(self, on=None, ddof: int = 1):
        from .aggregate import Std

        return self.aggregate(Std(on, ddof))

    def union(self, other: "Dataset") -> "Dataset":
        a, b = self.materialize(), other.materialize()
        return Dataset(a._inputs + b._inputs, [])

    def zip(self, other: "Dataset") -> "Dataset":
        """Barrier: pairs rows positionally into (left, right) tuples (or
        merged dicts when both sides are dicts)."""
        left, right = self.take_all(), other.take_all()
        if len(left) != len(right):
            raise ValueError(
                f"zip requires equal row counts: {len(left)} vs {len(right)}"
            )
        rows = [
            {**l, **r} if isinstance(l, dict) and isinstance(r, dict) else (l, r)
            for l, r in zip(left, right)
        ]
        return from_items(rows, parallelism=max(1, len(self._inputs)))

    # -------------------------------------------------------------- execution
    def _execute(self) -> Iterator:
        """Stream block refs out of the plan (operator-graph scheduler)."""
        ex = StreamingExecutor(self._inputs, self._stages, self._options)
        stream = ex.run()
        self._last_stats = ex.stats
        return stream

    def _narrow_chain(self) -> List[Callable]:
        """The plan's transforms when it is purely narrow (no wide stages,
        task compute only); raises otherwise."""
        chain: List[Callable] = []
        for st in self._stages:
            if not isinstance(st, MapStage) or st.compute is not None:
                raise ValueError("plan has wide/actor stages")
            chain.extend(st.transforms)
        return chain

    def _frontier(self) -> List[Any]:
        return list(self._inputs)

    def materialize(self) -> "Dataset":
        """Execute the full plan; the result holds only block refs."""
        refs = list(self._execute())
        ds = Dataset(refs, [], self._options)
        ds._last_stats = self._last_stats
        return ds

    def stats(self) -> str:
        """Formatted per-operator summary of the last execution: tasks,
        wall (operator work, not downstream consume time), queue-wait
        percentiles, blocks split/coalesced, autoscale events."""
        if not self._last_stats:
            return "(not executed yet)"
        return "\n".join(s.summary() for s in self._last_stats)

    # ------------------------------------------------------------- consumers
    def iter_blocks(self) -> Iterator[Block]:
        for ref in self._execute():
            if isinstance(ref, ray_tpu_torch.ObjectRef):
                yield ray_tpu_torch.get(ref, timeout=600)
            else:  # concrete block (e.g. from_blocks inputs, no stages)
                yield ref

    def iter_rows(self) -> Iterator[Any]:
        for block in self.iter_blocks():
            yield from block

    def iter_batches(
        self,
        batch_size: int = 256,
        *,
        batch_format: str = "default",
        drop_last: bool = False,
    ) -> Iterator:
        # Columnar path: slice column arrays (numpy views — zero-copy
        # within a block) instead of materializing per-row dicts.
        pending: List[ColumnarBlock] = []  # columnar carry between blocks
        n_pending = 0
        buf: List[Any] = []  # row carry (mixed/row blocks)
        for block in self.iter_blocks():
            if isinstance(block, ColumnarBlock) and not buf:
                pending.append(block)
                n_pending += len(block)
                while n_pending >= batch_size:
                    take, taken = [], 0
                    while taken < batch_size:
                        head = pending[0]
                        need = batch_size - taken
                        if len(head) <= need:
                            take.append(pending.pop(0))
                            taken += len(take[-1])
                        else:
                            take.append(head[:need])
                            pending[0] = head[need:]
                            taken += need
                    n_pending -= batch_size
                    if len(take) == 1:
                        yield to_batch(take[0], batch_format)
                    else:
                        cols = {
                            k: np.concatenate([t.columns[k] for t in take])
                            for k in take[0].columns
                        }
                        yield to_batch(ColumnarBlock(cols), batch_format)
                continue
            # Row path (also drains any columnar carry into rows first).
            for p in pending:
                buf.extend(p)
            pending, n_pending = [], 0
            buf.extend(block)
            while len(buf) >= batch_size:
                yield to_batch(buf[:batch_size], batch_format)
                buf = buf[batch_size:]
        for p in pending:
            buf.extend(p)
        if buf and not drop_last:
            yield to_batch(buf, batch_format)

    def take(self, n: int = 20) -> Block:
        out: Block = []
        for row in self.iter_rows():
            out.append(row)
            if len(out) >= n:
                break
        return out

    def take_all(self) -> Block:
        return list(self.iter_rows())

    def count(self) -> int:
        if not self._stages:
            known = [
                i.metadata.get("num_rows")
                for i in self._inputs
                if isinstance(i, ReadTask)
            ]
            if len(known) == len(self._inputs) and all(
                k is not None for k in known
            ):
                return sum(known)
        counted = self._with_stage(
            MapStage([lambda b: [len(b)]], ["Count"])
        )
        return sum(c[0] for c in counted.iter_blocks())

    def num_blocks(self) -> int:
        return len(self._inputs)

    def schema(self):
        first = self.take(1)
        if not first:
            return None
        row = first[0]
        if isinstance(row, dict):
            return {k: type(v).__name__ for k, v in row.items()}
        return type(row).__name__

    def columns(self) -> Optional[List[str]]:
        s = self.schema()
        return list(s.keys()) if isinstance(s, dict) else None

    # ----------------------------------------------------------------- writes
    def _write(self, writer, dir_path: str, ext: str,
               return_meta: bool = False):
        from .filesystem import fs_join, resolve

        fs, _ = resolve(dir_path)
        fs.makedirs(dir_path)
        try:
            chain = self._narrow_chain()
            items = self._frontier()
        except ValueError:
            chain = []
            items = list(self._execute())
        refs = [
            _write_block.remote(
                item, chain, writer,
                fs_join(dir_path, f"block-{i:05d}{ext}"),
            )
            for i, item in enumerate(items)
        ]
        metas = ray_tpu_torch.get(refs, timeout=600)
        if return_meta:
            return metas
        return [m["path"] for m in metas]

    def write_datasink(self, sink, dir_path: str, *,
                       return_meta: bool = False) -> List:
        """Write every block through a ``Datasink`` (reference: ray
        ``Dataset.write_datasink``): per-block writes fan out as tasks,
        then the sink's driver-side ``on_write_complete`` commit runs."""
        paths_meta = self._write(sink.write_block, dir_path, sink.extension,
                                 return_meta=True)
        sink.on_write_complete(paths_meta)
        if return_meta:
            return paths_meta
        return [m["path"] for m in paths_meta]

    def write_parquet(self, dir_path: str) -> List[str]:
        from .datasink import ParquetDatasink

        return self.write_datasink(ParquetDatasink(), dir_path)

    def write_csv(self, dir_path: str) -> List[str]:
        from .datasink import CSVDatasink

        return self.write_datasink(CSVDatasink(), dir_path)

    def write_json(self, dir_path: str) -> List[str]:
        from .datasink import JSONDatasink

        return self.write_datasink(JSONDatasink(), dir_path)

    def write_numpy(self, dir_path: str) -> List[str]:
        from .datasink import NumpyDatasink

        return self.write_datasink(NumpyDatasink(), dir_path)

    def write_tfrecords(self, dir_path: str) -> List[str]:
        from .datasink import TFRecordsDatasink

        return self.write_datasink(TFRecordsDatasink(), dir_path)

    def write_avro(self, dir_path: str, *, schema: Optional[dict] = None,
                   codec: str = "null") -> List[str]:
        from .datasink import AvroDatasink

        return self.write_datasink(AvroDatasink(schema, codec), dir_path)

    def write_webdataset(self, dir_path: str) -> List[str]:
        from .datasink import WebDatasetDatasink

        return self.write_datasink(WebDatasetDatasink(), dir_path)

    def write_sql(self, table: str, connection_factory, *,
                  paramstyle: str = "qmark") -> int:
        """INSERT every row into a DB-API table; returns rows written.
        The sink creates no files — the write dir is only a task label."""
        from .datasink import SQLDatasink

        import tempfile

        metas = self.write_datasink(
            SQLDatasink(table, connection_factory, paramstyle),
            tempfile.gettempdir(), return_meta=True,
        )
        return sum(m.get("rows", 0) for m in metas)

    def write_images(self, dir_path: str, *, column: str = "image",
                     format: str = "png") -> List[str]:
        """One image file per row; returns the files actually written
        (one per ROW — block-label paths would name no real file)."""
        from .datasink import ImageDatasink

        metas = self.write_datasink(ImageDatasink(column, format), dir_path,
                                    return_meta=True)
        return [f for m in metas for f in m.get("files", [])]

    def to_arrow(self):
        """Materialize as ONE pyarrow.Table (zero-copy for primitive
        columnar columns — see ray_tpu_torch.data.arrow)."""
        from .arrow import dataset_to_arrow

        return dataset_to_arrow(self)

    def to_pandas(self):
        """Materialize as ONE pandas.DataFrame (via the Arrow bridge)."""
        from .interop import dataset_to_pandas

        return dataset_to_pandas(self)

    # --------------------------------------------------------------- splits
    def split(self, n: int) -> List["Dataset"]:
        """Split into n datasets.  A purely-narrow plan splits its *source*
        blocks and each shard re-applies the (lazy) chain; otherwise the
        plan is executed first."""
        try:
            chain = self._narrow_chain()
            items = self._frontier()
            refs = _ensure_refs(items, [])
            stages = self._stages
        except ValueError:
            refs = list(self._execute())
            stages = []
            chain = []
        groups: List[List] = [[] for _ in range(n)]
        for i, ref in enumerate(refs):
            groups[i % n].append(ref)
        return [Dataset(g, stages, self._options) for g in groups]

    def streaming_split(self, n: int) -> List["DataIterator"]:
        """Per-trainer shards (reference: ray ``data/dataset.py:1881``)."""
        return [DataIterator(ds) for ds in self.split(n)]

    def __repr__(self):
        return (
            f"Dataset(blocks={len(self._inputs)}, "
            f"stages={[getattr(s, 'name', '?') for s in self._stages]})"
        )


class DataIterator:
    """A consumable shard handed to one training worker.  Pickles the
    shard's block refs + lazy transform chain; transforms run in the
    consuming worker (data-local, reference
    ``_internal/iterator/stream_split_iterator.py:35``)."""

    def __init__(self, dataset: Dataset):
        self._dataset = dataset

    def iter_batches(self, batch_size: int = 256, *, batch_format: str = "default",
                     drop_last: bool = False):
        return self._dataset.iter_batches(
            batch_size, batch_format=batch_format, drop_last=drop_last
        )

    def iter_rows(self):
        return self._dataset.iter_rows()

    def count(self) -> int:
        return self._dataset.count()

    def __reduce__(self):
        return (DataIterator, (self._dataset,))


# ------------------------------------------------------------------ sources
def read_datasource(ds: Datasource, parallelism: int = 8) -> Dataset:
    return Dataset(ds.get_read_tasks(parallelism), [])


def from_blocks(blocks: Sequence[Any]) -> Dataset:
    """Dataset over pre-built blocks (ColumnarBlock or row lists)."""
    return Dataset(list(blocks), [])


def from_items(items: Sequence[Any], parallelism: int = 8) -> Dataset:
    return read_datasource(ItemsDatasource(items), parallelism)


def range_dataset(n: int, parallelism: int = 8) -> Dataset:
    return read_datasource(RangeDatasource(n), parallelism)


def read_numpy(arrays: Dict[str, np.ndarray], parallelism: int = 8) -> Dataset:
    return read_datasource(NumpyDatasource(arrays), parallelism)


def read_parquet(path: str, parallelism: int = 8,
                 columns: Optional[List[str]] = None) -> Dataset:
    return read_datasource(ParquetDatasource(path, columns), parallelism)


def read_csv(path: str, parallelism: int = 8) -> Dataset:
    return read_datasource(CSVDatasource(path), parallelism)


def read_json(path: str, parallelism: int = 8) -> Dataset:
    return read_datasource(JSONDatasource(path), parallelism)


def read_binary_files(path: str, parallelism: int = 8) -> Dataset:
    return read_datasource(BinaryFilesDatasource(path), parallelism)


def read_text(path: str, parallelism: int = 8) -> Dataset:
    return read_datasource(TextDatasource(path), parallelism)


def read_images(path: str, parallelism: int = 8, *,
                size: Optional[tuple] = None, mode: str = "RGB") -> Dataset:
    """Decode image files into ``{"image": HxWxC uint8 ndarray, "path"}``
    rows (reference ``data/datasource/image_datasource.py``).  Non-image
    files in the directory are skipped; ``size`` resizes on read (the
    usual ingest normalization)."""
    from .datasource import ImageFilesDatasource

    def decode(row):
        import io

        from PIL import Image

        img = Image.open(io.BytesIO(row["bytes"])).convert(mode)
        if size is not None:
            img = img.resize(size)
        return {"image": np.asarray(img), "path": row["path"]}

    return read_datasource(ImageFilesDatasource(path), parallelism).map(decode)


def read_tfrecords(path: str, parallelism: int = 8) -> Dataset:
    """tf.train.Example TFRecord files → dict rows, WITHOUT a TensorFlow
    dependency (ray's tfrecords_datasource imports TF; a JAX-first stack
    parses the framing + proto directly — see ``data/tfrecord.py``)."""
    from .datasource import TFRecordsDatasource

    return read_datasource(TFRecordsDatasource(path), parallelism)


def read_avro(path: str, parallelism: int = 8) -> Dataset:
    """Avro object-container files → dict rows, dependency-free (ray's
    avro_datasource imports fastavro; the framing + binary codec are
    hand-rolled in ``data/avro.py``)."""
    from .datasource import AvroDatasource

    return read_datasource(AvroDatasource(path), parallelism)


def read_webdataset(path: str, parallelism: int = 8) -> Dataset:
    """WebDataset tar shards → one row per sample (``__key__`` + one
    column per member extension); stdlib-tarfile implementation — see
    ``WebDatasetDatasource``."""
    from .datasource import WebDatasetDatasource

    return read_datasource(WebDatasetDatasource(path), parallelism)


def read_audio(path: str, parallelism: int = 8) -> Dataset:
    """PCM WAV files → ``{"audio", "sample_rate", "path"}`` rows
    (stdlib ``wave`` decode — see ``AudioDatasource``)."""
    from .datasource import AudioDatasource

    return read_datasource(AudioDatasource(path), parallelism)


def read_videos(path: str, parallelism: int = 8, *,
                stride: int = 1) -> Dataset:
    """Video files → one row per (strided) frame via OpenCV — see
    ``VideoDatasource``."""
    from .datasource import VideoDatasource

    return read_datasource(VideoDatasource(path, stride), parallelism)


def read_mongo(collection_factory, parallelism: int = 8, *,
               filter: Optional[dict] = None,
               projection: Optional[dict] = None) -> Dataset:
    """Rows from a MongoDB collection (pymongo-duck ``collection_factory``
    runs inside read tasks; shards by skip/limit windows)."""
    from .warehouse import MongoDatasource

    return read_datasource(
        MongoDatasource(
            collection_factory, filter=filter, projection=projection
        ),
        parallelism,
    )


def read_bigquery(client_factory, sql: str, parallelism: int = 8, *,
                  shard_expr: Optional[str] = None) -> Dataset:
    """Rows from a BigQuery query (google-cloud-bigquery-duck client)."""
    from .warehouse import BigQueryDatasource

    return read_datasource(
        BigQueryDatasource(client_factory, sql, shard_expr=shard_expr),
        parallelism,
    )


def read_clickhouse(client_factory, sql: str, parallelism: int = 8, *,
                    shard_key: Optional[str] = None) -> Dataset:
    """Rows from ClickHouse (clickhouse-driver-duck client)."""
    from .warehouse import ClickHouseDatasource

    return read_datasource(
        ClickHouseDatasource(client_factory, sql, shard_key=shard_key),
        parallelism,
    )


def read_kafka(consumer_factory, topic: str, parallelism: int = 8, *,
               max_messages_per_partition: int = 1_000_000) -> Dataset:
    """Bounded snapshot of a Kafka topic, one read task per partition."""
    from .warehouse import KafkaDatasource

    return read_datasource(
        KafkaDatasource(
            consumer_factory, topic,
            max_messages_per_partition=max_messages_per_partition,
        ),
        parallelism,
    )


def read_iceberg(table_path: str, parallelism: int = 8, *,
                 snapshot_id: Optional[int] = None,
                 columns: Optional[List[str]] = None) -> Dataset:
    """An Apache Iceberg table read from its on-disk metadata chain (no
    SDK; append-only v1/v2 subset — see ``data/warehouse.py``)."""
    from .warehouse import IcebergDatasource

    return read_datasource(
        IcebergDatasource(
            table_path, snapshot_id=snapshot_id, columns=columns
        ),
        parallelism,
    )


def read_sql(sql: str, connection_factory, parallelism: int = 8, *,
             shard_key: Optional[str] = None) -> Dataset:
    """Rows from any DB-API 2.0 database.  ``connection_factory`` must be
    a picklable zero-arg callable (connections open inside read tasks);
    pass ``shard_key`` (an integer column) to split the query across
    ``parallelism`` tasks."""
    from .datasource import SQLDatasource

    return read_datasource(
        SQLDatasource(sql, connection_factory, shard_key), parallelism
    )

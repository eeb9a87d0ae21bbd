"""Distributed hash joins for Datasets.

Reference: ray ``python/ray/data/_internal/execution/operators/join.py`` +
``hash_shuffle.py`` — both sides of the join are hash-partitioned on the
key into N partitions (a two-sided exchange over ``num_returns=N`` map
tasks), then one reduce task per partition builds a hash table from its
right-side rows and probes it with its left-side rows.  Inner and left
joins ship first (the reference's ``JoinType``); the reduce is
partition-local so join memory is bounded by the largest partition, not
the dataset.
"""

from __future__ import annotations

from typing import List, Optional

import ray_tpu_torch

from .block import Block, row_key, stable_hash


@ray_tpu_torch.remote
def _join_partition_map(item, transforms, n_out: int, key) -> List[Block]:
    """Hash-partition one block's rows by join key into n_out partitions."""
    from .execution import HashPartition, apply_chain
    from .block import ColumnarBlock

    block = apply_chain(item, transforms)
    if isinstance(block, ColumnarBlock) and isinstance(key, str):
        # Vectorized fast path (same scalar/vector hash equality contract
        # as the shuffle map): numeric key columns partition in numpy.
        pidx = HashPartition(key).vector_parts(block, n_out, 0)
        if pidx is not None:
            from .block import partition_columnar

            cparts = partition_columnar(block, pidx, n_out)
            return cparts if n_out > 1 else cparts[0]
    parts: List[Block] = [[] for _ in range(n_out)]
    for row in block:
        # stable_hash, NOT builtin hash(): str hashing is seed-randomized
        # per process, and the two sides partition in different workers.
        parts[stable_hash(row_key(row, key)) % n_out].append(row)
    # num_returns=1 returns the value VERBATIM (no list splitting), so a
    # single-partition exchange must return the bare block — the nested
    # [rows] wrapper made every 1-partition join iterate lists as "rows".
    return parts if n_out > 1 else parts[0]


@ray_tpu_torch.remote
def _join_reduce(
    how: str, left_key, right_key, n_left: int, *parts: Block
) -> Block:
    """Join one partition: build on the right side, probe with the left."""
    left_rows = [r for p in parts[:n_left] for r in p]
    right_rows = [r for p in parts[n_left:] for r in p]
    table: dict = {}
    for row in right_rows:
        table.setdefault(row_key(row, right_key), []).append(row)
    out: Block = []
    for lrow in left_rows:
        matches = table.get(row_key(lrow, left_key))
        if matches:
            for rrow in matches:
                if isinstance(lrow, dict) and isinstance(rrow, dict):
                    out.append({**rrow, **lrow})  # left wins column clashes
                else:
                    out.append((lrow, rrow))
        elif how == "left":
            out.append(dict(lrow) if isinstance(lrow, dict) else (lrow, None))
    return out


class JoinStage:
    """Two-sided exchange stage.  Consumes the left stream; the right
    dataset executes its own plan and feeds the same partition space."""

    def __init__(self, right_ds, on, right_on=None, how: str = "inner",
                 num_partitions: Optional[int] = None):
        if how not in ("inner", "left"):
            raise ValueError(f"unsupported join type {how!r}")
        self.right_ds = right_ds
        self.on = on
        self.right_on = right_on if right_on is not None else on
        self.how = how
        self.num_partitions = num_partitions
        self.fused_transforms: List = []

    @property
    def name(self) -> str:
        return f"Join[{self.how}]"

    def with_fused(self, transforms):
        copy = JoinStage(
            self.right_ds, self.on, self.right_on, self.how,
            self.num_partitions,
        )
        copy.fused_transforms = list(transforms)
        return copy

    def run(self, upstream, stats):
        from .execution import OpStats

        st = OpStats(self.name)
        stats.append(st)
        left_items = list(upstream)  # barrier (exchange)
        right_items = list(self.right_ds._execute())
        n_out = self.num_partitions or max(1, len(left_items))

        def partition(items, transforms, key):
            out = []
            for item in items:
                st.num_tasks += 1
                refs = _join_partition_map.options(num_returns=n_out).remote(
                    item, transforms, n_out, key
                )
                out.append([refs] if n_out == 1 else refs)
            return out

        left_parts = partition(left_items, self.fused_transforms, self.on)
        right_parts = partition(right_items, [], self.right_on)
        for j in range(n_out):
            st.num_tasks += 1
            lp = [left_parts[i][j] for i in range(len(left_parts))]
            rp = [right_parts[i][j] for i in range(len(right_parts))]
            yield _join_reduce.remote(
                self.how, self.on, self.right_on, len(lp), *lp, *rp
            )

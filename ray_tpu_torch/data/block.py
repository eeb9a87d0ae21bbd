"""Block utilities.

A *block* is the unit of parallelism.  Two physical layouts exist, mirroring
the reference's Arrow-table blocks (ray ``python/ray/data/block.py``,
``_internal/arrow_block.py``) without an Arrow dependency on the hot path:

  - row blocks: a list of rows (dicts / scalars / arrays) — the layout
    row-level transforms (map/filter/flat_map, shuffles) operate on;
  - ``ColumnarBlock``: a dict of equal-length numpy column arrays — the
    layout batch pipelines (parquet → map_batches → iter_batches) stay in
    end-to-end.  Batch views and slices are zero-copy (numpy views), the
    object-store representation ships the arrays through pickle-5
    out-of-band buffers, and per-row Python objects are materialized only
    if a row-level transform actually iterates.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Union

import numpy as np


class ColumnarBlock:
    """Columnar block: ``{column: np.ndarray}`` with one shared length.

    Quacks like a row sequence (len / iteration / int indexing / slicing)
    so every row-oriented code path works unchanged; columnar-aware paths
    (``to_batch("numpy")``, select/projection, batch slicing) skip row
    materialization entirely.
    """

    __slots__ = ("columns", "_n")

    def __init__(self, columns: Dict[str, np.ndarray]):
        self.columns = {k: np.asarray(v) for k, v in columns.items()}
        self._n = len(next(iter(self.columns.values()))) if self.columns else 0

    def __len__(self) -> int:
        return self._n

    def __iter__(self) -> Iterator[dict]:
        keys = list(self.columns)
        cols = [self.columns[k] for k in keys]
        for i in range(self._n):
            yield {k: c[i] for k, c in zip(keys, cols)}

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return ColumnarBlock(
                {k: v[idx] for k, v in self.columns.items()}
            )
        return {k: v[idx] for k, v in self.columns.items()}

    def to_rows(self) -> List[dict]:
        return list(self)

    def select(self, cols: List[str]) -> "ColumnarBlock":
        return ColumnarBlock({c: self.columns[c] for c in cols})

    def __repr__(self):
        return f"ColumnarBlock({list(self.columns)}, n={self._n})"


Block = Union[List[Any], ColumnarBlock]
Batch = Union[List[Any], Dict[str, np.ndarray], np.ndarray]


def to_batch(rows: Block, batch_format: str) -> Batch:
    """Assemble a block into the requested batch format.

    ``"default"`` → the row list; ``"numpy"`` → dict of stacked column
    arrays for dict rows, or one stacked array for scalar/array rows (the
    shape trainers feed to jax.device_put).  Columnar blocks hand out their
    column dict as-is (zero-copy).
    """
    if isinstance(rows, ColumnarBlock):
        if batch_format == "numpy":
            return dict(rows.columns)
        if batch_format in ("default", "list"):
            return rows.to_rows()
        raise ValueError(f"unknown batch_format {batch_format!r}")
    if batch_format in ("default", "list"):
        return rows
    if batch_format == "numpy":
        if not rows:
            return {}
        if isinstance(rows[0], dict):
            return {
                k: np.asarray([r[k] for r in rows]) for k in rows[0].keys()
            }
        return np.asarray(rows)
    raise ValueError(f"unknown batch_format {batch_format!r}")


def from_batch(batch: Batch) -> Block:
    """Inverse of ``to_batch`` for map_batches UDFs that return numpy.
    Dict batches stay columnar — a numpy-batch pipeline never rowifies."""
    if isinstance(batch, ColumnarBlock):
        return batch
    if isinstance(batch, dict):
        if not batch:
            return []
        return ColumnarBlock(batch)
    if isinstance(batch, np.ndarray):
        return list(batch)
    return list(batch)


def block_num_rows(block: Block) -> int:
    return len(block)


def row_key(row: Any, key: Union[str, callable, None]):
    """Resolve a sort/group key: column name for dict rows, callable, or
    identity."""
    if key is None:
        return row
    if callable(key):
        return key(row)
    return row[key]


_MASK64 = (1 << 64) - 1
_FLOAT_TAG = 0xA5A5A5A5A5A5A5A5  # float bits != int of same value


def _splitmix64(x: int) -> int:
    """Scalar splitmix64 — bit-for-bit equal to the numpy version in
    ``hash_column`` (the equality is what keeps hash partitions
    consistent across columnar and row map tasks)."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def hash_column(arr: np.ndarray):
    """Vectorized ``stable_hash`` over a whole key column (uint64 array),
    or None when the dtype needs the scalar path (strings/objects/bool).

    The map side of a hash exchange is a per-row Python hash+append loop
    without this; with it, a columnar block partitions in a handful of
    numpy passes (the reference's hash shuffle partitions natively too —
    ``data/_internal/execution/operators/hash_shuffle.py``)."""
    if arr.dtype.kind in "iu":
        x = arr.astype(np.uint64)  # two's complement == (& _MASK64)
    elif arr.dtype.kind == "f":
        x = arr.astype(np.float64, copy=False).view(np.uint64) ^ np.uint64(
            _FLOAT_TAG
        )
    else:
        return None
    with np.errstate(over="ignore"):
        x = x + np.uint64(0x9E3779B97F4A7C15)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return x ^ (x >> np.uint64(31))


def partition_columnar(block, pidx, n_out: int):
    """Mask-slice a ColumnarBlock into n_out partition blocks; empty
    partitions ship as cheap [] placeholders.  The one implementation of
    the columnar exchange split (shuffle map and join map must never
    drift on it)."""
    parts = []
    for j in range(n_out):
        mask = pidx == j
        parts.append(
            ColumnarBlock({k: v[mask] for k, v in block.columns.items()})
            if mask.any() else []
        )
    return parts


def concat_columnar(parts):
    """Concatenate blocks column-wise, or None when any part is not a
    ColumnarBlock with the same column set (caller falls back to rows)."""
    parts = [p for p in parts if len(p)]
    if not parts or not all(isinstance(p, ColumnarBlock) for p in parts):
        return None
    cols = list(parts[0].columns)
    if not all(list(p.columns) == cols for p in parts[1:]):
        return None
    return ColumnarBlock(
        {k: np.concatenate([p.columns[k] for p in parts]) for k in cols}
    )


def stable_hash(value: Any) -> int:
    """Process-independent hash for exchange partitioning.  Python's builtin
    ``hash`` is seed-randomized per process for str/bytes, which would send
    the same key to different reducers from different map workers."""
    import hashlib
    import pickle

    # Numpy scalars (what ColumnarBlock row views yield) must hash like
    # their Python equivalents or parquet-sourced keys would never meet
    # row-sourced keys on the same reducer.
    if isinstance(value, np.generic):
        value = value.item()

    if isinstance(value, str):
        data = b"s" + value.encode()
    elif isinstance(value, bytes):
        data = b"b" + value
    elif isinstance(value, bool):
        data = b"o" + bytes([value])
    elif isinstance(value, int):
        # splitmix64, NOT a digest: numeric keys must hash identically on
        # the scalar path and hash_column's vectorized numpy path so
        # mixed columnar/row blocks in one exchange agree on partitions.
        return _splitmix64(value & _MASK64)
    elif isinstance(value, float):
        import struct

        bits = struct.unpack("<Q", struct.pack("<d", value))[0]
        return _splitmix64((bits ^ _FLOAT_TAG) & _MASK64)
    elif value is None:
        data = b"n"
    elif isinstance(value, tuple):
        data = b"t" + b"|".join(
            str(stable_hash(v)).encode() for v in value
        )
    else:
        data = b"p" + pickle.dumps(value)
    return int.from_bytes(hashlib.blake2b(data, digest_size=8).digest(), "big")

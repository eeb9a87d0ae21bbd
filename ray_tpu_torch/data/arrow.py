"""Arrow interop: zero-copy bridges between ColumnarBlock and pyarrow.

Reference: ray ``python/ray/data/_internal/arrow_block.py`` — blocks
interop with the Arrow ecosystem without copying where dtypes allow.
Primitive numeric/bool numpy columns share buffers with the Arrow arrays
in BOTH directions (``pa.array(np)`` wraps the numpy buffer; Arrow →
numpy uses ``zero_copy_only=True`` and falls back to a copy only for
types that need conversion, e.g. strings or chunked columns).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, List, Union

import numpy as np

from .block import Block, ColumnarBlock

if TYPE_CHECKING:  # pragma: no cover
    import pyarrow as pa


def block_to_arrow(block: Block) -> "pa.Table":
    """Block -> pyarrow.Table (zero-copy for primitive columnar columns)."""
    import pyarrow as pa

    if isinstance(block, ColumnarBlock):
        return pa.table(
            {k: pa.array(v) for k, v in block.columns.items()}
        )
    rows = [r if isinstance(r, dict) else {"value": r} for r in block]
    return pa.Table.from_pylist(rows)


def arrow_to_block(table: "pa.Table") -> ColumnarBlock:
    """pyarrow.Table -> ColumnarBlock (zero-copy where dtypes allow)."""
    columns = {}
    for name in table.column_names:
        col = table.column(name)
        if col.num_chunks == 1:
            chunk = col.chunk(0)
            try:
                columns[name] = chunk.to_numpy(zero_copy_only=True)
                continue
            except Exception:  # noqa: BLE001 — non-primitive: copy path
                pass
        columns[name] = col.to_numpy(zero_copy_only=False)
    return ColumnarBlock(columns)


def dataset_to_arrow(ds) -> "pa.Table":
    """Materialize a Dataset as ONE pyarrow.Table."""
    import pyarrow as pa

    tables = [block_to_arrow(b) for b in ds.iter_blocks()]
    # Empty blocks (e.g. fully filtered out) become zero-column tables
    # whose schema would fail concat_tables' schema check — drop them.
    non_empty = [t for t in tables if t.num_rows > 0]
    if not non_empty:
        return tables[0] if tables else pa.table({})
    return pa.concat_tables(non_empty)


def from_arrow(tables: Union["pa.Table", List["pa.Table"]]):
    """pyarrow.Table(s) -> Dataset of ColumnarBlocks (one block per
    table; zero-copy where dtypes allow)."""
    from .dataset import from_blocks

    import pyarrow as pa

    if isinstance(tables, pa.Table):
        tables = [tables]
    else:
        tables = list(tables)
    return from_blocks([arrow_to_block(t) for t in tables])

"""Datasink: the unified write abstraction.

Reference: ray ``python/ray/data/datasource/datasink.py`` +
``data/_internal/datasource/parquet_datasink.py`` (and csv/json peers) —
every ``Dataset.write_*`` funnels through one interface: per-block write
tasks fan out on the cluster, then a single ``on_write_complete`` commit
hook runs on the driver.

Sinks keep the columnar fast path: a ``ColumnarBlock`` writes straight
from its numpy columns (parquet: zero-copy into Arrow arrays) — no row
materialization on the write path either.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List

from .block import Block, ColumnarBlock


class Datasink:
    """One output format/destination.  Subclasses implement
    ``write_block`` (runs inside a worker task, must be picklable) and may
    override ``on_write_complete`` (driver-side commit)."""

    extension = ""

    def write_block(self, block: Block, path: str) -> Dict[str, Any]:
        """Write one block; return metadata (at least ``path``)."""
        raise NotImplementedError

    def on_write_complete(self, results: List[Dict[str, Any]]) -> None:
        """Driver-side commit hook after every block landed (manifest
        writes, renames, metadata registration)."""

    @staticmethod
    def _rows(block: Block) -> List[dict]:
        return [r if isinstance(r, dict) else {"value": r} for r in block]

    @staticmethod
    def _key_union(rows: List[dict]) -> List[str]:
        """Ordered union of row keys (heterogeneous rows allowed)."""
        keys: List[str] = []
        for r in rows:
            for k in r:
                if k not in keys:
                    keys.append(k)
        return keys


class ParquetDatasink(Datasink):
    extension = ".parquet"

    def write_block(self, block: Block, path: str) -> Dict[str, Any]:
        import pyarrow.parquet as pq

        from .arrow import block_to_arrow

        table = block_to_arrow(block)
        pq.write_table(table, path)
        return {"path": path, "rows": table.num_rows}


class CSVDatasink(Datasink):
    extension = ".csv"

    def write_block(self, block: Block, path: str) -> Dict[str, Any]:
        import csv

        rows = self._rows(block)
        keys = self._key_union(rows)
        with open(path, "w", newline="") as f:
            if rows:
                writer = csv.DictWriter(f, fieldnames=keys, restval="")
                writer.writeheader()
                writer.writerows(rows)
        return {"path": path, "rows": len(rows)}


class JSONDatasink(Datasink):
    extension = ".jsonl"

    def write_block(self, block: Block, path: str) -> Dict[str, Any]:
        import json

        n = 0
        with open(path, "w") as f:
            for r in block:
                f.write(json.dumps(r, default=str) + "\n")
                n += 1
        return {"path": path, "rows": n}


class NumpyDatasink(Datasink):
    """One ``.npz`` per block: columnar blocks store their columns
    verbatim; row blocks stack a ``value`` array."""

    extension = ".npz"

    def write_block(self, block: Block, path: str) -> Dict[str, Any]:
        import numpy as np

        if isinstance(block, ColumnarBlock):
            np.savez(path, **block.columns)
            return {"path": path, "rows": len(block)}
        rows = self._rows(block)
        keys = self._key_union(rows)
        np.savez(
            path,
            **{k: np.asarray([r.get(k) for r in rows]) for k in keys},
        )
        return {"path": path, "rows": len(rows)}


class TFRecordsDatasink(Datasink):
    """tf.train.Example TFRecord files, TF-free (codec shared with the
    read path in ``data/tfrecord.py``; reference ``tfrecords_datasink.py``
    imports TensorFlow)."""

    extension = ".tfrecord"

    def write_block(self, block: Block, path: str) -> Dict[str, Any]:
        from .tfrecord import write_tfrecord_file

        rows = self._rows(block)
        write_tfrecord_file(rows, path)
        return {"path": path, "rows": len(rows)}


class AvroDatasink(Datasink):
    """Avro object-container files (codec in ``data/avro.py``).  Schema is
    inferred per block unless pinned at construction — pin it when blocks
    may be heterogeneous."""

    extension = ".avro"

    def __init__(self, schema: Dict[str, Any] = None, codec: str = "null"):
        self.schema = schema
        self.codec = codec

    def write_block(self, block: Block, path: str) -> Dict[str, Any]:
        from .avro import write_avro_file

        rows = self._rows(block)
        write_avro_file(rows, path, schema=self.schema, codec=self.codec)
        return {"path": path, "rows": len(rows)}


class WebDatasetDatasink(Datasink):
    """One ``.tar`` shard per block (reference ``webdataset_datasink.py``).
    Rows are WebDataset samples: ``__key__`` names the sample, every other
    column becomes a tar member ``<key>.<column>``; bytes pass through,
    str utf-8-encodes, anything else JSON-encodes."""

    extension = ".tar"

    def write_block(self, block: Block, path: str) -> Dict[str, Any]:
        import io
        import json
        import tarfile

        rows = self._rows(block)
        with tarfile.open(path, "w") as tf:
            for i, row in enumerate(rows):
                key = str(row.get("__key__", f"{i:08d}"))
                for col, value in row.items():
                    if col == "__key__":
                        continue
                    if isinstance(value, (bytes, bytearray)):
                        data = bytes(value)
                    elif isinstance(value, str):
                        data = value.encode()
                    else:
                        data = json.dumps(value, default=str).encode()
                    info = tarfile.TarInfo(f"{key}.{col}")
                    info.size = len(data)
                    tf.addfile(info, io.BytesIO(data))
        return {"path": path, "rows": len(rows)}


class SQLDatasink(Datasink):
    """INSERT every row into a DB-API table (reference
    ``sql_datasink.py``).  ``connection_factory`` runs inside the write
    task; one connection + one executemany per block.  ``paramstyle``
    must match the driver ("qmark" for sqlite3, "format"/"pyformat" for
    postgres/mysql drivers) — DB-API placeholders are per-module and
    undiscoverable from a connection object."""

    extension = ""  # no files — "path" is only a task label

    def __init__(self, table: str, connection_factory,
                 paramstyle: str = "qmark"):
        self.table = table
        self.factory = connection_factory
        self.paramstyle = paramstyle

    def write_block(self, block: Block, path: str) -> Dict[str, Any]:
        rows = self._rows(block)
        if not rows:
            return {"path": path, "rows": 0}
        keys = self._key_union(rows)
        conn = self.factory()
        try:
            ph = {"qmark": "?", "format": "%s", "pyformat": "%s",
                  "numeric": None}.get(self.paramstyle)
            if ph is None:
                raise ValueError(
                    f"unsupported paramstyle {self.paramstyle!r} "
                    "(use qmark/format/pyformat)"
                )
            placeholders = ", ".join([ph] * len(keys))
            sql = (
                f"INSERT INTO {self.table} ({', '.join(keys)}) "
                f"VALUES ({placeholders})"
            )
            conn.cursor().executemany(
                sql, [tuple(r.get(k) for k in keys) for r in rows]
            )
            conn.commit()
        finally:
            conn.close()
        return {"path": path, "rows": len(rows)}


class ImageDatasink(Datasink):
    """One image file per row via PIL (reference ``image_datasink.py``).
    Rows carry an HxWxC uint8 array in ``column`` (default ``image``);
    filenames come from a ``path`` column's basename when present."""

    extension = ""  # writes one file per ROW; block path becomes a prefix

    def __init__(self, column: str = "image", format: str = "png"):
        self.column = column
        self.format = format

    def write_block(self, block: Block, path: str) -> Dict[str, Any]:
        import numpy as np
        from PIL import Image

        files = []
        seen = set()
        for i, row in enumerate(self._rows(block)):
            arr = np.asarray(row[self.column])
            if "path" in row:
                stem = os.path.splitext(os.path.basename(str(row["path"])))[0]
                if stem in seen:  # two source dirs, same basename
                    stem = f"{stem}-{i:06d}"
            else:
                stem = f"{i:06d}"
            seen.add(stem)
            out = f"{path}-{stem}.{self.format}"
            Image.fromarray(arr).save(out)
            files.append(out)
        # "path" stays the block label (the write plumbing keys on it);
        # the files actually written are their own field.
        return {"path": path, "rows": len(files), "files": files}


class ManifestedDatasink(Datasink):
    """Wrap any sink with a commit manifest: the output directory gains a
    ``_MANIFEST.json`` listing every part file, written LAST — readers
    that require the manifest never observe a partial write (the
    manifest-last commit protocol the checkpoint layer also uses)."""

    def __init__(self, inner: Datasink):
        self.inner = inner
        self.extension = inner.extension

    def write_block(self, block: Block, path: str) -> Dict[str, Any]:
        return self.inner.write_block(block, path)

    def on_write_complete(self, results: List[Dict[str, Any]]) -> None:
        import json

        from .filesystem import is_uri, resolve

        self.inner.on_write_complete(results)
        if not results:
            return
        first = results[0]["path"]
        sep = "/" if is_uri(first) else os.sep
        out_dir = first.rsplit(sep, 1)[0]
        manifest = {
            "parts": [r["path"].rsplit(sep, 1)[-1] for r in results],
            # _write_block guarantees num_rows; sinks may also set rows.
            "rows": sum(
                r.get("rows", r.get("num_rows", 0)) for r in results
            ),
        }
        fs, _ = resolve(out_dir)
        # write_bytes is atomic per-file on every backend (local: tmp +
        # rename; KV: single put) — the manifest-last commit survives.
        fs.write_bytes(
            fs.join(out_dir, "_MANIFEST.json"),
            json.dumps(manifest).encode(),
        )

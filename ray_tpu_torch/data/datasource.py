"""Datasources: lazy read tasks + file-based write paths.

Reference: ray ``python/ray/data/datasource/`` — a ``Datasource`` yields
``ReadTask``s (serializable zero-arg callables producing blocks) so reads
execute *inside remote tasks*, in parallel, instead of on the driver; writes
emit one file per block via remote tasks.
"""

from __future__ import annotations

import glob as _glob
import os
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from .block import Block


class ReadTask:
    """A serializable unit of read work (reference ``ReadTask``:
    ``python/ray/data/datasource/datasource.py``)."""

    def __init__(self, fn: Callable[[], Block], metadata: Optional[dict] = None):
        self._fn = fn
        self.metadata = metadata or {}

    def __call__(self) -> Block:
        return self._fn()


class Datasource:
    """ABC: implement ``get_read_tasks(parallelism)``."""

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        raise NotImplementedError

    def estimate_inmemory_data_size(self) -> Optional[int]:
        return None


# ----------------------------------------------------------------- in-memory
class ItemsDatasource(Datasource):
    def __init__(self, items: Sequence[Any]):
        self._items = list(items)

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        items = self._items
        n = max(1, min(parallelism, len(items) or 1))
        size = (len(items) + n - 1) // n
        tasks = []
        for i in range(n):
            chunk = items[i * size : (i + 1) * size]
            if not chunk and items:
                continue  # ceil-division can leave empty trailing chunks
            tasks.append(
                ReadTask(lambda c=chunk: list(c), {"num_rows": len(chunk)})
            )
        return tasks


class RangeDatasource(Datasource):
    def __init__(self, n: int):
        self._n = n

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        n = self._n
        k = max(1, min(parallelism, n or 1))
        size = (n + k - 1) // k
        tasks = []
        for i in range(k):
            lo, hi = i * size, min((i + 1) * size, n)
            if lo >= hi:
                continue
            tasks.append(
                ReadTask(
                    lambda a=lo, b=hi: list(range(a, b)),
                    {"num_rows": hi - lo},
                )
            )
        return tasks


class NumpyDatasource(Datasource):
    """Columnar dict of arrays → row blocks."""

    def __init__(self, arrays: Dict[str, np.ndarray]):
        self._arrays = {k: np.asarray(v) for k, v in arrays.items()}

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        arrays = self._arrays
        n_rows = len(next(iter(arrays.values()))) if arrays else 0
        k = max(1, min(parallelism, n_rows or 1))
        size = (n_rows + k - 1) // k
        tasks = []
        for i in range(k):
            lo, hi = i * size, min((i + 1) * size, n_rows)
            if lo >= hi:
                continue
            chunk = {c: v[lo:hi] for c, v in arrays.items()}
            tasks.append(
                ReadTask(
                    lambda ch=chunk: [
                        {c: v[j] for c, v in ch.items()}
                        for j in range(len(next(iter(ch.values()))))
                    ],
                    {"num_rows": hi - lo},
                )
            )
        return tasks


# --------------------------------------------------------------------- files
def _expand_paths(path: str, suffix: str = "") -> List[str]:
    """A path may be a file, a directory, or a glob — local or any
    registered URI scheme (``file://``, ``memory://``, mounted ``gs://``;
    see ``data/filesystem.py``)."""
    from .filesystem import resolve

    fs, p = resolve(path)
    if fs.isdir(p):
        return fs.glob(fs.join(p, f"*{suffix}" if suffix else "*"))
    matches = fs.glob(p)
    return matches or [path]


def _local(path: str) -> str:
    """Materialize a possibly-remote file as a real OS path (identity for
    local paths).  Runs INSIDE read tasks, on whichever worker executes
    them."""
    from .filesystem import ensure_local

    return ensure_local(path)


def _table_to_columnar(table):
    """pyarrow Table → ColumnarBlock (numpy columns; zero-copy where the
    arrow buffer layout allows, object arrays for strings/nested)."""
    from .block import ColumnarBlock

    cols = {}
    for name in table.column_names:
        col = table.column(name)
        try:
            cols[name] = col.to_numpy(zero_copy_only=False)
        except Exception:  # noqa: BLE001 — exotic nested types
            cols[name] = np.asarray(col.to_pylist(), dtype=object)
    return ColumnarBlock(cols)


class ParquetReadTask(ReadTask):
    """Parquet read with pushdown hooks: the plan optimizer can narrow the
    read to a column subset (projection pushdown) and/or attach a row
    predicate (filter pushdown) — reference
    ``data/_internal/logical/rules/`` projection/filter pushdown into
    ParquetDatasource."""

    def __init__(self, path: str, row_group: Optional[int] = None,
                 columns: Optional[List[str]] = None,
                 filters: Optional[list] = None,
                 metadata: Optional[dict] = None):
        self.path = path
        self.row_group = row_group
        self.columns = columns
        self.filters = filters
        super().__init__(self._read, metadata)

    def with_projection(self, cols: List[str]) -> "ParquetReadTask":
        merged = (
            [c for c in self.columns if c in cols]
            if self.columns is not None
            else list(cols)
        )
        return ParquetReadTask(
            self.path, self.row_group, merged, self.filters, dict(self.metadata)
        )

    def with_predicate(self, filters: list) -> "ParquetReadTask":
        return ParquetReadTask(
            self.path, self.row_group, self.columns,
            (self.filters or []) + list(filters), dict(self.metadata),
        )

    def _read(self):
        import pyarrow.parquet as pq

        path = _local(self.path)
        if self.filters is not None:
            import pyarrow.compute as pc
            import pyarrow.dataset as pads

            # Dataset API: row-exact predicate evaluation during the scan.
            expr = None
            for col, op, val in self.filters:
                field = pc.field(col)
                term = {
                    "==": field == val, "!=": field != val,
                    ">": field > val, ">=": field >= val,
                    "<": field < val, "<=": field <= val,
                }[op]
                expr = term if expr is None else (expr & term)
            ds = pads.dataset(path)
            if self.row_group is not None:
                frag = list(ds.get_fragments())[0]
                frag = frag.subset(row_group_ids=[self.row_group])
                table = frag.to_table(filter=expr, columns=self.columns)
            else:
                table = ds.to_table(filter=expr, columns=self.columns)
            return _table_to_columnar(table)
        if self.row_group is not None:
            table = pq.ParquetFile(path).read_row_group(
                self.row_group, columns=self.columns
            )
        else:
            table = pq.read_table(path, columns=self.columns)
        return _table_to_columnar(table)

    def __reduce__(self):
        return (
            ParquetReadTask,
            (self.path, self.row_group, self.columns, self.filters,
             self.metadata),
        )


class ParquetDatasource(Datasource):
    """One read task per file (row-group granularity when a single file).
    Emits columnar blocks."""

    def __init__(self, path: str, columns: Optional[List[str]] = None):
        self._paths = _expand_paths(path, ".parquet")
        self._columns = columns

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        cols = self._columns
        if len(self._paths) == 1 and parallelism > 1:
            import pyarrow.parquet as pq

            # Split one file by row group so a single large file still
            # parallelizes.  (Metadata probe localizes remote files once
            # on the driver; the row-group reads localize per task.)
            path = self._paths[0]
            n_groups = pq.ParquetFile(_local(path)).num_row_groups
            return [
                ParquetReadTask(
                    path, g, cols, None, {"path": path, "row_group": g}
                )
                for g in range(n_groups)
            ]
        return [
            ParquetReadTask(path, None, cols, None, {"path": path})
            for path in self._paths
        ]


class CSVDatasource(Datasource):
    def __init__(self, path: str):
        self._paths = _expand_paths(path, ".csv")

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        tasks = []
        for path in self._paths:
            def read(p=path):
                import csv  # noqa: PLC0415

                with open(_local(p)) as f:
                    return list(csv.DictReader(f))

            tasks.append(ReadTask(read, {"path": path}))
        return tasks


class JSONDatasource(Datasource):
    """JSON-lines files."""

    def __init__(self, path: str):
        self._paths = _expand_paths(path, ".jsonl")

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        tasks = []
        for path in self._paths:
            def read(p=path):
                import json  # noqa: PLC0415

                out = []
                with open(_local(p)) as f:
                    for line in f:
                        line = line.strip()
                        if line:
                            out.append(json.loads(line))
                return out

            tasks.append(ReadTask(read, {"path": path}))
        return tasks


class TFRecordsDatasource(Datasource):
    """tf.train.Example TFRecord files, TF-free (codec in
    ``data/tfrecord.py``).  Matches both ``.tfrecord`` and ``.tfrecords``."""

    def __init__(self, path: str):
        from .filesystem import resolve

        paths = _expand_paths(path, ".tfrecord")
        if resolve(path)[0].isdir(path):
            paths = sorted(
                set(paths) | set(_expand_paths(path, ".tfrecords"))
            )
        self._paths = paths

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        from .tfrecord import read_tfrecord_file

        return [
            ReadTask(lambda p=p: read_tfrecord_file(_local(p)), {"path": p})
            for p in self._paths
        ]


IMAGE_SUFFIXES = (".png", ".jpg", ".jpeg", ".bmp", ".gif", ".webp", ".tiff")


class ImageFilesDatasource(Datasource):
    """Image files → ``{"path", "bytes"}`` rows, filtered to image
    extensions so a stray README/checksum in the directory can't fail the
    read (reference image_datasource filters the same way)."""

    def __init__(self, path: str):
        self._paths = [
            p for p in _expand_paths(path)
            if p.lower().endswith(IMAGE_SUFFIXES)
        ]

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        k = max(1, min(parallelism, len(self._paths) or 1))
        size = (len(self._paths) + k - 1) // k
        tasks = []
        for i in range(k):
            chunk = self._paths[i * size : (i + 1) * size]
            if not chunk:
                continue

            def read(paths=chunk):
                out = []
                for p in paths:
                    with open(_local(p), "rb") as f:
                        out.append({"path": p, "bytes": f.read()})
                return out

            tasks.append(ReadTask(read, {"num_files": len(chunk)}))
        return tasks


class BinaryFilesDatasource(Datasource):
    """Rows of ``{"path", "bytes"}`` — the image/webdataset substrate."""

    def __init__(self, path: str):
        self._paths = _expand_paths(path)

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        k = max(1, min(parallelism, len(self._paths) or 1))
        size = (len(self._paths) + k - 1) // k
        tasks = []
        for i in range(k):
            chunk = self._paths[i * size : (i + 1) * size]
            if not chunk:
                continue

            def read(paths=chunk):
                out = []
                for p in paths:
                    with open(_local(p), "rb") as f:
                        out.append({"path": p, "bytes": f.read()})
                return out

            tasks.append(ReadTask(read, {"num_files": len(chunk)}))
        return tasks


class TextDatasource(Datasource):
    """One row per line across the matched files."""

    def __init__(self, path: str):
        self._paths = _expand_paths(path)

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        tasks = []
        for path in self._paths:
            def read(p=path):
                with open(_local(p)) as f:
                    return [line.rstrip("\n") for line in f]

            tasks.append(ReadTask(read, {"path": path}))
        return tasks


class AvroDatasource(Datasource):
    """Avro object-container files, dependency-free (codec in
    ``data/avro.py``; reference ``avro_datasource.py`` uses fastavro)."""

    def __init__(self, path: str):
        self._paths = _expand_paths(path, ".avro")

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        from .avro import read_avro_file

        return [
            ReadTask(lambda p=p: read_avro_file(_local(p)), {"path": p})
            for p in self._paths
        ]


def decode_wds_member(name: str, data: bytes):
    """WebDataset per-extension auto-decode: .json → object, .txt → str,
    .cls → int label, everything else (incl. images) raw bytes."""
    if name.endswith(".json"):
        import json

        return json.loads(data)
    if name.endswith((".txt", ".text")):
        return data.decode()
    if name.endswith(".cls"):
        return int(data.decode().strip())
    return data


class WebDatasetDatasource(Datasource):
    """POSIX-tar sample archives (reference ``webdataset_datasource.py``,
    which wraps the ``webdataset`` package; hand-rolled on stdlib tarfile
    here).  Members sharing a basename form one sample: ``x/y.jpg`` +
    ``x/y.cls`` + ``x/y.json`` → one row ``{"__key__": "x/y", "jpg": …,
    "cls": …, "json": …}``."""

    def __init__(self, path: str):
        from .filesystem import resolve

        paths = _expand_paths(path, ".tar")
        if resolve(path)[0].isdir(path):
            paths = sorted(
                set(paths)
                | set(_expand_paths(path, ".tgz"))
                | set(_expand_paths(path, ".tar.gz"))
            )
        self._paths = paths

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        return [
            ReadTask(lambda p=p: self._read_tar(p), {"path": p})
            for p in self._paths
        ]

    @staticmethod
    def _read_tar(path: str) -> List[dict]:
        import tarfile

        rows: List[dict] = []
        current_key: Optional[str] = None
        row: dict = {}
        mode = "r:gz" if path.endswith((".tgz", ".tar.gz")) else "r"
        with tarfile.open(_local(path), mode) as tf:
            for member in tf:
                if not member.isfile():
                    continue
                base = member.name
                # Sample key = path up to the FIRST dot of the basename
                # (dots in directory names don't split).
                slash = base.rfind("/") + 1
                dot = base.find(".", slash)
                if dot == -1:
                    key, ext = base, "bin"
                else:
                    key, ext = base[:dot], base[dot + 1 :]
                data = tf.extractfile(member).read()
                if key != current_key:
                    if current_key is not None:
                        rows.append(row)
                    current_key, row = key, {"__key__": key}
                row[ext] = decode_wds_member(base, data)
            if current_key is not None:
                rows.append(row)
        return rows


class AudioDatasource(Datasource):
    """PCM WAV files → ``{"audio": [samples, channels] float32 in [-1,1],
    "sample_rate", "path"}`` rows.  Reference ``audio_datasource.py``
    decodes via the ``soundfile`` package (absent here); WAV framing +
    PCM decode are stdlib (``wave``) + numpy, which covers the dominant
    ingest format without a native audio dependency."""

    SUFFIXES = (".wav", ".wave")

    def __init__(self, path: str):
        self._paths = [
            p for p in _expand_paths(path)
            if p.lower().endswith(self.SUFFIXES)
        ]
        if not self._paths:
            # Loud failure beats a silently empty dataset on a typo'd
            # path or a directory with no matching files.
            raise FileNotFoundError(
                f"no {'/'.join(self.SUFFIXES)} files at {path!r}"
            )

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        return [
            ReadTask(lambda p=p: [self._read_wav(p)], {"path": p})
            for p in self._paths
        ]

    @staticmethod
    def _read_wav(path: str) -> dict:
        import wave

        with wave.open(_local(path), "rb") as w:
            n_ch = w.getnchannels()
            width = w.getsampwidth()
            rate = w.getframerate()
            raw = w.readframes(w.getnframes())
        if width == 2:
            arr = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
        elif width == 4:
            arr = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
        elif width == 1:  # unsigned 8-bit PCM
            arr = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
        else:
            raise ValueError(f"{path}: unsupported PCM sample width {width}")
        return {
            "audio": arr.reshape(-1, n_ch),
            "sample_rate": rate,
            "path": path,
        }


class VideoDatasource(Datasource):
    """Video files → one ``{"frame": HxWx3 uint8 RGB, "frame_index",
    "path"}`` row per frame via OpenCV (reference ``video_datasource.py``
    uses pyav; cv2 is what this image ships).  ``stride`` subsamples
    frames at read time (the usual ingest decimation)."""

    SUFFIXES = (".mp4", ".avi", ".mkv", ".mov", ".webm")

    def __init__(self, path: str, stride: int = 1):
        self._paths = [
            p for p in _expand_paths(path)
            if p.lower().endswith(self.SUFFIXES)
        ]
        if not self._paths:
            raise FileNotFoundError(
                f"no {'/'.join(self.SUFFIXES)} files at {path!r}"
            )
        self._stride = max(1, stride)

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        stride = self._stride
        return [
            ReadTask(lambda p=p: self._read_video(p, stride), {"path": p})
            for p in self._paths
        ]

    @staticmethod
    def _read_video(path: str, stride: int) -> List[dict]:
        import cv2

        cap = cv2.VideoCapture(_local(path))
        if not cap.isOpened():
            raise ValueError(f"{path}: cv2 cannot open video")
        rows = []
        i = 0
        try:
            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                if i % stride == 0:
                    rows.append({
                        "frame": cv2.cvtColor(frame, cv2.COLOR_BGR2RGB),
                        "frame_index": i,
                        "path": path,
                    })
                i += 1
        finally:
            cap.release()
        return rows


class SQLDatasource(Datasource):
    """Rows from any DB-API 2.0 database (reference ``sql_datasource.py``).

    ``connection_factory`` must be a picklable zero-arg callable returning
    a DB-API connection — it is invoked *inside* the read task so each
    worker opens its own connection.  With ``shard_keys`` the query is
    split into ``parallelism`` tasks via ``WHERE mod(hash, n) = i``-style
    sharding on the key column (falls back to ``%`` arithmetic, which
    every DB-API engine can evaluate)."""

    def __init__(self, sql: str, connection_factory: Callable,
                 shard_key: Optional[str] = None):
        self._sql = sql
        self._factory = connection_factory
        self._shard_key = shard_key

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        factory, sql = self._factory, self._sql

        def run_query(query: str) -> List[dict]:
            conn = factory()
            try:
                cur = conn.cursor()
                cur.execute(query)
                names = [d[0] for d in cur.description]
                return [dict(zip(names, row)) for row in cur.fetchall()]
            finally:
                conn.close()

        if self._shard_key is None or parallelism <= 1:
            return [ReadTask(lambda: run_query(sql), {"sql": sql})]
        key = self._shard_key
        tasks = []
        for i in range(parallelism):
            # Non-negative modulo (dividend-signed `%` maps negative keys
            # to no shard on most engines); NULL keys land in shard 0 so
            # no row silently vanishes.
            pred = f"((({key} % {parallelism}) + {parallelism}) " \
                   f"% {parallelism}) = {i}"
            if i == 0:
                pred = f"({pred} OR {key} IS NULL)"
            sharded = f"SELECT * FROM ({sql}) AS __t WHERE {pred}"
            tasks.append(
                ReadTask(lambda q=sharded: run_query(q), {"sql": sharded})
            )
        return tasks


# Writes live in datasink.py (Datasink ABC + format sinks) — every
# Dataset.write_* funnels through Dataset.write_datasink.

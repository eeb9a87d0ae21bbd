"""Warehouse / lake / stream connectors.

Reference: ray ``python/ray/data/_internal/datasource/`` —
``mongo_datasource.py``, ``bigquery_datasource.py``,
``clickhouse_datasource.py``, ``kafka_datasource.py`` (unreleased forks
carry it), ``iceberg_datasource.py`` — each wrapping a vendor client.
The vendor SDKs are not on this box (and the deployment may pick any),
so every connector here takes a picklable zero-arg ``*_factory`` whose
return value satisfies a small duck-typed contract documented per class;
the factory runs INSIDE read/write tasks so each worker owns its
connection (exactly how the reference's connectors defer their clients).
Tests exercise the full sharding/assembly machinery against in-memory
fakes; a production deployment passes e.g.
``lambda: pymongo.MongoClient(uri)[db][coll]``.

The Iceberg reader is different: it speaks the actual on-disk table
layout (metadata JSON -> manifest-list Avro -> manifest Avro -> Parquet
data files) over ``data/filesystem.py`` paths, using the in-tree Avro
codec — no SDK involved at all.
"""

from __future__ import annotations

import json
from typing import Any, Callable, Dict, List, Optional

from .datasink import Datasink
from .datasource import Datasource, ParquetReadTask, ReadTask


# ------------------------------------------------------------------ MongoDB
class MongoDatasource(Datasource):
    """Rows from a MongoDB collection (reference ``mongo_datasource.py``).

    ``collection_factory() -> collection`` where the collection duck-types
    pymongo: ``count_documents(filter)`` and
    ``find(filter, projection).sort(key).skip(n).limit(n)`` yielding
    dicts.  Shards by skip/limit windows over an ``_id``-sorted cursor —
    natural order is NOT stable across independent queries, so unsorted
    windows could duplicate/drop rows.  Cost note: skip-based windows
    make the server re-walk the _id index per task (~O(k*N) total); the
    reference's _id-RANGE sharding is O(N) but needs bson ObjectId
    arithmetic, which a duck-typed portable contract can't assume —
    prefer modest parallelism on very large collections.
    """

    def __init__(self, collection_factory: Callable, *,
                 filter: Optional[dict] = None,
                 projection: Optional[dict] = None):
        self._factory = collection_factory
        self._filter = filter or {}
        self._projection = projection

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        factory, flt, proj = self._factory, self._filter, self._projection
        total = factory().count_documents(flt)
        if total == 0:
            # No synthetic empty task: pymongo's limit(0) means UNLIMITED,
            # so a 0-row window query could return the whole collection.
            return []
        k = max(1, min(parallelism, total))
        size = (total + k - 1) // k

        def read(lo: int, n: int) -> List[dict]:
            cur = factory().find(flt, proj).sort("_id").skip(lo).limit(n)
            return list(cur)

        return [
            ReadTask(
                lambda lo=i * size, n=size: read(lo, n),
                {"skip": i * size, "limit": size},
            )
            for i in range(k)
            if i * size < total
        ]


class MongoDatasink(Datasink):
    """insert_many per block (reference ``mongo_datasink.py``)."""

    extension = ""  # no files

    def __init__(self, collection_factory: Callable):
        self.factory = collection_factory

    def write_block(self, block, path: str) -> Dict[str, Any]:
        rows = self._rows(block)
        if rows:
            self.factory().insert_many(rows)
        return {"path": path, "rows": len(rows)}


# ----------------------------------------------------------------- BigQuery
class BigQueryDatasource(Datasource):
    """Rows from a BigQuery SQL query (reference
    ``bigquery_datasource.py``).  ``client_factory() -> client`` duck-types
    google-cloud-bigquery: ``client.query(sql).result()`` iterating rows
    with ``dict(row)`` semantics (mappings pass through).  Shards by
    wrapping the query in a deterministic ``MOD(ABS(FARM_FINGERPRINT(...)))``
    filter when ``shard_expr`` names a column/expression."""

    def __init__(self, client_factory: Callable, sql: str, *,
                 shard_expr: Optional[str] = None):
        self._factory = client_factory
        self._sql = sql
        self._shard_expr = shard_expr

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        factory = self._factory

        def run(sql: str) -> List[dict]:
            return [dict(r) for r in factory().query(sql).result()]

        if self._shard_expr is None or parallelism <= 1:
            sql = self._sql
            return [ReadTask(lambda q=sql: run(q), {"sql": sql})]
        tasks = []
        for i in range(parallelism):
            # IFNULL: a NULL shard key must land in shard 0, not vanish
            # from every shard (NULL = i is never true).
            q = (
                f"SELECT * FROM ({self._sql}) WHERE "
                f"MOD(ABS(FARM_FINGERPRINT(IFNULL(CAST({self._shard_expr} "
                f"AS STRING), ''))), {parallelism}) = {i}"
            )
            tasks.append(ReadTask(lambda q=q: run(q), {"sql": q}))
        return tasks


# --------------------------------------------------------------- ClickHouse
class ClickHouseDatasource(Datasource):
    """Rows from ClickHouse (reference ``clickhouse_datasource.py``).
    ``client_factory() -> client`` duck-types clickhouse-driver's
    ``execute(sql, with_column_types=True) -> (rows, [(name, type), ...])``.
    Shards with ``cityHash64``-style modulo on ``shard_key`` (ClickHouse's
    native hash; any deterministic UInt64 function works)."""

    def __init__(self, client_factory: Callable, sql: str, *,
                 shard_key: Optional[str] = None,
                 hash_fn: str = "cityHash64"):
        self._factory = client_factory
        self._sql = sql
        self._shard_key = shard_key
        self._hash_fn = hash_fn

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        factory = self._factory

        def run(sql: str) -> List[dict]:
            rows, cols = factory().execute(sql, with_column_types=True)
            names = [c[0] for c in cols]
            return [dict(zip(names, r)) for r in rows]

        if self._shard_key is None or parallelism <= 1:
            sql = self._sql
            return [ReadTask(lambda q=sql: run(q), {"sql": sql})]
        tasks = []
        if self._hash_fn == "cityHash64":
            # toString+coalesce: NULL-keyed rows land in a deterministic
            # shard instead of matching no predicate, and String keys
            # don't hit "no supertype for String, UInt8".  Only safe for
            # the default hash (cityHash64 accepts strings).
            key_expr = f"coalesce(toString({self._shard_key}), '')"
        else:
            # A custom hash_fn (e.g. intHash64) constrains its own input
            # type; pass the key through verbatim — the caller's
            # expression is responsible for NULL handling (ifNull(...)).
            key_expr = self._shard_key
        for i in range(parallelism):
            q = (
                f"SELECT * FROM ({self._sql}) WHERE "
                f"{self._hash_fn}({key_expr}) % {parallelism} = {i}"
            )
            tasks.append(ReadTask(lambda q=q: run(q), {"sql": q}))
        return tasks


# -------------------------------------------------------------------- Kafka
class KafkaDatasource(Datasource):
    """Bounded read from Kafka partitions (streaming sources read as
    bounded snapshots, the reference's batch-connector convention).

    ``consumer_factory() -> consumer`` duck-types confluent-kafka /
    kafka-python enough for: ``partitions_for_topic(topic) -> set[int]``,
    ``assign([(topic, p)])``, ``seek_to_beginning()``, and iteration
    yielding messages with ``.partition``, ``.offset``, ``.key``,
    ``.value`` — iteration must end (or raise StopIteration) at the
    snapshot boundary.  One read task per partition."""

    def __init__(self, consumer_factory: Callable, topic: str, *,
                 max_messages_per_partition: int = 1_000_000):
        self._factory = consumer_factory
        self._topic = topic
        self._max = max_messages_per_partition

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        factory, topic, cap = self._factory, self._topic, self._max
        parts = factory().partitions_for_topic(topic)
        if not parts:  # kafka-python returns None for unknown topics
            raise ValueError(f"Kafka topic {topic!r} not found (no partitions)")
        partitions = sorted(parts)

        def read(p: int) -> List[dict]:
            consumer = factory()
            consumer.assign([(topic, p)])
            consumer.seek_to_beginning()
            out = []
            for msg in consumer:
                out.append({
                    "partition": msg.partition,
                    "offset": msg.offset,
                    "key": msg.key,
                    "value": msg.value,
                })
                if len(out) >= cap:
                    break
            return out

        return [
            ReadTask(lambda p=p: read(p), {"topic": topic, "partition": p})
            for p in partitions
        ]


class KafkaDatasink(Datasink):
    """Produce one message per row (reference ``kafka_datasink.py``).
    ``producer_factory() -> producer`` duck-types
    ``send(topic, key=..., value=...)`` + ``flush()``.  Rows carry
    ``key``/``value`` (anything else JSON-encodes into value)."""

    extension = ""

    def __init__(self, producer_factory: Callable, topic: str):
        self.factory = producer_factory
        self.topic = topic

    def write_block(self, block, path: str) -> Dict[str, Any]:
        rows = self._rows(block)
        producer = self.factory()
        for r in rows:
            key = r.get("key")
            if "value" in r:
                value = r["value"]
            else:
                # The key still keys the message; only the remaining
                # fields become the JSON payload.
                rest = {k: v for k, v in r.items() if k != "key"}
                value = json.dumps(rest, default=str).encode()
            producer.send(self.topic, key=key, value=value)
        producer.flush()
        return {"path": path, "rows": len(rows)}


# ------------------------------------------------------------------ Iceberg
class IcebergDatasource(Datasource):
    """Read an Apache Iceberg table from its on-disk layout — no SDK.

    Reference ``iceberg_datasource.py`` delegates to pyiceberg; here the
    metadata chain is walked directly over ``data/filesystem.py`` paths
    (local, ``memory://``, or any registered scheme), using the in-tree
    Avro codec for manifests:

        <table>/metadata/vN.metadata.json   (or version-hint.text)
          -> current snapshot's manifest list (Avro)
          -> manifests (Avro) -> data_file entries (Parquet paths)
          -> one ParquetReadTask per live data file

    Supported subset (documented, asserted): format v1/v2 append-only
    tables — positional/equality deletes and partition-transform pruning
    are rejected loudly rather than silently misread.  ``snapshot_id``
    pins time travel; default is the current snapshot.
    """

    def __init__(self, table_path: str, *,
                 snapshot_id: Optional[int] = None,
                 columns: Optional[List[str]] = None):
        self._table = table_path.rstrip("/")
        self._snapshot_id = snapshot_id
        self._columns = columns

    # -- metadata chain -----------------------------------------------------
    def _read_json(self, path: str) -> dict:
        from .filesystem import resolve

        fs, p = resolve(path)
        return json.loads(fs.read_bytes(p).decode())

    def _latest_metadata_path(self) -> str:
        from .filesystem import fs_join, resolve

        meta_dir = fs_join(self._table, "metadata")
        fs, _ = resolve(meta_dir)
        hint = fs_join(meta_dir, "version-hint.text")
        try:
            v = int(fs.read_bytes(hint).decode().strip())
            return fs_join(meta_dir, f"v{v}.metadata.json")
        except Exception:  # noqa: BLE001 — no hint file: glob for versions
            cands = fs.glob(fs_join(meta_dir, "v*.metadata.json")) or fs.glob(
                fs_join(meta_dir, "*.metadata.json")
            )
            if not cands:
                raise FileNotFoundError(
                    f"no Iceberg metadata under {meta_dir}"
                ) from None

            def vnum(path: str) -> int:
                # Numeric on the LEADING sequence only ("v10..." > "v9...",
                # "00010-<uuid>" > "00002-<uuid>"): concatenating all
                # digits would absorb uuid hex and mis-order catalog-style
                # names.
                stem = path.rsplit("/", 1)[-1].lstrip("v")
                head = stem.split("-")[0].split(".")[0]
                digits = "".join(c for c in head if c.isdigit())
                return int(digits) if digits else -1

            return max(cands, key=vnum)

    def _resolve_path(self, p: str) -> str:
        # Manifest entries store absolute table-relative or full URIs;
        # map the table's own location prefix onto OUR table path so a
        # relocated/copied table still reads.
        loc = getattr(self, "_location", None)
        if loc and p.startswith(loc):
            return self._table + p[len(loc):]
        return p

    def _read_manifest_rows(self, path: str) -> List[dict]:
        from .avro import read_avro_file
        from .filesystem import ensure_local

        return read_avro_file(ensure_local(self._resolve_path(path)))

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        meta = self._read_json(self._latest_metadata_path())
        self._location = meta.get("location", "").rstrip("/") or None
        snaps = meta.get("snapshots", [])
        if not snaps:
            return []
        if self._snapshot_id is not None:
            snap = next(
                (s for s in snaps if s["snapshot-id"] == self._snapshot_id),
                None,
            )
            if snap is None:
                raise ValueError(
                    f"snapshot {self._snapshot_id} not in table "
                    f"{self._table}"
                )
        else:
            cur = meta.get("current-snapshot-id")
            snap = next(
                (s for s in snaps if s["snapshot-id"] == cur), snaps[-1]
            )
        tasks: List[ReadTask] = []
        for m in self._read_manifest_rows(snap["manifest-list"]):
            if m.get("content", 0) != 0:  # 1 = delete manifests (v2)
                raise NotImplementedError(
                    "Iceberg delete manifests are not supported "
                    "(append-only subset)"
                )
            for entry in self._read_manifest_rows(m["manifest_path"]):
                if entry.get("status", 1) == 2:  # DELETED entry
                    continue
                df = entry["data_file"]
                if df.get("content", 0) != 0:
                    raise NotImplementedError(
                        "Iceberg delete files are not supported"
                    )
                fmt = str(df.get("file_format", "PARQUET")).upper()
                if fmt != "PARQUET":
                    raise NotImplementedError(
                        f"Iceberg data file format {fmt} not supported"
                    )
                path = self._resolve_path(df["file_path"])
                tasks.append(
                    ParquetReadTask(
                        path, None, self._columns, None,
                        {"path": path,
                         "num_rows": int(df.get("record_count", 0))},
                    )
                )
        return tasks

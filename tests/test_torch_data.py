"""The port's Data layer against the JAX package's, on the CPU.

The same Data programs run through ``ray_tpu.data`` in a JAX cluster,
which then shuts down, and through ``ray_tpu_torch.data`` in a port
cluster: transforms, wide operations (shuffle, sort, groupby, join, union,
zip), consumers (``split``, ``streaming_split`` read by two tasks,
``iter_batches`` across a columnar carry), round trips through every file
format and through pandas, Arrow and torch, callable classes in fixed and
autoscaling actor pools, and a plan under a tight backpressure budget.
Outputs must be equal; rows are compared in order wherever the plan keeps
it (``preserve_order``, the default; a seeded shuffle included), and
sorted by key where it does not (groupby and join partitions, file
reads).

Port-only: the pool's GPU lease.  ``ActorPoolStrategy(size=2,
num_gpus=1)`` in a cluster that declares two GPUs (no card is present)
places its actors on different cards, and a pool with no lease sees none.

Every UDF is defined inside its program: a function at a test module's
top level travels by reference, and the workers cannot import this module.
"""

import functools
import os
import sqlite3

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu.data as jdata
import ray_tpu_torch
import ray_tpu_torch.data as tdata
from ray_tpu.core.config import GlobalConfig as JaxConfig
from ray_tpu_torch.core.config import GlobalConfig as PortConfig

TIMEOUT = 60


def plain(x):
    """A result as plain Python values, so two packages' outputs compare
    with ``==`` (numpy scalars and arrays, tuples, columnar blocks)."""
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return plain(x.tolist())
    if isinstance(x, np.generic):
        return x.item()
    if isinstance(x, float):
        return round(x, 9)
    if hasattr(x, "columns") and hasattr(x, "__iter__"):  # ColumnarBlock
        return [plain(r) for r in x]
    return x


def by_key(rows, key):
    return sorted(rows, key=lambda r: r[key])


# ------------------------------------------------------------ the programs
def prog_map_filter_flat_map(rt, rd, tmp):
    ds = rd.from_items(list(range(40)), parallelism=4)
    return (ds.map(lambda x: x * 3).filter(lambda x: x % 2 == 0)
            .flat_map(lambda x: [x, -x]).take_all())


def prog_map_batches_default(rt, rd, tmp):
    ds = rd.from_items([{"x": i} for i in range(30)], parallelism=3)
    return ds.map_batches(
        lambda rows: [{"x": r["x"], "sq": r["x"] ** 2, "n": len(rows)}
                      for r in rows]).take_all()


def prog_map_batches_numpy(rt, rd, tmp):
    ds = rd.from_items([{"x": i, "y": 2.0 * i} for i in range(30)],
                       parallelism=3)
    return ds.map_batches(
        lambda b: {"x": b["x"], "z": b["x"] * b["y"] + 1.5},
        batch_format="numpy").take_all()


def prog_columns(rt, rd, tmp):
    ds = rd.from_items([{"a": i, "b": str(i), "c": -i} for i in range(20)],
                       parallelism=4)
    ds = ds.add_column("d", lambda r: r["a"] + r["c"] * 10)
    return {"selected": ds.select_columns(["a", "d"]).take_all(),
            "dropped": ds.drop_columns(["b"]).take_all()}


def prog_limit_repartition(rt, rd, tmp):
    ds = rd.range_dataset(100, parallelism=7)
    m = ds.repartition(5).materialize()
    return {"limit": ds.limit(13).take_all(),
            "blocks": m.num_blocks(),
            "rows": sorted(m.take_all()),
            "limit_after_map": ds.map(lambda x: x + 1).limit(21).count()}


def prog_random_shuffle(rt, rd, tmp):
    rows = rd.range_dataset(60, parallelism=4).random_shuffle(seed=7)
    return {"rows": rows.take_all(),
            "again": rows.take_all()}


def prog_sort(rt, rd, tmp):
    rows = [{"k": (i * 37) % 11, "i": i} for i in range(50)]
    ds = rd.from_items(rows, parallelism=4)
    return {"asc": [r["k"] for r in ds.sort("k").take_all()],
            "desc": [r["k"] for r in ds.sort("k", descending=True)
                     .take_all()],
            "ints": rd.from_items([5, 3, 9, 1, 7, 2, 8, 0],
                                  parallelism=3).sort().take_all()}


def prog_groupby(rt, rd, tmp):
    rows = [{"k": i % 4, "v": float(i * i % 13)} for i in range(40)]
    ds = rd.from_items(rows, parallelism=4)
    g = ds.groupby("k")
    out = {}
    for name in ("sum", "min", "max", "mean", "std"):
        out[name] = by_key(getattr(g, name)("v").take_all(), "k")
    out["aggregate"] = by_key(g.aggregate(rd.Count(), rd.Sum("v"),
                                          rd.Std("v")).take_all(), "k")
    out["global_mean"] = ds.mean("v")
    return out


def prog_join(rt, rd, tmp):
    left = rd.from_items([{"id": i, "l": f"L{i}"} for i in range(20)],
                         parallelism=3)
    right = rd.from_items([{"id": i, "r": i * 10} for i in range(0, 30, 2)],
                          parallelism=2)
    return {"inner": by_key(left.join(right, "id").take_all(), "id"),
            "left": by_key(left.join(right, "id", how="left").take_all(),
                           "id")}


def prog_union_zip(rt, rd, tmp):
    a = rd.from_items([{"x": i} for i in range(10)], parallelism=2)
    b = rd.from_items([{"y": -i} for i in range(10)], parallelism=3)
    return {"union": a.union(rd.from_items([{"x": 100 + i} for i in range(5)],
                                           parallelism=2)).take_all(),
            "zip": a.zip(b).take_all()}


def prog_split(rt, rd, tmp):
    ds = rd.range_dataset(30, parallelism=6).map(lambda x: x * 2)
    return [s.take_all() for s in ds.split(3)]


def prog_streaming_split(rt, rd, tmp):
    ds = rd.from_items([{"i": i} for i in range(24)], parallelism=4).map(
        lambda r: {"i": r["i"], "sq": r["i"] ** 2})

    @rt.remote
    def consume(it):
        return [r for batch in it.iter_batches(batch_size=5)
                for r in batch]

    shards = ds.streaming_split(2)
    return rt.get([consume.remote(s) for s in shards], timeout=TIMEOUT)


def prog_iter_batches_columnar(rt, rd, tmp):
    ds = rd.read_numpy({"x": np.arange(50, dtype=np.int64),
                        "y": np.arange(50, dtype=np.float64) / 4},
                       parallelism=4)
    return [{k: v.tolist() for k, v in b.items()}
            for b in ds.iter_batches(batch_size=7, batch_format="numpy")]


ROWS = [{"id": i, "name": f"n{i}", "score": i * 0.5} for i in range(40)]


def prog_parquet(rt, rd, tmp):
    rd.from_items(ROWS, parallelism=4).write_parquet(tmp)
    return by_key(rd.read_parquet(tmp).take_all(), "id")


def prog_csv(rt, rd, tmp):
    rd.from_items(ROWS, parallelism=4).write_csv(tmp)
    return by_key(rd.read_csv(tmp).take_all(), "id")


def prog_json(rt, rd, tmp):
    rd.from_items(ROWS, parallelism=4).write_json(tmp)
    return by_key(rd.read_json(tmp).take_all(), "id")


def prog_numpy(rt, rd, tmp):
    """``.npz`` files out (one per block), arrays back in by ``read_numpy``."""
    ds = rd.read_numpy({"z": np.arange(40, dtype=np.int16),
                        "w": np.arange(40, dtype=np.float32) * 0.5},
                       parallelism=4)
    cols = {"z": [], "w": []}
    for path in sorted(ds.write_numpy(tmp)):
        with np.load(path if path.endswith(".npz") else path + ".npz") as f:
            for k in cols:
                cols[k].append(f[k])
    arrays = {k: np.concatenate(v) for k, v in cols.items()}
    rows = rd.read_numpy(arrays, parallelism=2).take_all()
    return {"dtypes": [str(a.dtype) for a in arrays.values()],
            "rows": sorted(rows, key=lambda r: int(r["z"]))}


def prog_tfrecords(rt, rd, tmp):
    rows = [{"x": i, "name": f"r{i}".encode()} for i in range(24)]
    rd.from_items(rows, parallelism=3).write_tfrecords(tmp)
    return by_key(rd.read_tfrecords(tmp).take_all(), "x")


def prog_avro(rt, rd, tmp):
    rd.from_items(ROWS, parallelism=4).write_avro(tmp)
    return by_key(rd.read_avro(tmp).take_all(), "id")


def prog_webdataset(rt, rd, tmp):
    rows = [{"__key__": f"s{i:03d}", "cls": i % 5, "txt": f"caption {i}",
             "json": {"i": i}} for i in range(16)]
    rd.from_items(rows, parallelism=2).write_webdataset(tmp)
    return by_key(rd.read_webdataset(tmp).take_all(), "__key__")


def prog_sql(rt, rd, tmp):
    db = os.path.join(tmp, "t.db")
    connect = functools.partial(sqlite3.connect, db)
    conn = sqlite3.connect(db)
    conn.execute("CREATE TABLE src (id INTEGER, label TEXT)")
    conn.executemany("INSERT INTO src VALUES (?, ?)",
                     [(i, f"L{i}") for i in range(60)])
    conn.execute("CREATE TABLE dst (id INTEGER, label TEXT)")
    conn.commit()
    conn.close()
    ds = rd.read_sql("SELECT id, label FROM src", connect, parallelism=3,
                     shard_key="id")
    n = ds.filter(lambda r: r["id"] % 3 == 0).repartition(1).write_sql(
        "dst", connect)
    back = rd.read_sql("SELECT id, label FROM dst", connect, parallelism=1)
    return {"read": by_key(ds.take_all(), "id"), "written": n,
            "back": by_key(back.take_all(), "id")}


def prog_pandas(rt, rd, tmp):
    import pandas as pd

    df = pd.DataFrame({"a": np.arange(12), "b": [f"s{i}" for i in range(12)]})
    ds = rd.from_pandas([df.iloc[:5], df.iloc[5:]]).map(
        lambda r: {**r, "c": r["a"] * 2})
    return {"rows": ds.take_all(),
            "frame": ds.to_pandas().to_dict(orient="list")}


def prog_arrow(rt, rd, tmp):
    import pyarrow as pa

    table = pa.table({"a": list(range(9)), "b": [i / 3 for i in range(9)]})
    ds = rd.from_arrow([table.slice(0, 4), table.slice(4)])
    return {"rows": ds.take_all(),
            "table": ds.filter(lambda r: r["a"] % 2 == 1).to_arrow()
            .to_pydict()}


def prog_from_torch(rt, rd, tmp):
    items = torch.utils.data.TensorDataset(
        torch.arange(10, dtype=torch.float32).reshape(5, 2),
        torch.arange(5))
    return rd.from_torch(items, parallelism=2).take_all()


def prog_actor_pool_fixed(rt, rd, tmp):
    class AddOffset:
        def __init__(self, offset):
            self.offset = offset
            self.calls = 0

        def __call__(self, rows):
            self.calls += 1
            return [{"x": r["x"] + self.offset, "seen": self.calls > 0}
                    for r in rows]

    ds = rd.from_items([{"x": i} for i in range(32)], parallelism=8)
    return ds.map_batches(AddOffset, fn_constructor_args=(1000,),
                          compute=rd.ActorPoolStrategy(size=2)).take_all()


def prog_actor_pool_autoscaling(rt, rd, tmp):
    class Square:
        def __call__(self, batch):
            import time

            time.sleep(0.05)
            return {"x": batch["x"], "sq": batch["x"] ** 2}

    ds = rd.from_items([{"x": i} for i in range(48)], parallelism=12)
    return ds.map_batches(
        Square, batch_format="numpy",
        compute=rd.ActorPoolStrategy(min_size=1, max_size=3)).take_all()


def prog_backpressure_budget(rt, rd, tmp):
    ds = rd.from_items(list(range(12)), parallelism=12).map(
        lambda i: {"i": i, "blob": np.full(64 * 1024, i % 251, np.uint8)})
    ds = ds.execution_options(rd.ExecutionOptions(
        preserve_order=True, target_block_size_bytes=32 * 1024))
    rows = ds.map(lambda r: {"i": r["i"], "sum": int(r["blob"].sum())})
    return {"rows": rows.take_all(), "blocks": len(list(ds.iter_blocks()))}


PROGRAMS = {f.__name__[len("prog_"):]: f for f in (
    prog_map_filter_flat_map, prog_map_batches_default,
    prog_map_batches_numpy, prog_columns, prog_limit_repartition,
    prog_random_shuffle, prog_sort, prog_groupby, prog_join, prog_union_zip,
    prog_split, prog_streaming_split, prog_iter_batches_columnar,
    prog_parquet, prog_csv, prog_json, prog_numpy, prog_tfrecords,
    prog_avro, prog_webdataset, prog_sql, prog_pandas, prog_arrow,
    prog_from_torch, prog_actor_pool_fixed, prog_actor_pool_autoscaling,
    prog_backpressure_budget)}

# A per-operator memory budget of about one 64 KiB block, so the
# backpressure program runs throttled (the knob is read in the driver,
# where the streaming executor runs).
BUDGET = {"data_memory_budget_per_op_bytes": 96 * 1024}


def _run_all(rt, rd, config, tmp):
    saved = {k: getattr(config, k) for k in BUDGET}
    out = {}
    for name, prog in PROGRAMS.items():
        d = os.path.join(tmp, name)
        os.makedirs(d)
        if name == "backpressure_budget":
            config.override(**BUDGET)
        try:
            out[name] = plain(prog(rt, rd, d))
        except Exception as e:  # noqa: BLE001 — compared per program
            out[name] = f"raised {type(e).__name__}: {e}"
        finally:
            config.override(**saved)
    return out


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    ray_tpu.init(num_cpus=8)
    try:
        return _run_all(ray_tpu, jdata, JaxConfig,
                        str(tmp_path_factory.mktemp("jax")))
    finally:
        ray_tpu.shutdown()


@pytest.fixture(scope="module")
def port(jax_results):
    """The port's cluster, started only once the JAX one is down; it
    declares two GPUs (no card is present)."""
    ray_tpu_torch.init(num_cpus=8, resources={"GPU": 2})
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


@pytest.fixture(scope="module")
def port_results(port, tmp_path_factory):
    return _run_all(port, tdata, PortConfig,
                    str(tmp_path_factory.mktemp("port")))


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_same_results_as_the_jax_package(name, jax_results, port_results):
    got, want = port_results[name], jax_results[name]
    assert not (isinstance(want, str) and want.startswith("raised")), want
    assert got == want, (got, want)


# ---------------------------------------------------------- GPU leases
def _pool_placement(port, strategy, n_blocks=8):
    class Where:
        def __call__(self, rows):
            import os
            import time

            time.sleep(0.2)  # both actors take blocks
            return [{"x": r["x"], "pid": os.getpid(),
                     "cuda": os.environ.get("CUDA_VISIBLE_DEVICES")}
                    for r in rows]

    ds = tdata.from_items([{"x": i} for i in range(2 * n_blocks)],
                          parallelism=n_blocks)
    rows = ds.map_batches(Where, compute=strategy).take_all()
    assert [r["x"] for r in rows] == list(range(2 * n_blocks))
    return {r["pid"]: r["cuda"] for r in rows}


def test_gpu_pool_actors_lease_different_cards(port):
    placement = _pool_placement(port, tdata.ActorPoolStrategy(
        size=2, num_gpus=1))
    assert len(placement) == 2, placement
    assert sorted(placement.values()) == ["0", "1"], placement


def test_pool_without_gpus_sees_no_card(port):
    placement = _pool_placement(port, tdata.ActorPoolStrategy(size=2))
    assert placement and set(placement.values()) == {""}, placement

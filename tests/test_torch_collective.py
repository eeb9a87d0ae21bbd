"""The port's collective layer against the JAX package's, on the CPU.

The same per-rank numpy inputs, made from a seed, go through the JAX
``LocalXlaGroup`` on conftest's 8 virtual CPU devices and through the
port: its ``LocalGroup`` (every rank in this process, on the CPU) at world
8, one slice and two slices of 4, and its ``DistGroup`` over gloo at world
2 and 4 (and 4 as two slices of 2), one rank per port actor.  Every op,
every ``ReduceOp`` and every algorithm candidate, each pinned on both
sides.  Integer-valued payloads must match exactly; float payloads (drawn
from [1, 2), so no sum cancels) at rtol 1e-6: the port's ring, tree and
two-level follow the JAX step schedule, and its flat sums run in rank
order as XLA's do, so ``LocalGroup`` matches bit for bit, and gloo's own
flat sums reassociate within that tolerance.  The q8 algorithms are held
within the error bound of ``algorithms.quantized_allreduce`` against the
exact sum; the JAX program rounds a few codes one step apart from its own
numpy twin (XLA divides by multiplying by the reciprocal), so the port is
held bit for bit against the numpy twin, and both against the bound.

Also: ``quantize_blocks`` against the JAX one and the numpy twin, the
copied tuner against the JAX tuner on one sequence of samples, selection
through the tuner, ``create_collective_group`` over port actors, the
device-object group fetch, the flight recorder's q8 wire bytes, the
``collective_reprobe`` actuator, and ``bench_collective.main(quick=True)``.

Every function the actors run is defined inside a test or fixture: one at
this module's top level travels by reference, and the workers cannot
import this module.
"""

import contextlib
import io

import jax
import numpy as np
import pytest
import torch

import ray_tpu_torch
import ray_tpu_torch.collective as tcol
from ray_tpu.collective import algorithms as jalg
from ray_tpu.collective import tuner as jtuner
from ray_tpu.collective.local_group import LocalXlaGroup
from ray_tpu.collective.types import ReduceOp as JOp
from ray_tpu.collective.types import Topology as JTopology
from ray_tpu_torch.collective import algorithms as talg
from ray_tpu_torch.collective import tuner as ttuner
from ray_tpu_torch.collective.local_group import LocalGroup
from ray_tpu_torch.collective.types import Backend, ReduceOp, Topology

N = 8
RTOL = 1e-6
TIMEOUT = 120
OPS = ("max", "min", "mean", "product")


# ------------------------------------------------------------- helpers
def _inputs(kind, n, shape, seed):
    """Per-rank f32 payloads: small integers (exact under any order) or
    floats in [1, 2)."""
    rng = np.random.default_rng(seed)
    if kind == "int":
        return [rng.integers(1, 4, shape).astype(np.float32)
                for _ in range(n)]
    return [rng.uniform(1, 2, shape).astype(np.float32) for _ in range(n)]


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _same(got, want, kind):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if kind == "int":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


@contextlib.contextmanager
def pinned(*groups, algo):
    """Both sides' selection pinned to ``algo``."""
    for g in groups:
        g._select = lambda op, nbytes, quantized: algo
    try:
        yield
    finally:
        for g in groups:
            del g._select


def _q8_bound(stack, block_size, algo, ici):
    """Per-element bound of a q8 allreduce of ``stack`` (n, elems) against
    the exact sum: each rank's round-to-nearest error is at most
    amax/254 of its block (``algorithms.quantized_allreduce``); two-level
    quantizes the slice partials' reduce-scattered chunks instead."""
    n, size = stack.shape
    if algo == "two_level_q8":
        partials = stack.reshape(n // ici, ici, size).sum(axis=1)
        pad = (-size) % ici
        chunks = np.pad(partials, ((0, 0), (0, pad))).reshape(
            n // ici, ici, -1)
        per_chunk = []
        for c in range(ici):
            part = chunks[:, c]
            cb = np.pad(part, ((0, 0), (0, (-part.shape[1]) % block_size)))
            amax = np.abs(cb.reshape(part.shape[0], -1, block_size)).max(2)
            per_chunk.append(np.repeat(amax.sum(0) / 254.0, block_size)[
                :part.shape[1]])
        return np.concatenate(per_chunk)[:size] + 1e-5
    pad = (-size) % block_size
    flat = np.pad(stack, ((0, 0), (0, pad)))
    amax = np.abs(flat.reshape(n, -1, block_size)).max(axis=2)
    return np.repeat(amax.sum(0) / 254.0, block_size)[:size] + 1e-5


def _q8_twin(stack, block_size):
    """The flat q8 allreduce through the numpy twin, summed in rank order."""
    total = None
    for row in stack:
        q, s, size = jalg.quantize_blocks_np(row, block_size)
        deq = q.astype(np.float32) * s[:, None]
        total = deq if total is None else total + deq
    return total.reshape(-1)[:stack.shape[1]]


@pytest.fixture(scope="module")
def groups():
    """(JAX group, port group) at world 8, by slice size (None: one)."""
    out = {}
    for s in (None, 4):
        out[s] = (LocalXlaGroup(f"jax-{s}", slice_size=s),
                  LocalGroup(f"port-{s}", ["cpu"] * N, slice_size=s))
    return out


# ------------------------------------------------------ LocalGroup ops
SUM_CASES = [(s, a, k) for s, algos in (
    (None, ("flat", "ring", "tree")),
    (4, ("flat", "ring", "tree", "two_level"))) for a in algos
    for k in ("int", "float")]


@pytest.mark.parametrize("slice_size,algo,kind", SUM_CASES)
def test_local_allreduce_sum_matches_jax(groups, slice_size, algo, kind):
    jg, tg = groups[slice_size]
    xs = _inputs(kind, N, (13, 7), seed=len(algo))  # 91: pads to n
    with pinned(jg, tg, algo=algo):
        want, got = jg.allreduce(xs), tg.allreduce(xs)
    assert len(got) == N
    for g, w in zip(got, want):
        _same(g, w, kind)


@pytest.mark.parametrize("slice_size,algo", [
    (None, "flat_q8"), (4, "flat_q8"), (4, "two_level_q8")])
def test_local_allreduce_q8_within_bound(groups, slice_size, algo):
    jg, tg = groups[slice_size]
    xs = _inputs("float", N, (700,), seed=3)
    stack = np.stack(xs)
    exact = stack.sum(axis=0)
    bound = _q8_bound(stack, 256, algo, slice_size or N)
    with pinned(jg, tg, algo=algo):
        want = jg.allreduce(xs, quantized=True)
        got = tg.allreduce(xs, quantized=True)
    for g, w in zip(got, want):
        assert (np.abs(_np(g) - exact) <= bound).all()
        assert (np.abs(_np(w) - exact) <= bound).all()
    if algo == "flat_q8":
        np.testing.assert_array_equal(_np(got[0]), _q8_twin(stack, 256))


@pytest.mark.parametrize("op", OPS)
def test_local_allreduce_other_ops_match_jax(groups, op):
    jg, tg = groups[None]
    kind = "float" if op == "mean" else "int"
    xs = _inputs(kind, N, (5, 3), seed=11)
    want = jg.allreduce(xs, JOp(op))
    got = tg.allreduce(xs, ReduceOp(op))
    for g, w in zip(got, want):
        _same(g, w, kind)


@pytest.mark.parametrize("algo", ["flat", "ring"])
def test_local_allgather_matches_jax(groups, algo):
    jg, tg = groups[None]
    xs = _inputs("float", N, (4, 3), seed=5)
    with pinned(jg, tg, algo=algo):
        want, got = jg.allgather(xs), tg.allgather(xs)
    for g, w in zip(got, want):
        assert len(g) == len(w) == N
        for a, b in zip(g, w):
            _same(a, b, "int")  # moved, not summed: exact


@pytest.mark.parametrize("op,algo", [("sum", "flat"), ("sum", "ring")]
                         + [(op, "flat") for op in OPS])
def test_local_reducescatter_matches_jax(groups, op, algo):
    jg, tg = groups[None]
    kind = "float" if op in ("sum", "mean") else "int"
    xs = _inputs(kind, N, (16, 3), seed=7)
    with pinned(jg, tg, algo=algo):
        want = jg.reducescatter(xs, JOp(op))
        got = tg.reducescatter(xs, ReduceOp(op))
    for g, w in zip(got, want):
        assert tuple(g.shape) == (2, 3)
        _same(g, w, kind)


@pytest.mark.parametrize("op,arg", [
    ("broadcast", 0), ("broadcast", 5), ("alltoall", None),
    ("sendrecv_ring", 1), ("sendrecv_ring", 3)])
def test_local_moves_match_jax(groups, op, arg):
    jg, tg = groups[None]
    shape = (N, 3) if op == "alltoall" else (4, 2)
    xs = _inputs("float", N, shape, seed=13)
    args = () if arg is None else (arg,)
    want = getattr(jg, op)(xs, *args)
    got = getattr(tg, op)(xs, *args)
    for g, w in zip(got, want):
        _same(g, w, "int")  # moved, not summed: exact


def test_local_results_are_separate_tensors_on_each_rank():
    tg = LocalGroup("sep", ["cpu"] * 4)
    out = tg.broadcast([torch.ones(3) * i for i in range(4)], src_rank=2)
    out[0].add_(1)
    assert out[1].tolist() == [2.0, 2.0, 2.0]
    tg.barrier()


def test_local_group_without_devices_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LocalGroup("nocard")


def test_selection_through_the_tuner_matches_jax(groups):
    """Unpinned, both sides explore the same candidates in the same order
    (selection depends only on the call sequence) and sum exactly."""
    from ray_tpu.core.config import GlobalConfig as JaxConfig
    from ray_tpu_torch.core.config import GlobalConfig as PortConfig

    jg, tg = groups[4]
    xs = _inputs("int", N, (2048,), seed=17)
    want_sum = np.stack(xs).sum(0)
    # The recorder off on both sides: commits then fall to the heuristic,
    # so the decisions depend on the call sequence alone.
    saved = (JaxConfig.enable_flight_recorder,
             PortConfig.enable_flight_recorder)
    JaxConfig.override(enable_flight_recorder=False)
    PortConfig.override(enable_flight_recorder=False)
    jtuner.reset_tuner()
    ttuner.reset_tuner()
    try:
        for _ in range(12):
            for out in (jg.allreduce(xs), tg.allreduce(xs)):
                for o in out:
                    np.testing.assert_array_equal(_np(o), want_sum)
        jstats, tstats = (jtuner.get_tuner().stats(),
                          ttuner.get_tuner().stats())
    finally:
        JaxConfig.override(enable_flight_recorder=saved[0])
        PortConfig.override(enable_flight_recorder=saved[1])
        jtuner.reset_tuner()
        ttuner.reset_tuner()
    assert tstats == jstats
    row = next(iter(tstats.values()))
    assert set(row["algorithms"]) == {"flat", "ring", "tree", "two_level"}
    assert row["chosen"] in row["algorithms"]


# ----------------------------------------------------- quantization
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block_size", [64, 256])
def test_quantize_blocks_codes_equal_jax_and_numpy(dtype, block_size):
    import jax.numpy as jnp

    rng = np.random.default_rng(23)
    x32 = rng.normal(size=(700,)).astype(np.float32)
    x32[:block_size] = 0.0  # an all-zero block: scale 1, codes 0
    xj = jnp.asarray(x32, dtype=dtype)
    xt = torch.from_numpy(x32).to(getattr(torch, dtype))
    qj, sj, nj = jalg.quantize_blocks(xj, block_size)
    qn, sn, nn = jalg.quantize_blocks_np(np.asarray(xj, np.float32),
                                         block_size)
    qt, st, nt = talg.quantize_blocks(xt, block_size)
    assert nj == nn == nt == 700
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(qt.numpy(), qn)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(st.numpy(), sn)
    back = talg.dequantize_blocks(qt, st, nt, xt.shape, xt.dtype)
    want = jalg.dequantize_blocks(qj, sj, nj, xj.shape, xj.dtype)
    np.testing.assert_array_equal(back.float().numpy(),
                                  np.asarray(want, np.float32))


def test_quantized_wire_bytes_take_torch_dtypes():
    for jd, td in ((np.dtype(np.float32), torch.float32),
                   ("bfloat16", torch.bfloat16)):
        assert talg.quantized_wire_bytes(4096, td) == \
            jalg.quantized_wire_bytes(4096, jd)
    assert talg.quantizable_dtype(torch.bfloat16)
    assert not talg.quantizable_dtype(torch.int32)


def test_quantized_rejects_non_sum_and_int():
    tg = LocalGroup("qrej", ["cpu"] * 2)
    with pytest.raises(ValueError, match="SUM"):
        tg.allreduce([torch.ones(8)] * 2, ReduceOp.MAX, quantized=True)
    with pytest.raises(ValueError, match="float"):
        tg.allreduce([torch.ones(8, dtype=torch.int32)] * 2, quantized=True)


# ------------------------------------------------------------- tuner
def test_tuner_same_decisions_as_jax():
    """One scripted sequence of samples (a fabric whose best algorithm
    moves) through both tuners: the same decisions, commits and table."""
    jt = jtuner.CollectiveTuner(enabled=True, min_attempts=2)
    tt = ttuner.CollectiveTuner(enabled=True, min_attempts=2)
    cands = ("flat", "ring", "tree", "two_level")
    bw = {"flat": 2e8, "ring": 8e8, "tree": 6e8, "two_level": 5e8}
    trail = []
    for step in range(200):
        if step == 60:
            bw["ring"] = 1e6
        decs = []
        for t, topo in ((jt, JTopology(8, 4)), (tt, Topology(8, 4))):
            d = t.select("allreduce", 1 << 20, 8, topo, cands)
            t.observe("allreduce", 1 << 20, 8, topo, d["algo"],
                      bw[d["algo"]] * (1 + 0.01 * (step % 3)))
            decs.append(d)
        assert decs[0] == decs[1], step
        trail.append(decs[1]["algo"])
    assert jt.stats() == tt.stats()
    assert jt.force_reprobe() == tt.force_reprobe() == 1
    assert "ring" in trail[:60] and trail[-1] != "ring"


# ------------------------------------------------ actors and clusters
@pytest.fixture(scope="module")
def port():
    ray_tpu_torch.init(num_cpus=8)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


DIST_CONFIGS = [(2, None), (4, None), (4, 2)]


def _dist_cases(world, hosts):
    """``[(case id, op, kwargs, algo, kind, shape)]`` for one DistGroup."""
    topo = Topology(world, hosts or world)
    cases = [(f"allreduce_sum_{a}_{k}", "allreduce", {}, a, k, (13, 7))
             for a in talg.allreduce_candidates(world, topo)
             for k in ("int", "float")]
    cases += [(f"allreduce_{a}", "allreduce", {"quantized": True}, a,
               "float", (700,))
              for a in talg.allreduce_candidates(world, topo, True)]
    cases += [(f"allreduce_{op}", "allreduce", {"op": op}, None,
               "float" if op == "mean" else "int", (5, 3)) for op in OPS]
    cases += [(f"allgather_{a}", "allgather", {}, a, "float", (4, 3))
              for a in ("flat", "ring")]
    cases += [(f"reducescatter_sum_{a}", "reducescatter", {}, a, "float",
               (8, 3)) for a in ("flat", "ring")]
    cases += [(f"reducescatter_{op}", "reducescatter", {"op": op}, None,
               "float" if op == "mean" else "int", (8, 3)) for op in OPS]
    cases += [("broadcast", "broadcast", {"src_rank": world - 1}, None,
               "float", (4, 2)),
              ("alltoall", "alltoall", {}, None, "float", (world, 3)),
              ("ppermute", "ppermute", {"shift": 1}, None, "float", (4, 2))]
    return cases


def _jax_case(jg, op, kwargs, algo, xs):
    """The JAX group's per-rank results of one case."""
    kw = dict(kwargs)
    if "op" in kw:
        kw["op"] = JOp(kw["op"])
    with (pinned(jg, algo=algo) if algo else contextlib.nullcontext()):
        if op == "ppermute":
            return jg.sendrecv_ring(xs, kw["shift"])
        out = getattr(jg, op)(xs, **kw)
    if op == "allgather":
        return [np.stack([np.asarray(t) for t in r]) for r in out]
    return out


@pytest.fixture(scope="module")
def dist_results(port):
    """Every case of every config through gloo DistGroups in port actors:
    ``{(world, hosts): (results by case, inputs by case, stats by rank)}``."""

    @port.remote(num_cpus=1)
    class Member:
        def run(self, name, world, rank, hosts, cases, inputs):
            import torch

            from ray_tpu_torch import collective as col
            from ray_tpu_torch.collective.types import ReduceOp

            g = col.init_collective_group(world, rank, backend="gloo",
                                          group_name=name,
                                          hosts_per_slice=hosts)
            out = {}
            for cid, op, kwargs, algo, _kind, _shape in cases:
                x = torch.from_numpy(inputs[cid][rank])
                kw = dict(kwargs)
                if "op" in kw:
                    kw["op"] = ReduceOp(kw["op"])
                if algo:
                    g._select = lambda o, nb, q, a=algo: a
                res = getattr(g, op)(x, **kw)
                if algo:
                    del g._select
                if op == "allgather":
                    res = torch.stack(res)
                out[cid] = res.numpy()
            g.barrier()
            info = (g.info().backend.value, str(g.topology))
            col.destroy_collective_group(name)
            return out, info

    results = {}
    for world, hosts in DIST_CONFIGS:
        cases = _dist_cases(world, hosts)
        inputs = {c[0]: _inputs(c[4], world, c[5], seed=i)
                  for i, c in enumerate(cases)}
        members = [Member.remote() for _ in range(world)]
        name = f"dist-{world}-{hosts}"
        outs = port.get([m.run.remote(name, world, r, hosts, cases, inputs)
                         for r, m in enumerate(members)], timeout=TIMEOUT)
        for m in members:
            port.kill(m)
        results[(world, hosts)] = (
            [o for o, _ in outs], inputs, [i for _, i in outs])
    return results


DIST_PARAMS = [(w, h, c[0]) for w, h in DIST_CONFIGS
               for c in _dist_cases(w, h)]


@pytest.mark.parametrize("world,hosts,cid", DIST_PARAMS)
def test_dist_gloo_matches_jax(dist_results, world, hosts, cid):
    outs, inputs, infos = dist_results[(world, hosts)]
    assert all(i[0] == "gloo" for i in infos)
    case = next(c for c in _dist_cases(world, hosts) if c[0] == cid)
    _, op, kwargs, algo, kind, _ = case
    xs = inputs[cid]
    jg = LocalXlaGroup(f"jax-{world}-{hosts}", jax.devices()[:world],
                       slice_size=hosts)
    want = _jax_case(jg, op, kwargs, algo, xs)
    got = [o[cid] for o in outs]
    if kwargs.get("quantized"):
        stack = np.stack(xs).reshape(world, -1)
        bound = _q8_bound(stack, 256, algo, hosts or world)
        exact = stack.sum(axis=0)
        for g, w in zip(got, want):
            assert (np.abs(g.reshape(-1) - exact) <= bound).all()
            assert (np.abs(np.asarray(w).reshape(-1) - exact)
                    <= bound).all()
        if algo == "flat_q8":
            np.testing.assert_array_equal(got[0].reshape(-1),
                                          _q8_twin(stack, 256))
        return
    if op in ("allgather", "broadcast", "alltoall", "ppermute"):
        kind = "int"  # moved, not summed: exact
    for g, w in zip(got, want):
        _same(g, w, kind)


def test_dist_gloo_cuda_staging_and_tuner_sync(port):
    """World 2 through the tuner (autotune on): every member commits the
    same algorithm at the synced commit points and sums exactly; a q8
    call at world 2 selects flat_q8; on CPU tensors nothing is staged."""

    @port.remote(num_cpus=1)
    class Member:
        def run(self, rank):
            import torch

            from ray_tpu_torch import collective as col

            col.reset_tuner()
            col.init_collective_group(2, rank, backend="gloo",
                                      group_name="tuned")
            x = torch.arange(65536, dtype=torch.float32) % 7 + rank
            outs = [col.allreduce(x, "tuned") for _ in range(12)]
            q = col.allreduce(torch.ones(4096) * (rank + 1), "tuned",
                              quantized=True)
            stats = col.collective_stats()
            col.destroy_collective_group("tuned")
            return ([o.tolist()[:5] for o in outs], q[:3].tolist(),
                    stats["tuner"], stats["staged"], stats["allreduce"])

    a, b = Member.remote(), Member.remote()
    ra, rb = port.get([a.run.remote(0), b.run.remote(1)], timeout=TIMEOUT)
    for m in (a, b):
        port.kill(m)
    want = [(2 * (i % 7) + 1) for i in range(5)]
    assert all(o == want for o in ra[0]) and ra[0] == rb[0]
    assert ra[1] == pytest.approx([3.0] * 3, abs=2 * 2 / 254)
    rows = {k: v for k, v in ra[2].items() if not v["quantized"]}
    assert {k: v["chosen"] for k, v in rows.items()} == {
        k: v["chosen"] for k, v in rb[2].items() if not v["quantized"]}
    row = next(iter(rows.values()))
    assert set(row["algorithms"]) == {"flat", "ring", "tree"}
    assert row["chosen"] in row["algorithms"] and row["commits"] >= 1
    assert any(v["chosen"] == "flat_q8" for v in ra[2].values())
    assert ra[3] == {} and ra[4]["ops"] >= 13


def test_dist_group_refuses_nccl_without_a_card(port, monkeypatch):
    from ray_tpu_torch.collective.dist_group import DistGroup

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        DistGroup("nocard", 1, 0, backend="nccl")
    with pytest.raises(ValueError, match="nccl or gloo"):
        DistGroup("local", 1, 0, backend="local")


def test_backend_names():
    assert [Backend.normalize(v) for v in ("gpu", "cuda", "NCCL")] == \
        [Backend.NCCL] * 3
    assert Backend.normalize("gloo") == Backend.GLOO
    assert [Backend.normalize(v) for v in ("cpu", "host", "local")] == \
        [Backend.LOCAL] * 3
    with pytest.raises(ValueError):
        Backend.normalize("xla")


def test_create_collective_group_over_port_actors(port):
    @port.remote(num_cpus=0)
    class Member:
        def has_group(self, name):
            from ray_tpu_torch import collective

            return (collective.is_group_initialized(name),
                    collective.get_collective_group_size(name))

    a, b = Member.remote(), Member.remote()
    name = tcol.create_collective_group([a, b], backend="local",
                                        group_name="team", device="cpu")
    assert name == "team"
    assert port.get(a.has_group.remote("team"), timeout=60) == (True, 2)
    assert port.get(b.has_group.remote("team"), timeout=60) == (True, 2)
    assert tcol.get_collective_groups(a) == ["team"]
    assert tcol.get_collective_groups(b) == ["team"]
    tcol.destroy_actor_collective_group("team")
    assert tcol.get_collective_groups(a) == []
    for m in (a, b):
        port.kill(m)


def test_device_object_fetch_prefers_the_group():
    """With a group initialized, a non-local fetch resolves through the
    group's broadcast — the RPC path is not touched (the JAX test's
    program, on a LocalGroup)."""
    tcol.init_local_group("xfer-group", devices=["cpu"] * N)
    try:
        owner = tcol.DeviceObjectStore()
        ref = owner.put(torch.arange(8, dtype=torch.float32),
                        group_name="xfer-group", rank=0)
        consumer = tcol.DeviceObjectStore()

        def fail_rpc(_ref):
            raise AssertionError("host-staged RPC path was used")

        consumer._fetch_rpc = fail_rpc
        consumer.fetch(ref)
        assert consumer.last_transfer_path == "collective"
    finally:
        tcol.destroy_collective_group("xfer-group")


def test_device_object_group_fetch_between_actors(port):
    """The owner's ``serve_fetch`` and the consumer's ``fetch`` meet in a
    gloo broadcast: the consumer gets the owner's tensor, by the group."""

    @port.remote(num_cpus=1, max_concurrency=2)
    class Member:
        def join(self, rank):
            from ray_tpu_torch import collective as col

            col.init_collective_group(2, rank, backend="gloo",
                                      group_name="fetch")
            return True

        def make(self):
            import torch

            from ray_tpu_torch.collective import device_object_store

            t = torch.arange(24, dtype=torch.bfloat16).reshape(4, 6) / 3
            return device_object_store().put(t, group_name="fetch", rank=0)

        def serve(self, ref):
            from ray_tpu_torch.collective import device_object_store

            return device_object_store().serve_fetch(ref).float().tolist()

        def fetch(self, ref):
            from ray_tpu_torch.collective import device_object_store

            store = device_object_store()
            out = store.fetch(ref)
            return out.float().tolist(), str(out.dtype), \
                store.last_transfer_path

    owner, consumer = Member.remote(), Member.remote()
    port.get([owner.join.remote(0), consumer.join.remote(1)],
             timeout=TIMEOUT)
    ref = port.get(owner.make.remote(), timeout=60)
    served, (got, dtype, path) = port.get(
        [owner.serve.remote(ref), consumer.fetch.remote(ref)],
        timeout=TIMEOUT)
    assert path == "collective"
    assert dtype == "torch.bfloat16"
    assert got == served
    want = (torch.arange(24, dtype=torch.bfloat16).reshape(4, 6) / 3)
    assert got == want.float().tolist()
    for m in (owner, consumer):
        port.kill(m)


# --------------------------------------- flight recorder and remediation
def _saved_bytes(metrics_mod, registry):
    with metrics_mod._lock:
        return sum(ent["value"] for (name, _t), ent
                   in metrics_mod._local.items()
                   if name == registry.COLLECTIVE_QUANTIZED_BYTES_SAVED_TOTAL)


def test_recorder_counts_q8_wire_bytes_as_jax(groups):
    from ray_tpu.util import metric_registry as jreg
    from ray_tpu.util import metrics as jmetrics
    from ray_tpu_torch.util import metric_registry as treg
    from ray_tpu_torch.util import metrics as tmetrics

    jg, tg = groups[None]
    xs = _inputs("float", N, (512,), seed=29)
    jtuner.reset_tuner()
    ttuner.reset_tuner()
    jb, tb = _saved_bytes(jmetrics, jreg), _saved_bytes(tmetrics, treg)
    jg.allreduce(xs, quantized=True)
    tg.allreduce(xs, quantized=True)
    jd = _saved_bytes(jmetrics, jreg) - jb
    td = _saved_bytes(tmetrics, treg) - tb
    wire = talg.quantized_wire_bytes(512 * 4 * N, torch.float32)
    assert td == jd == 512 * 4 * N - wire
    stats = tcol.collective_stats()["tuner"]
    assert any(k.endswith("|q8") and v["chosen"] == "flat_q8"
               for k, v in stats.items())
    jtuner.reset_tuner()
    ttuner.reset_tuner()


def test_drift_maps_to_reprobe_with_op():
    """tests/test_remediation.py:148, through the port's controller."""
    from ray_tpu_torch.util import remediation as rem
    from ray_tpu_torch.util.slo import SloEngine, SloViolation

    calls = []

    def fn(target, violation, **kw):
        calls.append((target, kw))
        return f"acted on {target}"

    h = rem.register_actuator(rem.ACTION_COLLECTIVE_REPROBE, fn)
    try:
        c = rem.RemediationController(
            engine=SloEngine(rules=[]), cooldown_s=10.0, burst=1,
            max_actions_per_incident=3, quarantine_s=100.0,
            straggler_sustain_s=0.0, publish=False)
        v = SloViolation("collective_bw_drift", "worker:ab op=allreduce",
                         9.0, 1.0, "d", 10.0)
        v.first_seen, v.ongoing = 10.0, False
        out = c.process([v], now=10.0)
    finally:
        rem.unregister_actuator(h)
    assert out[0].action == rem.ACTION_COLLECTIVE_REPROBE
    assert out[0].outcome == rem.OUTCOME_APPLIED
    assert calls == [("worker:ab op=allreduce", {"op": "allreduce"})]


def test_reprobe_flips_commit_on_drifted_fabric():
    """tests/test_remediation.py:471 on the port's tuner."""
    t = ttuner.CollectiveTuner(enabled=True, min_attempts=1)
    cands = ("flat", "ring", "tree")
    bw = {"flat": 2e8, "ring": 8e8, "tree": 6e8}

    def run(n):
        last = None
        for _ in range(n):
            d = t.select("allreduce", 1 << 20, 4, None, cands)
            t.observe("allreduce", 1 << 20, 4, None, d["algo"],
                      bw[d["algo"]])
            last = d
        return last

    run(6)
    bucket = next(iter(t._buckets.values()))
    assert bucket.committed == "ring"
    bw["ring"] = 1e6
    run(4)
    assert bucket.committed == "ring"
    assert t.force_reprobe("allreduce") == 1
    assert run(1)["explored"]
    run(1)
    assert bucket.committed != "ring"


def test_local_directive_arms_tuner():
    """tests/test_remediation.py:501 on the port's tuner."""
    from ray_tpu_torch.util import remediation as rem

    ttuner.reset_tuner()
    t = ttuner.get_tuner()
    for _ in range(6):
        d = t.select("allreduce", 1 << 20, 4, None, ("flat", "ring"))
        t.observe("allreduce", 1 << 20, 4, None, d["algo"], 1e8)
    out = rem.apply_local_directive(
        {"kind": rem.ACTION_COLLECTIVE_REPROBE, "op": "allreduce"})
    assert out == {"kind": rem.ACTION_COLLECTIVE_REPROBE, "armed": 1}
    ttuner.reset_tuner()


def test_builtin_reprobe_actuator_reaches_the_cluster(port):
    """The built-in actuator arms this process's tuner and fans the
    directive to the cluster's workers, without raising."""
    from ray_tpu_torch.util import remediation as rem

    @port.remote(num_cpus=0)
    class Worker:
        def ping(self):
            return True

    w = Worker.remote()
    assert port.get(w.ping.remote(), timeout=60)
    ttuner.reset_tuner()
    msg = rem._builtin_collective_reprobe("worker:ab op=allreduce", None,
                                          op="allreduce")
    assert msg.startswith("armed 0 local bucket(s); directive reached ")
    assert int(msg.split("reached ")[1].split()[0]) >= 1
    port.kill(w)


# ---------------------------------------------------------------- bench
def test_bench_collective_quick_on_the_cpu():
    import json

    from ray_tpu_torch.collective import bench_collective

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        bench_collective.main(quick=True, device="cpu")
    recs = [json.loads(line)["collective"]
            for line in buf.getvalue().splitlines()]
    by = {r["metric"]: r for r in recs}
    assert set(by["collective_allreduce_algo_ab"][
        "bandwidth_bytes_per_s"]) == {"flat", "ring", "tree", "two_level"}
    assert by["collective_dcn_allreduce_bytes_per_s"]["chosen"] in (
        "flat", "ring", "tree", "two_level")
    q = by["collective_allreduce_quantized_bytes_per_s"]
    assert q["wire_bytes_per_rank"] < q["logical_bytes_per_rank"]
    assert by["collective_group_allreduce_e2e_bytes_per_s"][
        "ops_recorded"] > 0
    ops = by["collective_op_bytes_per_s"]["bandwidth_bytes_per_s"]
    assert {"allreduce/two_level", "allgather/ring", "reducescatter/ring",
            "broadcast", "alltoall"} <= set(ops)
    assert all(v > 0 for v in ops.values())

"""The port's DAGs against the JAX package's, on the CPU.

Every case of ``tests/test_dag.py`` (classic ``execute()``, compiled
pipelines, fan-out and fan-in, input attributes, errors flowing through
the pipeline, oversized payloads, teardown, in-graph allreduce) runs as a
program through ``ray_tpu`` and through ``ray_tpu_torch``: one cluster per
package for the module, the JAX one shut down before the port's starts.
Results must be equal, exceptions equal by type name and message match,
and equal to what ``tests/test_dag.py`` asserts.

Then, in the port's cluster: a tiny f32 GPT-2 cut in two stages (one
actor each, weights carried from JAX by ``params_from_jax``) must give the
JAX ``gpt2_apply``'s logits within 1e-5, compiled and through
``execute()``; and ``allreduce_bind`` over torch tensors, by the host path,
through a named ``LocalGroup`` and through a gloo ``DistGroup``, must give
the JAX DAG's numpy result on the same seeded inputs exactly.
"""

import dataclasses
import re
import types

import jax
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu.models as jm
import ray_tpu_torch
from ray_tpu_torch.models import GPT2Config

TIMEOUT = 90


def _actors(rt):
    """The classes of ``tests/test_dag.py``, made for ``rt``.  Nested, so
    they travel to the workers by value."""

    @rt.remote
    class Adder:
        def __init__(self, delta):
            self.delta = delta

        def add(self, x):
            return x + self.delta

        def combine(self, a, b):
            return a + b

        def boom(self, x):
            raise ValueError("boom!")

        def tick(self):
            return 7

        def big(self, x):
            import numpy as np

            return np.zeros(1_000_000)

    @rt.remote
    def double(x):
        return 2 * x

    @rt.remote(max_concurrency=2)
    class W:
        def __init__(self, rank):
            self.rank = rank

        def compute(self, x):
            import numpy as np

            return np.full(4, float(x * (self.rank + 1)))

        def scale(self, t):
            return t * 10

    return Adder, double, W


def _raised(fn, match):
    """(type name, whether the message matches) of what ``fn`` raises."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the exception is the result
        return type(e).__name__, re.search(match, str(e)) is not None
    return None


def _lists(values):
    return [np.asarray(v).tolist() for v in values]


# ------------------------------------------------------------ the programs
def prog_function_and_method_nodes(rt, dag, A):
    a = A.Adder.remote(10)
    with dag.InputNode() as inp:
        out = A.double.bind(a.add.bind(inp))
    return rt.get(out.execute(5), timeout=TIMEOUT), [a]


def prog_multi_output(rt, dag, A):
    a, b = A.Adder.remote(1), A.Adder.remote(2)
    with dag.InputNode() as inp:
        d = dag.MultiOutputNode([a.add.bind(inp), b.add.bind(inp)])
    return rt.get(d.execute(10), timeout=TIMEOUT), [a, b]


def _compiled(d, fn, **kw):
    cdag = d.experimental_compile(**kw)
    try:
        return fn(cdag)
    finally:
        cdag.teardown()


def prog_linear_pipeline(rt, dag, A):
    a, b = A.Adder.remote(1), A.Adder.remote(10)
    with dag.InputNode() as inp:
        d = b.add.bind(a.add.bind(inp))

    def run(c):
        first = c.execute(5).get()
        refs = [c.execute(i) for i in range(3)]
        return first, [r.get() for r in refs]

    return _compiled(d, run), [a, b]


def prog_fan_out_fan_in(rt, dag, A):
    a, b, c = A.Adder.remote(1), A.Adder.remote(2), A.Adder.remote(0)
    with dag.InputNode() as inp:
        d = c.combine.bind(a.add.bind(inp), b.add.bind(inp))
    return _compiled(d, lambda cd: cd.execute(10).get()), [a, b, c]


def prog_input_attributes(rt, dag, A):
    a = A.Adder.remote(0)
    with dag.InputNode() as inp:
        d = a.combine.bind(inp[0], inp[1])
    return _compiled(d, lambda c: c.execute(3, 4).get()), [a]


def prog_multi_output_compiled(rt, dag, A):
    a, b = A.Adder.remote(1), A.Adder.remote(2)
    with dag.InputNode() as inp:
        d = dag.MultiOutputNode([a.add.bind(inp), b.add.bind(inp)])
    return _compiled(d, lambda c: c.execute(1).get()), [a, b]


def prog_same_actor_chain_stays_local(rt, dag, A):
    a = A.Adder.remote(1)
    with dag.InputNode() as inp:
        d = a.add.bind(a.add.bind(a.add.bind(inp)))
    return _compiled(d, lambda c: c.execute(0).get()), [a]


def prog_error_propagates_and_pipeline_survives(rt, dag, A):
    a, b = A.Adder.remote(1), A.Adder.remote(1)
    with dag.InputNode() as inp:
        d = b.add.bind(a.boom.bind(inp))
    return _compiled(d, lambda c: [
        _raised(lambda: c.execute(1).get(), "boom"),
        _raised(lambda: c.execute(2).get(), "boom")]), [a, b]


def prog_no_input_dag(rt, dag, A):
    a = A.Adder.remote(0)
    d = a.tick.bind()
    return _compiled(d, lambda c: [c.execute().get(),
                                   c.execute().get()]), [a]


def prog_oversized_result_surfaces_error(rt, dag, A):
    a = A.Adder.remote(0)
    with dag.InputNode() as inp:
        d = a.big.bind(inp)
    return _compiled(d, lambda c: _raised(
        lambda: c.execute(1).get(), "exceeds the channel buffer"),
        buffer_size_bytes=64 * 1024), [a]


def prog_oversized_input_rejected_at_execute(rt, dag, A):
    a = A.Adder.remote(0)
    with dag.InputNode() as inp:
        d = a.add.bind(inp)
    return _compiled(d, lambda c: [
        _raised(lambda: c.execute(np.zeros(1_000_000)),
                "exceeds channel capacity"),
        c.execute(5).get()], buffer_size_bytes=64 * 1024), [a]


def prog_duplicate_output_node(rt, dag, A):
    a = A.Adder.remote(1)
    with dag.InputNode() as inp:
        x = a.add.bind(inp)
        d = dag.MultiOutputNode([x, x])
    return _compiled(d, lambda c: c.execute(1).get()), [a]


def prog_bad_input_arity_surfaces_error(rt, dag, A):
    a = A.Adder.remote(0)
    with dag.InputNode() as inp:
        d = a.combine.bind(inp[0], inp[1])
    return _compiled(d, lambda c: [
        _raised(lambda: c.execute(1).get(), ""),
        c.execute(1, 2).get()]), [a]


def prog_error_in_one_output_keeps_pipeline_synced(rt, dag, A):
    a, b = A.Adder.remote(1), A.Adder.remote(2)
    with dag.InputNode() as inp:
        d = dag.MultiOutputNode([a.boom.bind(inp), b.add.bind(inp)])

    def run(c):
        r1, r2 = c.execute(1), c.execute(10)
        return [_raised(r1.get, "boom"), _raised(r2.get, "boom")]

    return _compiled(d, run), [a, b]


def prog_teardown_frees_actor(rt, dag, A):
    a = A.Adder.remote(5)
    with dag.InputNode() as inp:
        d = a.add.bind(inp)
    cdag = d.experimental_compile()
    first = cdag.execute(1).get()
    cdag.teardown()
    return [first, rt.get(a.add.remote(2), timeout=TIMEOUT)], [a]


def prog_classic_execute_allreduce(rt, dag, A):
    workers = [A.W.remote(i) for i in range(2)]
    with dag.InputNode() as inp:
        parts = [w.compute.bind(inp) for w in workers]
        d = dag.MultiOutputNode(dag.allreduce_bind(parts, op="sum"))
    refs = d.execute(3)
    return _lists(rt.get(r, timeout=TIMEOUT) for r in refs), workers


def prog_compiled_allreduce_with_downstream(rt, dag, A):
    workers = [A.W.remote(i) for i in range(2)]
    with dag.InputNode() as inp:
        parts = [w.compute.bind(inp) for w in workers]
        reduced = dag.allreduce_bind(parts, op="sum")
        d = dag.MultiOutputNode([workers[0].scale.bind(reduced[0]),
                                 reduced[1]])
    return _compiled(d, lambda c: [_lists(c.execute(x).get(timeout=60))
                                   for x in (1, 2)]), workers


def prog_allreduce_validation(rt, dag, A):
    workers = [A.W.remote(0)]
    with dag.InputNode() as inp:
        node = workers[0].compute.bind(inp)
    return [_raised(lambda: dag.allreduce_bind([], op="sum"), ""),
            _raised(lambda: dag.allreduce_bind([node, node]), "distinct")
            ], workers


PROGRAMS = {f.__name__[len("prog_"):]: f for f in (
    prog_function_and_method_nodes, prog_multi_output, prog_linear_pipeline,
    prog_fan_out_fan_in, prog_input_attributes, prog_multi_output_compiled,
    prog_same_actor_chain_stays_local,
    prog_error_propagates_and_pipeline_survives, prog_no_input_dag,
    prog_oversized_result_surfaces_error,
    prog_oversized_input_rejected_at_execute, prog_duplicate_output_node,
    prog_bad_input_arity_surfaces_error,
    prog_error_in_one_output_keeps_pipeline_synced,
    prog_teardown_frees_actor, prog_classic_execute_allreduce,
    prog_compiled_allreduce_with_downstream, prog_allreduce_validation)}

BOOM = ("ValueError", True)
EXPECTED = {  # what tests/test_dag.py asserts
    "function_and_method_nodes": 30,
    "multi_output": [11, 12],
    "linear_pipeline": (16, [11, 12, 13]),
    "fan_out_fan_in": 23,
    "input_attributes": 7,
    "multi_output_compiled": [2, 3],
    "same_actor_chain_stays_local": 3,
    "error_propagates_and_pipeline_survives": [BOOM, BOOM],
    "no_input_dag": [7, 7],
    "oversized_result_surfaces_error": ("ValueError", True),
    "oversized_input_rejected_at_execute": [("ValueError", True), 5],
    "duplicate_output_node": [2, 2],
    "bad_input_arity_surfaces_error": [("IndexError", True), 3],
    "error_in_one_output_keeps_pipeline_synced": [BOOM, BOOM],
    "teardown_frees_actor": [6, 7],
    "classic_execute_allreduce": [[9.0] * 4, [9.0] * 4],
    "compiled_allreduce_with_downstream": [
        [[30.0] * 4, [3.0] * 4], [[60.0] * 4, [6.0] * 4]],
    "allreduce_validation": [("ValueError", True), ("ValueError", True)],
}


def _run_all(rt):
    A = types.SimpleNamespace(**dict(zip(("Adder", "double", "W"),
                                         _actors(rt))))
    out = {}
    for name, prog in PROGRAMS.items():
        out[name], actors = prog(rt, rt.dag, A)
        for actor in actors:
            rt.kill(actor)
    return out


# ------------------------------------------- allreduce over seeded tensors
REDUCE_OPS = ("sum", "mean", "max", "min", "product")
REDUCE_SEED = 17


def _reduce_member(rt):
    @rt.remote
    class Member:
        """Holds a seeded f32 vector, as numpy (JAX) or a tensor (port)."""

        def __init__(self, rank, seed, as_tensor):
            import numpy as np

            rng = np.random.default_rng(seed + rank)
            self.data = rng.standard_normal(64).astype(np.float32)
            if as_tensor:
                import torch

                self.data = torch.from_numpy(self.data)

        def part(self, x):
            return self.data * x

    return Member


def _allreduce_dag(rt, members, group_name=None):
    """One compiled DAG holding an allreduce of each op over the members'
    parts; its outputs by op, each member's."""
    dag = rt.dag
    with dag.InputNode() as inp:
        parts = [m.part.bind(inp) for m in members]
        outs = [r for op in REDUCE_OPS
                for r in dag.allreduce_bind(parts, op, group_name=group_name)]
        d = dag.MultiOutputNode(outs)
    cdag = d.experimental_compile()
    try:
        got = cdag.execute(1.5).get(timeout=TIMEOUT)
    finally:
        cdag.teardown()
    n = len(members)
    return {op: got[i * n:(i + 1) * n] for i, op in enumerate(REDUCE_OPS)}


@pytest.fixture(scope="module")
def jax_results():
    ray_tpu.init(num_cpus=4)
    try:
        out = _run_all(ray_tpu)
        members = [_reduce_member(ray_tpu).remote(r, REDUCE_SEED, False)
                   for r in range(2)]
        out["allreduce"] = {op: [np.asarray(v) for v in vs]
                            for op, vs in _allreduce_dag(ray_tpu,
                                                         members).items()}
        for m in members:
            ray_tpu.kill(m)
        return out
    finally:
        ray_tpu.shutdown()


@pytest.fixture(scope="module")
def port(jax_results):
    """The port's cluster, started only once the JAX one is down."""
    ray_tpu_torch.init(num_cpus=4)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


@pytest.fixture(scope="module")
def port_results(port):
    return _run_all(port)


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_same_results_as_the_jax_package(name, jax_results, port_results):
    assert port_results[name] == jax_results[name], (
        port_results[name], jax_results[name])
    assert port_results[name] == EXPECTED[name], port_results[name]


def test_bind_builds_nodes_in_the_port(port):
    @port.remote
    def f(x):
        return x

    @port.remote
    class C:
        def m(self, x):
            return x

    c = C.remote()
    assert isinstance(f.bind(1), port.dag.FunctionNode)
    assert isinstance(c.m.bind(1), port.dag.ClassMethodNode)
    port.kill(c)


# ----------------------------------------------------- a two-stage GPT-2
GPT2_TOL = 1e-5


def _stage_class(rt):
    @rt.remote
    class Stage:
        """Layers ``layers`` of a GPT-2 whose weights come from JAX; the
        first stage embeds ids, the last returns the logits."""

        def __init__(self, tree, cfg, layers, first, last):
            from ray_tpu_torch.convert import params_from_jax

            self.params = params_from_jax(tree, cfg, device="cpu")
            self.cfg, self.layers = cfg, list(layers)
            self.first, self.last = first, last

        def forward(self, x):
            import torch

            from ray_tpu_torch.models.gpt2 import _block, _layernorm

            p = self.params
            with torch.no_grad():
                if self.first:
                    x = p["wte"][x] + p["wpe"][:x.shape[1]][None]
                for layer in self.layers:
                    x = _block(x, p.layer(layer), self.cfg)
                if self.last:
                    x = torch.einsum("bse,ve->bsv",
                                     _layernorm(x, p["lnf_g"], p["lnf_b"]),
                                     p["wte"])
            return x

    return Stage


@pytest.fixture(scope="module")
def gpt2_pair():
    jcfg = dataclasses.replace(jm.GPT2Config.tiny(dtype="float32"),
                               n_layer=4)
    tcfg = dataclasses.replace(GPT2Config.tiny(dtype="float32"), n_layer=4)
    params = jm.gpt2_init(jax.random.PRNGKey(3), jcfg)
    tokens = np.random.default_rng(5).integers(0, jcfg.vocab_size, (2, 16))
    want = np.asarray(jm.gpt2_apply(params, tokens, jcfg))
    return tcfg, jax.tree.map(np.asarray, params), tokens, want


@pytest.mark.parametrize("mode", ["compiled", "execute"])
def test_gpt2_pipeline_matches_jax_gpt2_apply(port, gpt2_pair, mode):
    cfg, tree, tokens, want = gpt2_pair
    stage = _stage_class(port)
    split = cfg.n_layer // 2
    a = stage.remote(tree, cfg, range(split), True, False)
    b = stage.remote(tree, cfg, range(split, cfg.n_layer), False, True)
    with port.dag.InputNode() as inp:
        d = b.forward.bind(a.forward.bind(inp))
    x = torch.from_numpy(tokens)
    if mode == "compiled":
        got = _compiled(d, lambda c: c.execute(x).get(timeout=TIMEOUT))
    else:
        got = port.get(d.execute(x), timeout=TIMEOUT)
    for s in (a, b):
        port.kill(s)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=GPT2_TOL,
                               atol=GPT2_TOL)


# ----------------------------------------- allreduce over torch tensors
@pytest.fixture(scope="module")
def port_allreduce(port):
    """Each path's outputs: the host path, a named LocalGroup and a gloo
    DistGroup, each over two members holding CPU tensors."""
    from ray_tpu_torch.collective import (
        create_collective_group, destroy_actor_collective_group,
    )

    out = {}
    for path, backend in (("host", None), ("local", "local"),
                          ("gloo", "gloo")):
        members = [_reduce_member(port).remote(r, REDUCE_SEED, True)
                   for r in range(2)]
        group = None
        if backend is not None:
            group = create_collective_group(
                members, backend=backend, group_name=f"dag_{path}",
                device="cpu")
        out[path] = _allreduce_dag(port, members, group)
        if group is not None:
            destroy_actor_collective_group(group)
        for m in members:
            port.kill(m)
    return out


@pytest.mark.parametrize("op", REDUCE_OPS)
@pytest.mark.parametrize("path", ["host", "local", "gloo"])
def test_allreduce_on_tensors_equals_jax_dag(jax_results, port_allreduce,
                                             path, op):
    want = jax_results["allreduce"][op]
    got = port_allreduce[path][op]
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert isinstance(g, torch.Tensor) and g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), w)

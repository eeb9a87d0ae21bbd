"""The port's parallel layer (``ray_tpu_torch.parallel``) against the JAX
package's, the twin of tests/test_parallel.py.

Seeded numpy inputs go to the JAX functions on conftest's 8 virtual CPU
devices and to the port in one spawned world of 8 gloo processes
(``torch_parallel_programs.parallel_suite``), at the JAX tests'
tolerances: forward 2e-4, gradients 1e-3, pipeline 1e-5.  The ring runs
both routes: the plain one (JAX's block math, autograd) and the kernel
one (``_RingFlash``: the flash forward per block merged by lse, a second
ring of the dQ and dK/dV kernels), whose kernel wrappers run their plain
versions on CPU tensors.  Gradients are of ``sum(out * cot)`` for a
seeded ``cot``, on both sides.  The single-controller route (every rank in
this process, over a ``LocalGroup`` of CPU devices) runs here, in-process.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from ray_tpu.ops.attention import reference_attention as jref
from ray_tpu.parallel import MeshConfig as JMeshConfig
from ray_tpu.parallel import build_mesh as jbuild_mesh
from ray_tpu.parallel import logical_spec as jlogical_spec
from ray_tpu.parallel import pipelined as jpipelined
from ray_tpu.parallel import ring_attention as jring
from ray_tpu.parallel import ulysses_attention as julysses
from ray_tpu_torch.collective import LocalGroup
from ray_tpu_torch.parallel import (
    DEFAULT_RULES,
    MeshConfig,
    logical_spec,
    ring_attention,
    ulysses_attention,
)
from ray_tpu_torch.parallel.launch import run_world

FWD, GRAD, PIPE = 2e-4, 1e-3, 1e-5
HERE = os.path.dirname(os.path.abspath(__file__))

# name -> (shape, seed) of the JAX test's q/k/v.
SHAPES = {
    "ring_causal": ((2, 64, 4, 8), 0),
    "ring_noncausal": ((1, 32, 2, 8), 1),
    "ring_data_parallel": ((4, 32, 2, 8), 2),
    "ulysses": ((2, 32, 8, 4), 0),
    "ulysses_grad": ((2, 16, 4, 4), 3),
}


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for _ in range(3))


def _cot(shape, seed):
    return np.random.default_rng(100 + seed).standard_normal(shape).astype(
        np.float32)


INPUTS = {name: _qkv(*spec) for name, spec in SHAPES.items()}
INPUTS.update({f"cot_{name.removeprefix('ring_')}": _cot(*spec)
               for name, spec in SHAPES.items() if name.startswith("ring")})
INPUTS.update({f"cot_{name}": _cot(*spec)
               for name, spec in SHAPES.items() if name.startswith("ul")})
INPUTS["pipe_w"] = (np.random.default_rng(4).standard_normal((4, 8, 8))
                    * 0.3).astype(np.float32)
INPUTS["pipe_x"] = np.random.default_rng(5).standard_normal(
    (6, 4, 8)).astype(np.float32)


@pytest.fixture(scope="module")
def port():
    """The port's results: one world of 8 gloo ranks for the module."""
    return run_world("torch_parallel_programs:parallel_suite", 8,
                     args=(INPUTS,), paths=[HERE], timeout=300)[0]


def _jax_case(fn, name, mesh, **kw):
    """JAX output and gradients of sum(out * cot) for input ``name``."""
    q, k, v = (jnp.asarray(x) for x in INPUTS[name])
    cot = jnp.asarray(INPUTS[f"cot_{name.removeprefix('ring_')}"])

    def loss(q, k, v):
        return (fn(q, k, v, mesh, **kw) * cot).sum()

    out = jax.jit(lambda q, k, v: fn(q, k, v, mesh, **kw))(q, k, v)
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
    return {"out": out, "dq": grads[0], "dk": grads[1], "dv": grads[2]}


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=what)


class TestMesh:
    def test_for_devices_fills_rest(self):
        cfg = MeshConfig.for_devices(8, model=2)
        assert cfg.model == 2 and cfg.fsdp == 4 and cfg.num_devices == 8
        assert cfg == MeshConfig(**vars(JMeshConfig.for_devices(8, model=2)))

    def test_indivisible_raises(self):
        with pytest.raises(ValueError):
            MeshConfig.for_devices(8, model=3)

    def test_build(self, port):
        jmesh = jbuild_mesh(JMeshConfig(fsdp=4, model=2))
        assert port["mesh_sizes"] == dict(jmesh.shape)
        assert port["mesh_sizes"]["fsdp"] == 4
        assert port["mesh_sizes"]["data"] == 1


class TestLogicalSharding:
    @pytest.mark.parametrize("axes", [
        ("batch", "seq", "heads"), ("nonesuch", None),
        (None, "embed", None, "heads", "kv"), ("vocab", "embed"),
        ("batch", "seq", "mlp"), ("batch", "seq", "act_embed"),
    ])
    def test_spec_matches_jax(self, axes):
        assert logical_spec(axes) == tuple(jlogical_spec(P(*axes)))

    def test_spec_mapping(self):
        assert logical_spec(("batch", "seq", "heads")) == (
            ("data", "fsdp"), "seq", "model")
        assert DEFAULT_RULES["embed"] == "fsdp"

    def test_shard_pytree(self, port):
        # 8-way sharded over 16 rows → 2 rows per rank, as in JAX.
        assert port["w_local_shape"] == (2, 4)
        assert port["w_placements"] == port["w_spec_placements"]
        assert port["w_placements"][1] == "S(0)"
        assert [p for i, p in enumerate(port["w_placements"]) if i != 1] == \
            ["R"] * 5


RING_CASES = {
    "causal": (dict(seq=8), True),
    "noncausal": (dict(seq=8), False),
    "data_parallel": (dict(data=2, seq=4), True),
}


class TestRingAttention:
    @pytest.mark.parametrize("route", ["plain", "kernel"])
    @pytest.mark.parametrize("case", sorted(RING_CASES))
    def test_matches_jax_ring(self, port, case, route):
        axes, causal = RING_CASES[case]
        want = _jax_case(jring, f"ring_{case}", jbuild_mesh(JMeshConfig(
            **axes)), causal=causal)
        got = port[f"ring_{case}_{route}"]
        _close(got["out"], want["out"], FWD, "out")
        q, k, v = (jnp.asarray(x) for x in INPUTS[f"ring_{case}"])
        _close(got["out"], jref(q, k, v, causal=causal), FWD, "vs dense")
        for g in ("dq", "dk", "dv"):
            _close(got[g], want[g], GRAD, g)


class TestUlysses:
    @pytest.mark.parametrize("name", ["ulysses", "ulysses_grad"])
    def test_matches_jax(self, port, name):
        want = _jax_case(julysses, name, jbuild_mesh(JMeshConfig(
            data=2, seq=4)), causal=True)
        got = port[name]
        _close(got["out"], want["out"], FWD, "out")
        for g in ("dq", "dk", "dv"):
            _close(got[g], want[g], GRAD, g)


class TestPipeline:
    @pytest.mark.parametrize("key", ["pipeline", "pipeline_dp"])
    def test_matches_sequential(self, port, key):
        ws, x = jnp.asarray(INPUTS["pipe_w"]), jnp.asarray(INPUTS["pipe_x"])
        y_ref = x
        for s in range(4):
            y_ref = jnp.tanh(y_ref @ ws[s])
        mesh = jbuild_mesh(JMeshConfig(data=2, stage=4))
        y = jax.jit(jpipelined(lambda w, x: jnp.tanh(x @ w), mesh,
                               batch_axes=None))(ws, x)
        _close(port[key], y, PIPE, "vs JAX pipelined")
        _close(port[key], y_ref, PIPE, "vs sequential")


class TestLocalGroup:
    """The single-controller route: four ranks in this process."""

    @pytest.mark.parametrize("fn,name,route", [
        (ring_attention, "ring_causal", "plain"),
        (ring_attention, "ring_causal", "kernel"),
        (ulysses_attention, "ulysses", None),
    ])
    def test_matches_jax(self, fn, name, route):
        group = LocalGroup("sp_local", devices=["cpu"] * 4)
        kw = {"route": route} if route else {}
        q, k, v = (torch.from_numpy(x).requires_grad_(True)
                   for x in INPUTS[name])
        cot = INPUTS[f"cot_{name.removeprefix('ring_')}"]
        out = fn(q, k, v, group, causal=True, **kw)
        (out * torch.from_numpy(cot)).sum().backward()
        jfn = jring if fn is ring_attention else julysses
        want = _jax_case(jfn, name, jbuild_mesh(JMeshConfig(seq=4, data=2)),
                         causal=True)
        _close(out.detach().numpy(), want["out"], FWD, "out")
        for g, t in zip(("dq", "dk", "dv"), (q, k, v)):
            _close(t.grad.numpy(), want[g], GRAD, g)


class TestLaunch:
    """``run_world``: results in rank order, a rank's error and a hung
    world each fail the call instead of blocking it."""

    def test_results_in_rank_order(self):
        assert run_world("torch_parallel_programs:rank_and_world", 3,
                         paths=[HERE], timeout=120) == [(0, 3), (1, 3),
                                                        (2, 3)]

    def test_rank_error_fails_the_call(self):
        with pytest.raises(RuntimeError, match="rank 1 refuses"):
            run_world("torch_parallel_programs:raise_on_rank_1", 2,
                      paths=[HERE], timeout=120)

    def test_deadline_kills_a_hung_world(self):
        with pytest.raises(TimeoutError, match="deadline"):
            run_world("torch_parallel_programs:sleep_forever", 2,
                      paths=[HERE], timeout=15)

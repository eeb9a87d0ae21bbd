"""The port's multi-slice meshes against the JAX package's, the twin of
tests/test_multislice.py.

An outer ``dcn`` mesh dim over per-slice meshes; ranks group into equal
contiguous chunks (no CUDA device carries a ``slice_index``).  One world
of 8 gloo ranks (``torch_parallel_programs.multislice_suite``) builds a
2-slice x (fsdp=2, model=2) mesh, checks its axes and the rules, and runs
the GPT-2 loss on JAX's weights over the flat fsdp=8 mesh and the
multi-slice one, and two full train steps on the multi-slice mesh.  The
JAX side runs on conftest's 8 virtual devices; the losses agree at the
JAX test's rel 1e-4.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ray_tpu.models as jm
from ray_tpu.parallel import MeshConfig as JMeshConfig
from ray_tpu.parallel import MultiSliceConfig as JMultiSliceConfig
from ray_tpu.parallel import build_multislice_mesh as jbuild_multislice
from ray_tpu.parallel import default_rules_for_mesh as jrules
from ray_tpu.parallel import group_devices_by_slice as jgroup
from ray_tpu.parallel import shard_pytree as jshard
from ray_tpu_torch.parallel import MULTISLICE_RULES, group_devices_by_slice
from ray_tpu_torch.parallel.launch import run_world

HERE = os.path.dirname(os.path.abspath(__file__))
CFG = dict(vocab_size=256, max_seq=64, n_layer=2, n_head=4, d_model=64,
           dtype="float32")
TOKENS = np.asarray(jax.random.randint(
    jax.random.PRNGKey(7), (4, 33), 0, CFG["vocab_size"], jnp.int32))
JPARAMS = jax.tree.map(np.asarray, jm.gpt2_init(
    jax.random.PRNGKey(0), jm.GPT2Config(**CFG, attention="dense")))


@pytest.fixture(scope="module")
def port():
    inp = {"cfg": dict(CFG, attention="dense"), "params": JPARAMS,
           "tokens": TOKENS.astype(np.int64)}
    return run_world("torch_parallel_programs:multislice_suite", 8,
                     args=(inp,), paths=[HERE], timeout=300)[0]


def _jax_mesh():
    return jbuild_multislice(
        JMultiSliceConfig(2, JMeshConfig(fsdp=2, model=2)),
        jax.devices()[:8])


class TestMultiSliceMesh:
    def test_slice_grouping(self, port):
        groups = group_devices_by_slice(list(range(8)), 2)
        assert groups == [[0, 1, 2, 3], [4, 5, 6, 7]] == port["groups"]
        jgroups = jgroup(jax.devices()[:8], 2)
        assert [[d.id for d in g] for g in jgroups] == groups
        with pytest.raises(ValueError):
            group_devices_by_slice(list(range(7)), 2)

    def test_mesh_axes(self, port):
        jmesh = _jax_mesh()
        assert tuple(port["axes"]) == tuple(jmesh.axis_names)
        assert port["axes"][0] == "dcn"
        assert port["sizes"] == {"dcn": 2, "fsdp": 2, "model": 2}
        assert {a: jmesh.shape[a] for a in port["sizes"]} == port["sizes"]

    def test_rules_extend_batch_over_dcn(self, port):
        assert port["batch_rule"] == ("dcn", "data", "fsdp")
        assert MULTISLICE_RULES == jrules(_jax_mesh())

    def test_train_step_parity_with_single_mesh(self, port):
        cfg = jm.GPT2Config(**CFG, attention="dense")
        mesh = _jax_mesh()
        params = jshard(jax.tree.map(jnp.asarray, JPARAMS),
                        jm.gpt2_param_axes(), mesh, jrules(mesh))
        want = float(jax.jit(lambda p, t: jm.gpt2_loss(p, t, cfg, mesh))(
            params, jnp.asarray(TOKENS)))
        assert port["single_loss"] == pytest.approx(port["multi_loss"],
                                                    rel=1e-4)
        assert port["multi_loss"] == pytest.approx(want, rel=1e-4)

    def test_full_train_step_on_multislice_mesh(self, port):
        loss, loss2 = port["train_losses"]
        assert np.isfinite(loss) and loss2 < loss

"""The port's models under a mesh against the JAX models under the same
mesh: ``*_param_axes``, ``ModelFamily.param_axes``, the losses of both
families with ``attention="ring"`` and ``"ulysses"`` on a (fsdp=2, seq=2,
model=2) mesh, the ring's logits and every gradient leaf, and the port's
``dryrun_multichip(8)`` loss and AdamW step against the JAX dry run's.

JAX initialises f32 tiny weights; ``params_from_jax`` carries them into
the port, ``shard_pytree`` places them, and one world of 8 gloo ranks
(``torch_parallel_programs.models_suite``) computes the port's side.  The
JAX side runs on conftest's 8 virtual devices.  Tolerances are the JAX
parallel tests': forward (losses, logits) 2e-4, gradients 1e-3.

The same world runs the vision models and the MoE LM at the JAX model
tests' meshes and tolerances (tests/test_models.py:149-161, 190-205,
243-258), each against the JAX model on one device: ResNet eval on
data=8 (1e-4), ResNet train on data=2 — loss, ``new_state`` (the batch
statistics of the global batch) and every gradient leaf (1e-4), ViT on
(fsdp=4, model=2) (2e-3), the MoE LM on (data=2, expert=4) (logits 2e-3,
aux 1e-4; the loss and every gradient leaf at 2e-3).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import ray_tpu.models as jm
from ray_tpu.parallel import MeshConfig as JMeshConfig
from ray_tpu.parallel import build_mesh as jbuild_mesh
from ray_tpu.parallel import shard_pytree as jshard
from ray_tpu_torch import models as tm
from ray_tpu_torch.parallel.dryrun import (
    UPDATED_LEAVES,
    dryrun_multichip,
    mesh_config_for,
)
from ray_tpu_torch.parallel.launch import run_world

FWD, GRAD = 2e-4, 1e-3
HERE = os.path.dirname(os.path.abspath(__file__))

CFGS = {
    "gpt2": dict(vocab_size=256, max_seq=64, n_layer=2, n_head=4,
                 d_model=64, dtype="float32"),
    "llama": dict(vocab_size=256, max_seq=64, n_layer=2, n_head=4,
                  n_kv_head=2, d_model=64, d_ff=128, dtype="float32"),
}
JAX = {
    "gpt2": (jm.GPT2Config, jm.gpt2_init, jm.gpt2_loss, jm.gpt2_apply,
             jm.gpt2_param_axes),
    "llama": (jm.LlamaConfig, jm.llama_init, jm.llama_loss, jm.llama_apply,
              jm.llama_param_axes),
}
TOKENS = np.random.default_rng(11).integers(0, 256, (4, 33)).astype(np.int32)
JPARAMS = {name: jax.tree.map(np.asarray, JAX[name][1](
    jax.random.PRNGKey(i), JAX[name][0](**CFGS[name])))
    for i, name in enumerate(sorted(CFGS))}


def _mesh():
    return jbuild_mesh(JMeshConfig(fsdp=2, seq=2, model=2))


def _vision_inputs():
    rng = np.random.default_rng(12)
    rparams, rstate = jm.resnet_init(jax.random.PRNGKey(3),
                                     jm.ResNetConfig.tiny(dtype="float32"))
    return {
        "resnet_params": jax.tree.map(np.asarray, rparams),
        "resnet_state": jax.tree.map(np.asarray, rstate),
        "resnet_x8": rng.standard_normal((8, 32, 32, 3)).astype(np.float32),
        "resnet_x4": rng.standard_normal((4, 32, 32, 3)).astype(np.float32),
        "resnet_y4": rng.integers(0, 10, (4,)),
        "vit_params": jax.tree.map(np.asarray, jm.vit_init(
            jax.random.PRNGKey(4), jm.ViTConfig.tiny(dtype="float32"))),
        "vit_x": rng.standard_normal((4, 32, 32, 3)).astype(np.float32),
        "moe_params": jax.tree.map(np.asarray, jm.moe_init(
            jax.random.PRNGKey(5), jm.MoEConfig.tiny(dtype="float32"))),
        "moe_tokens": rng.integers(0, 512, (4, 33)),
    }


VISION = _vision_inputs()


@pytest.fixture(scope="module")
def port():
    inp = {"tokens": TOKENS.astype(np.int64), "vision": VISION}
    for name in CFGS:
        inp[f"{name}_cfg"] = CFGS[name]
        inp[f"{name}_params"] = JPARAMS[name]
    return run_world("torch_parallel_programs:models_suite", 8, args=(inp,),
                     paths=[HERE], timeout=300)[0]


def _jax_side(name, attention):
    cfg_cls, _, loss_fn, apply_fn, axes = JAX[name]
    cfg = cfg_cls(**CFGS[name], attention=attention)
    mesh = _mesh()
    params = jshard(jax.tree.map(jnp.asarray, JPARAMS[name]), axes(), mesh)
    tokens = jnp.asarray(TOKENS)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: loss_fn(p, tokens, cfg, mesh)))(params)
    logits = jax.jit(lambda p: apply_fn(p, tokens[:, :-1], cfg, mesh))(params)
    return float(loss), grads, logits


def _names(tree):
    """A logical-axes tree with every PartitionSpec as a tuple."""
    if isinstance(tree, dict):
        return {k: _names(v) for k, v in tree.items()}
    return tuple(tree)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_param_axes_match_jax(name):
    assert _names(JAX[name][4]()) == (tm.gpt2_param_axes() if name == "gpt2"
                                      else tm.llama_param_axes())


@pytest.mark.parametrize("name,cfg", [("gpt2", tm.GPT2Config.tiny()),
                                      ("llama", tm.LlamaConfig.tiny())])
def test_model_family_param_axes(name, cfg):
    fam = tm.model_family(cfg)
    assert fam.name == name
    assert fam.param_axes() == _names(JAX[name][4]())


@pytest.mark.parametrize("attention", ["ring", "ulysses"])
@pytest.mark.parametrize("name", sorted(CFGS))
def test_loss_matches_jax(port, name, attention):
    want, _, _ = _jax_side(name, attention)
    assert port[f"{name}_{attention}_loss"] == pytest.approx(
        want, rel=FWD, abs=FWD)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_ring_logits_and_grads_match_jax(port, name):
    _, grads, logits = _jax_side(name, "ring")
    np.testing.assert_allclose(port[f"{name}_ring_logits"],
                               np.asarray(logits), rtol=FWD, atol=FWD)
    got = port[f"{name}_ring_grads"]
    n = 0
    for key, g in grads.items():
        for sub, want in (g.items() if key == "blocks" else [(None, g)]):
            have = got["blocks"][sub] if sub else got[key]
            np.testing.assert_allclose(have, np.asarray(want), rtol=GRAD,
                                       atol=GRAD, err_msg=f"{key}.{sub}")
            n += 1
    assert n == len(got) - 1 + len(got["blocks"])


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}{k}."))
    return out


def _close_trees(got, want, tol, what):
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want), what
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=tol, atol=tol,
                                   err_msg=f"{what} {k}")


def _jax_one_device(case):
    """The JAX model on one device, on the world's inputs."""
    v = jax.tree.map(jnp.asarray, VISION)
    if case.startswith("resnet"):
        cfg = jm.ResNetConfig.tiny(dtype="float32")
        if case == "resnet-data8-eval":
            return jm.resnet_apply(v["resnet_params"], v["resnet_state"],
                                   v["resnet_x8"], cfg)[0]
        (loss, state), grads = jax.value_and_grad(
            jm.resnet_loss, has_aux=True)(v["resnet_params"],
                                          v["resnet_state"], v["resnet_x4"],
                                          v["resnet_y4"], cfg)
        return loss, state, grads
    if case == "vit-fsdp4-model2":
        return jm.vit_apply(v["vit_params"], v["vit_x"],
                            jm.ViTConfig.tiny(dtype="float32"))
    cfg = jm.MoEConfig.tiny(dtype="float32")
    logits, aux = jm.moe_apply(v["moe_params"], v["moe_tokens"][:, :-1], cfg)
    loss, grads = jax.value_and_grad(
        lambda p: jm.moe_loss(p, v["moe_tokens"], cfg))(v["moe_params"])
    return logits, aux, loss, grads


@pytest.mark.parametrize("case", ["resnet-data8-eval", "resnet-data2-train",
                                  "vit-fsdp4-model2", "moe-data2-expert4"])
def test_vision_and_moe_on_a_mesh_match_jax(port, case):
    got = port["vision"]
    want = _jax_one_device(case)
    if case == "resnet-data8-eval":
        np.testing.assert_allclose(got["resnet_data8_eval"], np.asarray(want),
                                   rtol=1e-4, atol=1e-4)
    elif case == "resnet-data2-train":
        loss, state, grads = want
        have = got["resnet_data2_train"]
        assert have["loss"] == pytest.approx(float(loss), rel=1e-4, abs=1e-4)
        _close_trees(have["new_state"], jax.tree.map(np.asarray, state),
                     1e-4, "new_state")
        _close_trees(have["grads"], jax.tree.map(np.asarray, grads), 1e-4,
                     "grad")
    elif case == "vit-fsdp4-model2":
        np.testing.assert_allclose(got["vit_fsdp4_model2"], np.asarray(want),
                                   rtol=2e-3, atol=2e-3)
    else:
        logits, aux, loss, grads = want
        have = got["moe_data2_expert4"]
        np.testing.assert_allclose(have["logits"], np.asarray(logits),
                                   rtol=2e-3, atol=2e-3)
        assert have["aux"] == pytest.approx(float(aux), rel=1e-4)
        assert have["loss"] == pytest.approx(float(loss), rel=2e-3, abs=2e-3)
        _close_trees(have["grads"], jax.tree.map(np.asarray, grads), 2e-3,
                     "grad")


def test_dryrun_multichip_matches_jax():
    """One sharded train step of the JAX dry run (``__graft_entry__``:
    mesh (1, 2, 1, 1, 2, 2), ring attention, zero tokens, optax.adamw)
    against the port's ``dryrun_multichip(8)`` on the same weights: the
    loss, the values of ``UPDATED_LEAVES`` after the AdamW step against
    ``optax.apply_updates``, and the 2-slice loss against the JAX step's
    loss, as the dry run's own parity check."""
    cfg_mesh = mesh_config_for(8)
    assert cfg_mesh.shape == (1, 2, 1, 1, 2, 2)
    cfg = jm.GPT2Config(vocab_size=256, max_seq=64, n_layer=2, n_head=4,
                        d_model=64, dtype="float32", attention="ring")
    jparams = jm.gpt2_init(jax.random.PRNGKey(0), cfg)
    mesh = jbuild_mesh(JMeshConfig(**vars(cfg_mesh)))
    params = jshard(jparams, jm.gpt2_param_axes(), mesh)
    tx = optax.adamw(1e-3)
    tokens = jnp.zeros((2, 33), jnp.int32)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jm.gpt2_loss(p, tokens, cfg, mesh)))(params)
    updates, _ = tx.update(grads, tx.init(params), params)
    stepped = optax.apply_updates(params, updates)
    rep = dryrun_multichip(8, params=jax.tree.map(np.asarray, jparams),
                           scaling=False, device="cpu")
    assert rep["mesh"] == cfg_mesh.shape and rep["attention"] == "ring"
    assert rep["loss"] == pytest.approx(float(loss), rel=FWD, abs=FWD)
    assert rep["multislice_loss"] == pytest.approx(float(loss), rel=FWD,
                                                   abs=FWD)
    # The AdamW step on local shards against optax's on the same grads.
    assert set(rep["updated"]) == set(UPDATED_LEAVES)
    for name, have in rep["updated"].items():
        want = stepped
        for key in name.split("."):
            want = want[key]
        np.testing.assert_allclose(have, np.asarray(want), rtol=GRAD,
                                   atol=GRAD, err_msg=name)


def test_dryrun_multichip_needs_cards(monkeypatch):
    """Asked for no device, the dry run takes one card a rank, as the JAX
    dry run takes the chips: with fewer cards than ranks it raises rather
    than dropping to gloo processes on the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(RuntimeError, match="needs 4 cards, have 2"):
        dryrun_multichip(4, scaling=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun_multichip(2, scaling=False)


def test_entry_needs_a_card(monkeypatch):
    """``entry()`` builds GPT-2 small on the card: with none, the device
    rule raises rather than dropping to the CPU."""
    import torch

    from ray_tpu_torch.parallel.dryrun import entry

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()


def test_card_tool_runs_on_cpu_ranks():
    """``tools/parallel_cards.py`` on 4 gloo ranks at a tiny size: phase
    14's ``seq_parallel_attention`` on a seq=4 mesh (each rank's ring and
    Ulysses against whole-sequence attention, element by element and by
    block norm, within chip_smoke's bf16 tolerance) and its
    ``sharded_train`` on (fsdp=2, seq=2) beside the unsharded step, in
    bf16 and f32: the first step's gradients within ``SHARDED_GRAD_TOL``
    by leaf, every loss within the tool's ``LOSS_TOL`` of its dtype."""
    tools = os.path.join(os.path.dirname(HERE), "tools")
    cfg = dict(vocab_size=512, max_seq=64, n_layer=2, n_head=2, d_model=128,
               attention="ring")
    ranks = run_world("parallel_cards:rank_main", 4, paths=[tools],
                      timeout=300,
                      args=("cpu", (1, 64, 4, 16), 1, cfg, 64,
                            {"bfloat16": 4, "float32": 4}, (2, 3)))
    assert [r["rank"] for r in ranks] == [0, 1, 2, 3]
    for r in ranks:
        for name in ("ring", "ulysses"):
            errs = r["attention"][name]["vs_whole_kernel"]
            assert set(errs) == {"out", "dq", "dk", "dv", "dq_rel_by_block",
                                 "dk_rel_by_block", "dv_rel_by_block"}
            assert len(errs["dv_rel_by_block"]) == 4
        for dtype, tol in (("bfloat16", 2e-2), ("float32", 2e-3)):
            train = r[dtype]
            assert train["mesh"] == [1, 2, 1, 1, 2, 1]
            assert train["dtype"] == dtype and train["loss_tol"] == tol
            assert len(train["loss_gaps"]) == 5
            assert max(train["loss_gaps"]) <= tol
            assert train["max_grad_rel_err"] <= 2e-2
            assert len(train["grad_rel_err"]) == 16  # 4 top + 12 blocks
            assert all(np.isfinite(train["sharded"]["losses"]))


def test_card_tool_trains_northstar4_on_cpu_workers(monkeypatch):
    """``tools/parallel_cards.py``'s part (c), phase 18's north-star #4
    loop, on 4 gloo ``TorchTrainer`` workers at a tiny size (f32, flash
    and remat as on the cards, B=8 x S=64, 1 + 2 steps): each worker reads
    its own dataset shard, the parameters and AdamW state are sharded over
    the (data=2, fsdp=2) mesh of the workers (each rank holds a part of
    them: ``wte`` split over fsdp), and every step's loss is within the
    tool's ``LOSS_TOL`` of the unsharded steps on the same global batches
    in this process."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the workers inherit it
    tools = os.path.join(os.path.dirname(HERE), "tools")
    monkeypatch.syspath_prepend(tools)
    import parallel_cards

    cfg = dict(vocab_size=512, max_seq=128, n_layer=2, n_head=4, d_model=64,
               dtype="float32", attention="flash", remat=True)
    rep = parallel_cards.northstar4_cards(4, device="cpu", cfg=cfg,
                                          shape=(8, 64, 1, 2))
    assert rep["workers"] == 4 and rep["mesh"] == [2, 2, 1, 1, 1, 1]
    assert rep["backend"] == "gloo"
    assert rep["loss_tol"] == parallel_cards.LOSS_TOL["float32"]
    assert len(rep["loss_gaps"]) == 3
    assert max(rep["loss_gaps"]) <= rep["loss_tol"]
    assert rep["losses"][-1] < rep["losses"][0]
    assert rep["wte_placements"] == ["R", "S(1)", "R", "R", "R", "R"]
    assert all(n < rep["params"] for n in rep["local_params_by_rank"])
    assert sorted(i for ids in rep["order"] for i in ids) == list(range(24))

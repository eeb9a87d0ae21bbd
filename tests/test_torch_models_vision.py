"""The port's vision models and MLP against the JAX package's, on the CPU.

ViT, ResNet and the MLP at tiny sizes in f32: JAX initialises the weights,
``params_from_jax`` / ``resnet_params_from_jax`` / ``mlp_params_from_jax``
copy them into the port, and the same seeded numpy images go through the
JAX function and its port: logits, the loss, every gradient leaf and
ResNet's ``new_state`` (train and eval mode) at rtol 1e-4 / atol 1e-5, the
tolerance of tests/test_torch_train.py.  ResNet runs the tiny basic-block
net at 32x32, a bottleneck net with a stride-2 projection, and a one-block
net at 224x224, whose 7x7 stride-2 stem pads (2, 3) and whose max-pool
pads (0, 1) with -inf, as XLA's SAME does.  The ViT runs
``attention="flash"``: on the CPU the port's ``_Flash`` runs the plain
recipe of the kernels, and the JAX flash falls back to its reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu.models as jm
from ray_tpu.models import mlp as jmlp
from ray_tpu.models import vit as jvit
from ray_tpu_torch import models as tm
from ray_tpu_torch.convert import (
    mlp_params_from_jax,
    params_from_jax,
    resnet_params_from_jax,
)
from ray_tpu_torch.models.params import as_tree

RTOL, ATOL = 1e-4, 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    """Nested dicts and lists → {dotted path: leaf}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tree}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}{k}."))
    return out


def _close(got, want, what):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL,
                               err_msg=what)


def _assert_grads(tparams, jgrads):
    """Every leaf's ``.grad`` against the JAX gradient tree, by path."""
    want = _flat(_np(jgrads))
    got = dict(tparams.named_parameters())
    assert set(got) == set(want)
    for name, w in want.items():
        _close(got[name].grad, w, f"grad of {name}")


def _images(seed, b, size):
    return np.random.default_rng(seed).standard_normal(
        (b, size, size, 3)).astype(np.float32)


def _labels(seed, b, n):
    return np.random.default_rng(seed).integers(0, n, (b,))


# ------------------------------------------------------------------- ViT
def _vit():
    jcfg = jm.ViTConfig.tiny(dtype="float32", attention="flash")
    tcfg = tm.ViTConfig.tiny(dtype="float32", attention="flash")
    jparams = jm.vit_init(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(_np(jparams), tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams.requires_grad_(True)


def test_vit_logits_match_jax():
    jcfg, tcfg, jparams, tparams = _vit()
    x = _images(1, 4, jcfg.image_size)
    want = jm.vit_apply(jparams, jnp.asarray(x), jcfg)
    got = tm.vit_apply(tparams, torch.from_numpy(x), tcfg)
    assert got.dtype == torch.float32 and got.shape == (4, 10)
    _close(got, want, "vit logits")


def test_vit_loss_and_every_gradient_leaf_match_jax():
    jcfg, tcfg, jparams, tparams = _vit()
    x, y = _images(2, 4, jcfg.image_size), _labels(3, 4, 10)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jm.vit_loss(p, jnp.asarray(x), jnp.asarray(y), jcfg)
    ))(jparams)
    tloss = tm.vit_loss(tparams, torch.from_numpy(x), torch.from_numpy(y),
                        tcfg)
    tloss.backward()
    _close(tloss, loss, "vit loss")
    _assert_grads(tparams, grads)


def test_vit_dense_equals_flash_on_the_cpu():
    _, tcfg, _, tparams = _vit()
    x = torch.from_numpy(_images(4, 2, tcfg.image_size))
    dense = tm.ViTConfig.tiny(dtype="float32")
    _close(tm.vit_apply(tparams, x, tcfg),
           tm.vit_apply(tparams, x, dense).detach().numpy(), "dense vs flash")


def test_patchify_matches_jax():
    cfg = jm.ViTConfig.tiny()
    x = _images(5, 2, cfg.image_size)
    want = jvit.patchify(jnp.asarray(x), cfg)
    got = tm.patchify(torch.from_numpy(x), tm.ViTConfig.tiny())
    assert got.shape == (2, cfg.n_patches, cfg.patch_size ** 2 * 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_vit_b16_geometry():
    from ray_tpu_torch.models.vit import vit_param_shapes

    cfg = tm.ViTConfig.b16()
    assert (cfg.n_patches + 1, cfg.head_dim, cfg.n_layer) == (197, 64, 12)
    shapes = jax.eval_shape(lambda: jm.vit_init(jax.random.PRNGKey(0),
                                                jm.ViTConfig.b16()))
    want = _flat(jax.tree.map(lambda s: str(tuple(s.shape)), shapes))
    assert _flat(jax.tree.map(str, vit_param_shapes(cfg),
                              is_leaf=lambda x: isinstance(x, tuple))) == want


def test_vit_param_axes_match_jax():
    def names(tree):
        if isinstance(tree, dict):
            return {k: names(v) for k, v in tree.items()}
        return tuple(tree)

    assert names(jm.vit_param_axes()) == tm.vit_param_axes()


# ---------------------------------------------------------------- ResNet
RESNETS = {
    "tiny_32": (dict(), 32, 4),
    "bottleneck_32": (dict(stages=((1, 8), (1, 8)), bottleneck=True), 32, 4),
    "one_block_224": (dict(stages=((1, 8),)), 224, 2),
}


def _resnet(name):
    kw, size, b = RESNETS[name]
    jcfg = jm.ResNetConfig.tiny(dtype="float32", **kw)
    tcfg = tm.ResNetConfig.tiny(dtype="float32", **kw)
    jparams, jstate = jm.resnet_init(jax.random.PRNGKey(0), jcfg)
    tparams, tstate = resnet_params_from_jax(_np(jparams), _np(jstate), tcfg,
                                             device="cpu")
    return jcfg, tcfg, jparams, jstate, tparams.requires_grad_(True), tstate, \
        _images(7, b, size)


def _states_close(got, want, what):
    want = _flat(_np(want))
    got = _flat(got)
    assert set(got) == set(want)
    for k, w in want.items():
        _close(got[k], w, f"{what} {k}")


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", sorted(RESNETS))
def test_resnet_logits_and_state_match_jax(name, train):
    jcfg, tcfg, jparams, jstate, tparams, tstate, x = _resnet(name)
    want, wstate = jax.jit(lambda p, s: jm.resnet_apply(
        p, s, jnp.asarray(x), jcfg, train=train))(jparams, jstate)
    got, gstate = tm.resnet_apply(tparams, tstate, torch.from_numpy(x), tcfg,
                                  train=train)
    _close(got, want, f"{name} logits")
    _states_close(gstate, wstate, f"{name} new_state")
    moved = not np.allclose(gstate["stem"]["mean"].numpy(),
                            tstate["stem"]["mean"].numpy())
    assert moved == train


@pytest.mark.parametrize("name", sorted(RESNETS))
def test_resnet_loss_and_every_gradient_leaf_match_jax(name):
    jcfg, tcfg, jparams, jstate, tparams, tstate, x = _resnet(name)
    y = _labels(8, x.shape[0], jcfg.num_classes)
    (loss, wstate), grads = jax.jit(jax.value_and_grad(
        lambda p, s: jm.resnet_loss(p, s, jnp.asarray(x), jnp.asarray(y),
                                    jcfg), has_aux=True))(jparams, jstate)
    tloss, gstate = tm.resnet_loss(tparams, tstate, torch.from_numpy(x),
                                   torch.from_numpy(y), tcfg)
    tloss.backward()
    _close(tloss, loss, f"{name} loss")
    _states_close(gstate, wstate, f"{name} new_state")
    _assert_grads(tparams, grads)


def test_same_pads_are_xla_same():
    from ray_tpu_torch.models.resnet import same_pads

    assert same_pads(224, 7, 2) == (2, 3)
    assert same_pads(112, 3, 2) == (0, 1)
    assert same_pads(56, 3, 1) == (1, 1)
    assert same_pads(56, 1, 2) == (0, 0)
    assert same_pads(7, 3, 2) == (1, 1)


def test_resnet50_parameter_count_matches_jax():
    jcfg = jm.ResNetConfig.resnet50()
    shapes = jax.eval_shape(lambda: jm.resnet_init(jax.random.PRNGKey(0),
                                                   jcfg))
    want = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes[0]))
    params, state = tm.resnet_init(torch.Generator().manual_seed(0),
                                   tm.ResNetConfig.resnet50(), device="cpu")
    got = sum(p.numel() for p in params.parameters())
    assert got == want and 2.0e7 < got < 3.0e7
    assert all(p.dtype == torch.bfloat16 for p in params.parameters())
    assert {t.dtype for t in _flat(state).values()} == {torch.float32}
    wstate = _flat(jax.tree.map(lambda s: str(tuple(s.shape)), shapes[1]))
    assert {k: str(tuple(t.shape)) for k, t in _flat(state).items()} == wstate


def test_resnet_param_axes_match_jax():
    jcfg = jm.ResNetConfig.tiny(stages=((1, 8), (1, 16)), bottleneck=True)
    jparams, _ = jm.resnet_init(jax.random.PRNGKey(0), jcfg)
    tparams, _ = tm.resnet_init(torch.Generator().manual_seed(0),
                                tm.ResNetConfig.tiny(stages=((1, 8), (1, 16)),
                                                     bottleneck=True),
                                device="cpu")
    want = _flat(jax.tree.map(tuple, jm.resnet_param_axes(jparams),
                              is_leaf=lambda x: isinstance(
                                  x, jax.sharding.PartitionSpec)))
    assert _flat(tm.resnet_param_axes(tparams)) == want


# ------------------------------------------------------------------- MLP
def test_mlp_forward_and_grads_match_jax():
    sizes = [8, 16, 4]
    jparams = jm.mlp_init(jax.random.PRNGKey(0), sizes)
    tparams = mlp_params_from_jax(_np(jparams), sizes, device="cpu")
    tparams.requires_grad_(True)
    x = np.random.default_rng(9).standard_normal((3, 8)).astype(np.float32)
    want, grads = jax.value_and_grad(
        lambda p: jmlp.mlp_apply(p, jnp.asarray(x)).sum())(jparams)
    got = tm.mlp_apply(tparams, torch.from_numpy(x))
    _close(got, jmlp.mlp_apply(jparams, jnp.asarray(x)), "mlp out")
    got.sum().backward()
    _assert_grads(tparams, grads)
    seeded = tm.mlp_init(torch.Generator().manual_seed(0), sizes, "cpu")
    assert {n: tuple(p.shape) for n, p in seeded.named_parameters()} == {
        "0.w": (8, 16), "0.b": (16,), "1.w": (16, 4), "1.b": (4,)}


def test_entry_points_need_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gen = torch.Generator()
    for init, cfg in ((tm.vit_init, tm.ViTConfig.tiny()),
                      (tm.resnet_init, tm.ResNetConfig.tiny()),
                      (tm.moe_init, tm.MoEConfig.tiny()),
                      (tm.mlp_init, [4, 2])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            init(gen, cfg)


def test_conversions_check_shapes():
    jparams, jstate = jm.resnet_init(jax.random.PRNGKey(0),
                                     jm.ResNetConfig.tiny())
    with pytest.raises(ValueError, match="stage1"):
        resnet_params_from_jax(_np(jparams), _np(jstate),
                               tm.ResNetConfig.tiny(stages=((1, 8),)),
                               device="cpu")
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(_np(jm.vit_init(jax.random.PRNGKey(0),
                                        jm.ViTConfig.tiny())),
                        tm.ViTConfig.tiny(d_model=32), device="cpu")
    bf16 = jm.vit_init(jax.random.PRNGKey(0), jm.ViTConfig.tiny())
    got = params_from_jax(_np(bf16), tm.ViTConfig.tiny(), device="cpu")
    want = np.asarray(bf16["blocks"]["wqkv"]).view(np.uint16)
    np.testing.assert_array_equal(
        as_tree(got)["blocks"]["wqkv"].view(torch.int16).numpy().view(
            np.uint16), want)

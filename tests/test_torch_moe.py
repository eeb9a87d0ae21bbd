"""The port's MoE LM against the JAX package's, on the CPU.

The tiny MoE config in f32: JAX initialises the weights, ``params_from_jax``
copies them into the port, and the same seeded token ids go through the
JAX function and its port: logits and the aux loss of ``moe_apply``, the
loss of ``moe_loss`` and every gradient leaf, at top-2 and top-1, with
dense and flash attention (the port's ``_Flash`` runs the kernels' plain
recipe on the CPU; the JAX flash falls back to its reference), and
``moe_ffn`` with ``capacity_factor=0.1``, where most tokens overflow their
expert's queue and are dropped: outputs equal JAX's, no error.  Tolerance
rtol 1e-4 / atol 1e-5, as tests/test_torch_train.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu.models as jm
from ray_tpu_torch import models as tm
from ray_tpu_torch.convert import params_from_jax

RTOL, ATOL = 1e-4, 1e-5
CASES = {
    "top2_dense": dict(),
    "top2_flash": dict(attention="flash"),
    "top1_flash": dict(attention="flash", top_k=1),
}


def _pair(**kw):
    jcfg = jm.MoEConfig.tiny(dtype="float32", **kw)
    tcfg = tm.MoEConfig.tiny(dtype="float32", **kw)
    jparams = jm.moe_init(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, tcfg, jparams, tparams.requires_grad_(True)


def _tokens(seed, b, s):
    return np.random.default_rng(seed).integers(0, 512, (b, s))


def _close(got, want, what):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL,
                               err_msg=what)


@pytest.mark.parametrize("case", sorted(CASES))
def test_logits_and_aux_match_jax(case):
    jcfg, tcfg, jparams, tparams = _pair(**CASES[case])
    tokens = _tokens(1, 2, 16)
    want, want_aux = jm.moe_apply(jparams, jnp.asarray(tokens), jcfg)
    got, aux = tm.moe_apply(tparams, torch.from_numpy(tokens), tcfg)
    _close(got, want, "logits")
    _close(aux, want_aux, "aux")
    assert aux.item() > 0.0


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_and_every_gradient_leaf_match_jax(case):
    jcfg, tcfg, jparams, tparams = _pair(**CASES[case])
    tokens = _tokens(2, 2, 17)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jm.moe_loss(p, jnp.asarray(tokens), jcfg)))(jparams)
    tloss = tm.moe_loss(tparams, torch.from_numpy(tokens), tcfg)
    tloss.backward()
    _close(tloss, loss, "loss")
    n = 0
    for key, g in grads.items():
        for sub, want in (g.items() if key == "blocks" else [(None, g)]):
            t = tparams.blocks[sub] if sub else tparams[key]
            _close(t.grad, want, f"grad of {key}.{sub}")
            n += 1
    assert n == len(list(tparams.parameters()))


@pytest.mark.parametrize("top_k", [1, 2])
def test_capacity_drops_tokens_as_jax_does(top_k):
    """capacity_factor=0.1 gives capacity 4 of 32 tokens a row: tokens past
    it are dropped (zero one-hot rows) without error, as in JAX."""
    jcfg, tcfg, jparams, tparams = _pair(capacity_factor=0.1, top_k=top_k)
    assert tcfg.capacity(32) == 4
    x = np.random.default_rng(3).standard_normal(
        (2, 32, tcfg.d_model)).astype(np.float32)
    layer = jax.tree.map(lambda p: p[0], jparams["blocks"])
    want, want_aux = jm.moe_ffn(jnp.asarray(x), layer["wg"], layer["wi"],
                                layer["wo2"], jcfg)
    blocks = tparams.blocks
    got, aux = tm.moe_ffn(torch.from_numpy(x), blocks["wg"][0],
                          blocks["wi"][0], blocks["wo2"][0], tcfg)
    assert got.shape == x.shape and torch.isfinite(got).all()
    _close(got, want, "ffn output")
    _close(aux, want_aux, "aux")
    # E * C = 16 slots for 32 tokens a row: at least half of the tokens
    # were dropped by every expert, and their rows are exactly zero.
    dropped = (got.abs().sum(-1) == 0).float().mean().item()
    assert dropped >= 0.5, dropped


def test_top_k_must_be_1_or_2():
    with pytest.raises(ValueError, match="top_k"):
        tm.MoEConfig.tiny(top_k=3)
    assert tm.MoEConfig.tiny(capacity_factor=0.0).capacity(16) == 4


def test_param_axes_match_jax():
    def names(tree):
        if isinstance(tree, dict):
            return {k: names(v) for k, v in tree.items()}
        return tuple(tree)

    assert names(jm.moe_param_axes()) == tm.moe_param_axes()


def test_remat_gives_the_same_loss_and_grads():
    _, tcfg, _, tparams = _pair(attention="flash")
    tokens = torch.from_numpy(_tokens(4, 2, 17))
    loss = tm.moe_loss(tparams, tokens, tcfg)
    grads = torch.autograd.grad(loss, list(tparams.parameters()))
    rcfg = tm.MoEConfig.tiny(dtype="float32", attention="flash", remat=True)
    rloss = tm.moe_loss(tparams, tokens, rcfg)
    rgrads = torch.autograd.grad(rloss, list(tparams.parameters()))
    assert torch.equal(loss, rloss)
    for g, r in zip(grads, rgrads):
        _close(r, g.numpy(), "remat gradient")

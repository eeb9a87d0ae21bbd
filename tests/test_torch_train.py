"""The port's training surface (losses, gradients, remat, the AdamW step)
against the JAX package's.

Both families at their tiny configs in f32: JAX initialises the weights,
``params_from_jax`` copies them into the port, and the same token ids go
through ``jax.value_and_grad`` of the JAX loss and ``loss.backward()`` of
the port's.  The port runs ``attention="flash"``, whose gradient goes
through ``_Flash`` and, on the CPU, the plain recipe of the backward
kernels; the JAX side off the TPU runs its reference attention.  Loss and
every gradient leaf are held at rtol 1e-4 / atol 1e-5, the tolerance of
the JAX package's own remat test (tests/test_models.py:98-100).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ray_tpu.models as jm
from ray_tpu_torch import models as tm
from ray_tpu_torch.convert import params_from_jax

RTOL, ATOL = 1e-4, 1e-5

FAMILIES = {
    "gpt2": dict(jcfg=jm.GPT2Config.tiny, tcfg=tm.GPT2Config.tiny,
                 jinit=jm.gpt2_init, japply=jm.gpt2_apply,
                 jloss=jm.gpt2_loss),
    "llama": dict(jcfg=jm.LlamaConfig.tiny, tcfg=tm.LlamaConfig.tiny,
                  jinit=jm.llama_init, japply=jm.llama_apply,
                  jloss=jm.llama_loss),
}


def _pair(name, **kw):
    """(family, JAX config, port config, JAX params, port params with
    gradients on), f32, flash attention."""
    f = FAMILIES[name]
    jcfg = f["jcfg"](dtype="float32", attention="flash", **kw)
    tcfg = f["tcfg"](dtype="float32", attention="flash", **kw)
    jparams = f["jinit"](jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return f, jcfg, tcfg, jparams, tparams.requires_grad_(True)


def _tokens(seed, b, s):
    return np.random.default_rng(seed).integers(0, 512, (b, s))


def _close(got, want, what):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL, err_msg=what)


def _assert_grads(tparams, jgrads):
    """Every leaf's ``.grad`` against the JAX gradient tree."""
    n = 0
    for key, g in jgrads.items():
        leaves = g.items() if key == "blocks" else [(None, g)]
        for sub, want in leaves:
            t = tparams.blocks[sub] if sub else tparams[key]
            _close(t.grad, want, f"grad of {key}{'.' + sub if sub else ''}")
            n += 1
    assert n == len(list(tparams.parameters()))


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_apply_is_differentiable(name):
    """The apply functions carry no inference mode: the gradient of a
    random projection of the logits, averaged over positions as a loss
    is, matches ``jax.grad`` of the JAX apply."""
    f, jcfg, tcfg, jparams, tparams = _pair(name)
    tokens = _tokens(1, 2, 9)
    cot = np.random.default_rng(2).standard_normal((2, 9, 512)).astype(
        np.float32) / 18
    jgrads = jax.jit(jax.grad(
        lambda p: (f["japply"](p, jnp.asarray(tokens), jcfg) * cot).sum()
    ))(jparams)
    logits = tm.model_family(tcfg).apply(tparams, torch.from_numpy(tokens),
                                         tcfg)
    (logits * torch.from_numpy(cot)).sum().backward()
    _assert_grads(tparams, jgrads)


@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
@pytest.mark.parametrize("ce_chunks", [0, 4])
@pytest.mark.parametrize("remat", [False, True])
def test_gpt2_loss_matches_jax(remat, ce_chunks, z_loss):
    _, jcfg, tcfg, jparams, tparams = _pair("gpt2", remat=remat)
    tokens = _tokens(3, 2, 17)  # S = 16, which 4 chunks divide
    loss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.gpt2_loss(p, jnp.asarray(tokens), jcfg, z_loss=z_loss,
                               ce_chunks=ce_chunks)))(jparams)
    got = tm.gpt2_loss(tparams, torch.from_numpy(tokens), tcfg,
                       z_loss=z_loss, ce_chunks=ce_chunks)
    _close(got, loss, "loss")
    got.backward()
    _assert_grads(tparams, jgrads)


def test_gpt2_dense_remat_loss_matches_jax():
    """``attention="dense_remat"``: dense attention recomputed in backward
    (``jax.checkpoint`` in the JAX package, ``torch.utils.checkpoint``
    here); the loss and every gradient leaf match."""
    jcfg = jm.GPT2Config.tiny(dtype="float32", attention="dense_remat")
    tcfg = tm.GPT2Config.tiny(dtype="float32", attention="dense_remat")
    jparams = jm.gpt2_init(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu").requires_grad_(True)
    tokens = _tokens(5, 2, 17)
    loss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.gpt2_loss(p, jnp.asarray(tokens), jcfg)))(jparams)
    got = tm.gpt2_loss(tparams, torch.from_numpy(tokens), tcfg)
    _close(got, loss, "loss")
    got.backward()
    _assert_grads(tparams, jgrads)


@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
@pytest.mark.parametrize("remat", [False, True])
def test_llama_loss_matches_jax(remat, z_loss):
    _, jcfg, tcfg, jparams, tparams = _pair("llama", remat=remat)
    tokens = _tokens(4, 2, 17)
    loss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.llama_loss(p, jnp.asarray(tokens), jcfg,
                                z_loss=z_loss)))(jparams)
    got = tm.llama_loss(tparams, torch.from_numpy(tokens), tcfg,
                        z_loss=z_loss)
    _close(got, loss, "loss")
    got.backward()
    _assert_grads(tparams, jgrads)


def test_adamw_steps_match_optax():
    """The train step (loss, backward, ``torch.optim.AdamW`` with optax's
    defaults) against ``optax.adamw``: three steps on one batch, the
    losses each step and every parameter after the last."""
    _, jcfg, tcfg, jparams, tparams = _pair("gpt2", remat=True)
    tokens = _tokens(5, 2, 17)
    jt = jnp.asarray(tokens)
    tx = optax.adamw(1e-3)

    @jax.jit
    def jstep(p, o):
        loss, g = jax.value_and_grad(lambda p: jm.gpt2_loss(p, jt, jcfg))(p)
        updates, o = tx.update(g, o, p)
        return optax.apply_updates(p, updates), o, loss

    opt = torch.optim.AdamW(tparams.parameters(), lr=1e-3,
                            betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
    jp, jo, losses = jparams, tx.init(jparams), []
    for step in range(3):
        jp, jo, jloss = jstep(jp, jo)
        opt.zero_grad(set_to_none=True)
        loss = tm.gpt2_loss(tparams, torch.from_numpy(tokens), tcfg)
        loss.backward()
        opt.step()
        _close(loss, jloss, f"loss at step {step}")
        losses.append(loss.item())
    assert losses[-1] < losses[0]
    for key, want in jp.items():
        leaves = want.items() if key == "blocks" else [(None, want)]
        for sub, w in leaves:
            t = tparams.blocks[sub] if sub else tparams[key]
            if sub != "bqkv":
                _close(t, w, f"{key}{'.' + sub if sub else ''} after 3 steps")
                continue
            # The key bias bqkv[:, 1] has a gradient of exactly 0 (softmax
            # ignores a shift shared by every key), so each side's AdamW
            # step is its own f32 rounding noise divided by its own
            # sqrt(v): only Adam's bound, at most ~lr a step, holds there.
            w = np.asarray(w)
            _close(t[:, 0::2], w[:, 0::2], "q and v biases after 3 steps")
            np.testing.assert_allclose(t[:, 1].detach().numpy(), w[:, 1],
                                       rtol=0, atol=3 * 1e-3)


def test_ce_chunks_must_divide_the_sequence():
    _, _, tcfg, _, tparams = _pair("gpt2")
    with pytest.raises(ValueError, match="must divide"):
        tm.gpt2_loss(tparams, torch.from_numpy(_tokens(6, 2, 17)), tcfg,
                     ce_chunks=5)


@pytest.mark.parametrize("policy",
                         ["dots", "dots_all", "matmuls", "save_mlp"])
def test_named_remat_policies_are_not_ported(policy):
    """The named policies, once refused, now run (the name is kept from
    when they raised): each gives the loss of the run with no remat, and
    tests/test_torch_remat_policies.py holds their gradients."""
    _, _, tcfg, _, tparams = _pair("gpt2", remat=True, remat_policy=policy)
    tokens = torch.from_numpy(_tokens(7, 2, 9))
    plain = tm.gpt2_loss(tparams, tokens,
                         tm.GPT2Config.tiny(dtype="float32",
                                            attention="flash"))
    _close(tm.gpt2_loss(tparams, tokens, tcfg), plain.detach().numpy(),
           f"loss under remat_policy={policy}")


def test_unknown_remat_policy_is_full_remat():
    """As in JAX (gpt2.py:245), an unknown policy falls through to full."""
    _, _, tcfg, _, tparams = _pair("gpt2", remat=True, remat_policy="other")
    tokens = torch.from_numpy(_tokens(8, 2, 9))
    full = tm.gpt2_loss(tparams, tokens,
                        tm.GPT2Config.tiny(dtype="float32", remat=True))
    assert torch.equal(tm.gpt2_loss(tparams, tokens, tcfg), full)


def test_loss_is_registered_for_both_families():
    assert tm.model_family(tm.GPT2Config.tiny()).loss is tm.gpt2_loss
    assert tm.model_family(tm.LlamaConfig.tiny()).loss is tm.llama_loss


def test_params_stay_frozen_until_a_trainer_unfreezes_them():
    fam = tm.model_family(tm.GPT2Config.tiny())
    params = fam.init(torch.Generator().manual_seed(0), tm.GPT2Config.tiny(),
                      "cpu")
    assert not any(p.requires_grad for p in params.parameters())
    params.requires_grad_(True)
    assert all(p.requires_grad for p in params.parameters())

"""GPT-2's named remat policies in the port, against the run with no remat
and against the JAX package under the same policy.

``dots``, ``dots_all``, ``matmuls`` and ``save_mlp`` (``ray_tpu/models/
gpt2.py:213-244``) run through ``torch.utils.checkpoint`` with a selective
checkpoint policy.  Remat changes no value: at tiny f32 (JAX weights
carried by ``params_from_jax``) the loss and every gradient leaf equal the
port's run with no remat and ``jax.value_and_grad`` of the JAX loss under
the same policy, at rtol 1e-4 / atol 1e-5, with dense and flash attention.
A policy's saves are checked too: the forward of a remat block keeps the
tensors its policy names (counted by the checkpoint's cache).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu.models as jm
from ray_tpu_torch import models as tm
from ray_tpu_torch.convert import params_from_jax
from ray_tpu_torch.models import gpt2 as tgpt2

RTOL, ATOL = 1e-4, 1e-5
POLICIES = ["dots", "dots_all", "matmuls", "save_mlp"]
TOKENS = np.random.default_rng(5).integers(0, 512, (2, 17))


def _close(got, want, what):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL, err_msg=what)


def _params(attention):
    jparams = jm.gpt2_init(jax.random.PRNGKey(0), jm.GPT2Config.tiny(
        dtype="float32"))
    return jparams, params_from_jax(
        jax.tree.map(np.asarray, jparams),
        tm.GPT2Config.tiny(dtype="float32", attention=attention),
        device="cpu").requires_grad_(True)


def _port_grads(tparams, cfg):
    for p in tparams.parameters():
        p.grad = None
    loss = tm.gpt2_loss(tparams, torch.from_numpy(TOKENS), cfg)
    loss.backward()
    return loss, {n: p.grad.clone() for n, p in tparams.named_parameters()}


@pytest.mark.parametrize("attention", ["dense", "flash"])
@pytest.mark.parametrize("policy", POLICIES)
def test_policy_gives_the_no_remat_loss_and_grads(policy, attention):
    jparams, tparams = _params(attention)
    plain = tm.GPT2Config.tiny(dtype="float32", attention=attention)
    cfg = tm.GPT2Config.tiny(dtype="float32", attention=attention,
                             remat=True, remat_policy=policy)
    loss0, grads0 = _port_grads(tparams, plain)
    loss, grads = _port_grads(tparams, cfg)
    _close(loss, loss0.detach().numpy(), "loss against no remat")
    for name, g in grads.items():
        _close(g, grads0[name].numpy(), f"grad of {name} against no remat")
    jcfg = jm.GPT2Config.tiny(dtype="float32", attention=attention,
                              remat=True, remat_policy=policy)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.gpt2_loss(p, jnp.asarray(TOKENS), jcfg)))(jparams)
    _close(loss, jloss, "loss against JAX")
    for key, g in jgrads.items():
        for sub, want in (g.items() if key == "blocks" else [(None, g)]):
            _close(grads[f"blocks.{sub}" if sub else key], want,
                   f"grad of {key}.{sub} against JAX")


@pytest.mark.parametrize("policy,saved", [
    ("dots", {"bmm_batch1": 4, "bmm_batched": 0, "names": 0}),
    ("dots_all", {"bmm_batch1": 4, "bmm_batched": 2, "names": 0}),
    ("matmuls", {"bmm_batch1": 0, "bmm_batched": 0, "names": 4}),
    ("save_mlp", {"bmm_batch1": 0, "bmm_batched": 0, "names": 1}),
])
def test_policy_saves_what_the_jax_policy_names(policy, saved):
    """One dense block's forward under each policy: the ops the policy
    saves — the four projections (matmuls with no batch dims), the two
    batched attention matmuls, the tagged tensors — counted by the
    decisions the policy makes."""
    from torch.utils.checkpoint import CheckpointPolicy

    _, tparams = _params("dense")
    cfg = tm.GPT2Config.tiny(dtype="float32", remat=True,
                             remat_policy=policy)
    counts = {"bmm_batch1": 0, "bmm_batched": 0, "names": 0}
    names, dots = tgpt2.REMAT_POLICIES[policy]

    def counting(ctx, func, *args, **kwargs):
        got = tgpt2._remat_policy(ctx, func, *args, names=names, dots=dots)
        if got == CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
            if func is torch.ops.ray_tpu_torch.checkpoint_name.default:
                counts["names"] += 1
            elif args[-2].shape[0] == 1:
                counts["bmm_batch1"] += 1
            else:
                counts["bmm_batched"] += 1
        return got

    from torch.utils.checkpoint import (
        checkpoint,
        create_selective_checkpoint_contexts,
    )

    x = torch.randn(2, 8, 64, requires_grad=True)
    layer = tparams.layer(0)
    out = checkpoint(tgpt2._block, x, layer, cfg, use_reentrant=False,
                     context_fn=lambda: create_selective_checkpoint_contexts(
                         counting))
    out.sum().backward()
    assert counts == saved

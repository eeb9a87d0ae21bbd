"""The port's model families (ray_tpu_torch.models) against the JAX package's.

Both families at their tiny configs in f32: JAX initialises the weights,
``params_from_jax`` copies them into the port, and the same token ids go
through both.  Logits are compared at rtol/atol 1e-4: both sides compute
in f32 and differ only in the order XLA and PyTorch sum the matmuls and
softmaxes of two layers, which moves logits of magnitude ~1 by ~1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu.models as jm
from ray_tpu_torch import models as tm
from ray_tpu_torch.convert import params_from_jax
from ray_tpu_torch.models.gpt2_decode import filter_logits

LOGIT_TOL = 1e-4

FAMILIES = {
    "gpt2": dict(
        jcfg=jm.GPT2Config.tiny, tcfg=tm.GPT2Config.tiny, jinit=jm.gpt2_init,
        japply=jm.gpt2_apply, jprefill=jm.gpt2_prefill,
        jdecode=jm.gpt2_decode_step, jcache=jm.gpt2_init_cache,
    ),
    "llama": dict(
        jcfg=jm.LlamaConfig.tiny, tcfg=tm.LlamaConfig.tiny,
        jinit=jm.llama_init, japply=jm.llama_apply,
        jprefill=jm.llama_prefill, jdecode=jm.llama_decode_step,
        jcache=jm.llama_init_cache,
    ),
}


def _pair(name, dtype="float32", seed=0, **kw):
    f = FAMILIES[name]
    jcfg = f["jcfg"](dtype=dtype, **kw)
    tcfg = f["tcfg"](dtype=dtype, **kw)
    jparams = f["jinit"](jax.random.PRNGKey(seed), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return f, jcfg, tcfg, jparams, tparams


def _close(got, want, tol=LOGIT_TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("name", sorted(FAMILIES))
class TestFamilies:
    def test_params_from_jax_keeps_bf16_bits(self, name):
        _, _, tcfg, jparams, tparams = _pair(name, dtype="bfloat16")
        jleaves = jax.tree_util.tree_leaves_with_path(jparams)
        assert len(jleaves) == len(list(tparams.parameters()))
        for path, leaf in jleaves:
            keys = [p.key for p in path]
            t = tparams[keys[0]] if len(keys) == 1 \
                else tparams["blocks"][keys[1]]
            assert t.dtype == torch.bfloat16
            assert tuple(t.shape) == leaf.shape
            np.testing.assert_array_equal(
                t.view(torch.int16).numpy(),
                np.asarray(leaf).view(np.int16),
            )

    def test_params_from_jax_rejects_other_shapes(self, name):
        f, jcfg, tcfg, jparams, _ = _pair(name)
        tree = jax.tree.map(np.asarray, jparams)
        tree["blocks"]["wo"] = tree["blocks"]["wo"][:1]
        with pytest.raises(ValueError, match="wo"):
            params_from_jax(tree, tcfg, device="cpu")

    def test_init_matches_jax_layout_and_is_seeded(self, name):
        f, jcfg, tcfg, jparams, _ = _pair(name, dtype="bfloat16")
        fam = tm.model_family(tcfg)
        a = fam.init(torch.Generator().manual_seed(1), tcfg, "cpu")
        b = fam.init(torch.Generator().manual_seed(1), tcfg, "cpu")
        for (ka, ta), (_, tb) in zip(a.named_parameters(),
                                     b.named_parameters()):
            assert torch.equal(ta, tb), ka
            assert ta.dtype == torch.bfloat16 and not ta.requires_grad
        jshapes = [l.shape for l in jax.tree.leaves(jparams)]
        tree = {k: getattr(a, k) for k in jparams if k != "blocks"}
        tree["blocks"] = dict(a.blocks.items())
        assert [tuple(t.shape) for t in jax.tree.leaves(tree)] == jshapes

    @pytest.mark.parametrize("attention", ["dense", "flash"])
    def test_apply_matches_jax(self, name, attention):
        f, jcfg, tcfg, jparams, tparams = _pair(name, attention=attention)
        tokens = np.random.default_rng(0).integers(0, 512, (2, 19))
        want = f["japply"](jparams, jnp.asarray(tokens), jcfg)
        got = tm.model_family(tcfg).apply(tparams, torch.from_numpy(tokens),
                                          tcfg)
        assert got.shape == (2, 19, 512)
        _close(got, want)

    def test_prefill_then_decode_match_jax(self, name):
        """Right-padded prefill (logits and cache rows below each length),
        then several ragged decode steps (logits and the rows they write)."""
        f, jcfg, tcfg, jparams, tparams = _pair(name)
        fam = tm.model_family(tcfg)
        rng = np.random.default_rng(1)
        tokens = rng.integers(0, 512, (2, 12))
        lengths = np.array([12, 7])
        jcache = f["jcache"](jcfg, 2, 32)
        jlogits, jcache = f["jprefill"](jparams, jnp.asarray(tokens),
                                        jnp.asarray(lengths), jcache, jcfg)
        tcache = fam.init_cache(tcfg, 2, 32, "cpu")
        tlogits, tcache = fam.prefill(tparams, torch.from_numpy(tokens),
                                      torch.from_numpy(lengths), tcache, tcfg)
        _close(tlogits, jlogits)
        for b, n in enumerate(lengths):
            for key in ("k", "v"):
                _close(tcache[key][:, b, :, :n], jcache[key][:, b, :, :n])
        pos = lengths.astype(np.int32)
        for step in range(4):
            toks = rng.integers(0, 512, 2)
            jlogits, jcache = f["jdecode"](jparams, jnp.asarray(toks),
                                           jnp.asarray(pos), jcache, jcfg)
            tlogits, tcache = fam.decode_step(
                tparams, torch.from_numpy(toks), torch.from_numpy(pos),
                tcache, tcfg)
            _close(tlogits, jlogits)
            for b, n in enumerate(pos):
                for key in ("k", "v"):
                    _close(tcache[key][:, b, :, :n + 1],
                           jcache[key][:, b, :, :n + 1])
            pos = pos + 1


def test_rope_matches_jax():
    from ray_tpu.models.llama import rope as jrope
    from ray_tpu_torch.models.llama import rope

    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 3, 8)).astype(np.float32)
    pos = rng.integers(0, 100, (2, 5)).astype(np.int32)
    _close(rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0),
           jrope(jnp.asarray(x), jnp.asarray(pos), 10000.0), 1e-5)


def test_norms_match_jax_in_bf16():
    """f32 arithmetic, cast back: bit-equal up to one bf16 rounding."""
    from ray_tpu.models.gpt2 import _layernorm as jln
    from ray_tpu.models.llama import _rmsnorm as jrms
    from ray_tpu_torch.models.gpt2 import _layernorm
    from ray_tpu_torch.models.llama import _rmsnorm

    rng = np.random.default_rng(3)
    x, g, b = (rng.standard_normal(s).astype(np.float32)
               for s in ((4, 32), (32,), (32,)))
    jx, jg, jb = (jnp.asarray(a, jnp.bfloat16) for a in (x, g, b))
    tx, tg, tb = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, g, b))
    _close(_layernorm(tx, tg, tb).float(),
           np.asarray(jln(jx, jg, jb), np.float32), 1e-2)
    _close(_rmsnorm(tx, tg, 1e-5).float(),
           np.asarray(jrms(jx, jg, 1e-5), np.float32), 1e-2)


class TestSampling:
    def test_greedy_matches_jax_exactly(self):
        rng = np.random.default_rng(4)
        logits = rng.standard_normal((16, 300)).astype(np.float32)
        logits[3, [7, 9]] = 10.0  # a tie: both take the first index
        want = jm.sample_logits(jnp.asarray(logits), jax.random.PRNGKey(0),
                                0.0)
        got = tm.sample_logits(torch.from_numpy(logits),
                               torch.Generator().manual_seed(0), 0.0)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert int(got[3]) == 7

    @pytest.mark.parametrize("top_k,top_p", [(5, 1.0), (0, 0.6), (8, 0.7)])
    def test_top_k_top_p_keep_the_same_tokens(self, top_k, top_p):
        """The set of tokens the JAX sampler can draw equals the port's
        unmasked set, and the port draws only from it.  The kept tokens
        share most of the mass evenly, so 4000 draws reach each of them
        (a kept token is missed with probability < 1e-20)."""
        logits = np.full((1, 64), -2.0, np.float32)
        logits[0, :10] = np.linspace(3.0, 2.6, 10)
        tiled = np.repeat(logits, 4000, axis=0)
        jdraws = jm.sample_logits(jnp.asarray(tiled), jax.random.PRNGKey(1),
                                  1.0, top_k=top_k, top_p=top_p)
        kept = filter_logits(torch.from_numpy(logits), 1.0, top_k, top_p)
        kept_set = set(np.flatnonzero(kept.numpy()[0] > -1e29).tolist())
        assert set(np.asarray(jdraws).tolist()) == kept_set
        tdraws = tm.sample_logits(torch.from_numpy(tiled),
                                  torch.Generator().manual_seed(1), 1.0,
                                  top_k=top_k, top_p=top_p)
        assert set(tdraws.tolist()) == kept_set
        # Same distribution: per-token frequencies within 4 sigma.
        jf = np.bincount(np.asarray(jdraws), minlength=64) / 4000
        tf = np.bincount(tdraws.numpy(), minlength=64) / 4000
        assert np.all(np.abs(jf - tf) <= 4 * np.sqrt(2 * 0.25 / 4000))


def test_model_family_registry():
    assert tm.model_family(tm.GPT2Config.tiny()).name == "gpt2"
    assert tm.model_family(tm.LlamaConfig.tiny()).name == "llama"
    with pytest.raises(TypeError):
        tm.model_family(object())

"""The port's attention ops (ray_tpu_torch.ops) against the JAX package's.

Inputs are made with numpy from a seed and handed to both.  On the CPU the
port's wrappers run their plain versions; the JAX side runs its Pallas
kernels in interpret mode where it has them, so each test holds the port's
function against the TPU kernel's own semantics.  The CUDA kernels
themselves are held against these plain versions on the card by
chip_smoke.py.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops.attention import (
    _flash_fwd,
    flash_attention,
    reference_attention,
)
from ray_tpu_torch.ops.decode_attention import (
    decode_attention,
    reference_decode_attention,
    write_token_to_cache,
)

# ``ray_tpu.ops`` re-exports functions under its modules' names.
jattn = importlib.import_module("ray_tpu.ops.attention")
jdec = importlib.import_module("ray_tpu.ops.decode_attention")

# f32 tolerances of the JAX package's own tests: flash output
# (tests/test_parallel.py:70-78), decode output
# (tests/test_llama_kernels.py:128-186).
FLASH_TOL = 2e-4
DECODE_TOL = 1e-5


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


class TestAttention:
    @pytest.mark.parametrize("causal", [True, False])
    def test_reference_matches_jax(self, causal):
        rng = np.random.default_rng(0)
        q, k, v = (_rand(rng, 2, 24, 3, 16) for _ in range(3))
        want = jattn.reference_attention(q, k, v, causal=causal)
        got = reference_attention(_t(q), _t(k), _t(v), causal=causal)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=FLASH_TOL, atol=FLASH_TOL)

    @pytest.mark.parametrize("causal", [True, False])
    def test_flash_matches_jax_pallas_interpret(self, causal):
        """Output and per-row lse against the Pallas forward kernel run in
        interpret mode (the path force_pallas takes off the TPU)."""
        rng = np.random.default_rng(1)
        q, k, v = (_rand(rng, 2, 32, 2, 16) for _ in range(3))
        want = jattn.flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
            force_pallas=True, block_q=16, block_k=16,
        )
        _, want_lse = jattn._flash_fwd(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal,
            16 ** -0.5, 16, 16, True,
        )
        out, lse = _flash_fwd(_t(q), _t(k), _t(v), causal)
        np.testing.assert_allclose(out.numpy(), np.asarray(want),
                                   rtol=FLASH_TOL, atol=FLASH_TOL)
        assert lse.shape == want_lse.shape == (4, 32, 1)
        np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse),
                                   rtol=FLASH_TOL, atol=FLASH_TOL)
        np.testing.assert_allclose(
            flash_attention(_t(q), _t(k), _t(v), causal=causal).numpy(),
            out.numpy(), rtol=0, atol=0,
        )

    def test_flash_any_length_and_strided_inputs(self):
        """A length that is no multiple of any block, and q/k/v that are
        strided slices of one fused qkv (GPT-2's layout)."""
        rng = np.random.default_rng(2)
        qkv = _rand(rng, 1, 23, 3, 2, 16)
        q, k, v = (qkv[:, :, i] for i in range(3))
        want = jattn.reference_attention(q, k, v, causal=True)
        tq = _t(qkv)
        got = flash_attention(tq[:, :, 0], tq[:, :, 1], tq[:, :, 2])
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=FLASH_TOL, atol=FLASH_TOL)

    def test_wrappers_refuse_other_devices(self):
        """No quiet fallback: a tensor that is on neither the CPU nor a GPU
        raises instead of running the plain version."""
        q = torch.empty(1, 4, 2, 64, device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            flash_attention(q, q, q)
        qd = torch.empty(1, 2, 64, device="meta")
        cache = torch.empty(1, 1, 2, 8, 64, device="meta")
        pos = torch.zeros(1, dtype=torch.int32, device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            decode_attention(qd, cache, cache, pos, 0)


def _decode_data(seed, b=3, t=64, h=4, hkv=4, d=16, layers=2):
    rng = np.random.default_rng(seed)
    return dict(
        q=_rand(rng, b, h, d),
        k=_rand(rng, layers, b, hkv, t, d),
        v=_rand(rng, layers, b, hkv, t, d),
        ks=_rand(rng, b, hkv, d),
        vs=_rand(rng, b, hkv, d),
        pos=np.array([0, 31, 63], np.int32)[:b],
    )


class TestDecodeAttention:
    @pytest.mark.parametrize("hkv", [4, 2], ids=["mha", "gqa"])
    @pytest.mark.parametrize("layer", [0, 1])
    def test_self_form_matches_jax_kernel(self, hkv, layer):
        """Deferred-scatter form against the Pallas decode kernel in
        interpret mode: ragged pos including 0, GQA, either layer."""
        x = _decode_data(3, hkv=hkv)
        want = jdec.decode_attention(
            jnp.asarray(x["q"]), jnp.asarray(x["k"]), jnp.asarray(x["v"]),
            jnp.asarray(x["pos"]), layer, k_self=jnp.asarray(x["ks"]),
            v_self=jnp.asarray(x["vs"]), block_t=16, kernel=True,
            interpret=True,
        )
        got = decode_attention(
            _t(x["q"]), _t(x["k"]), _t(x["v"]), _t(x["pos"]), layer,
            k_self=_t(x["ks"]), v_self=_t(x["vs"]),
        )
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=DECODE_TOL, atol=DECODE_TOL)

    @pytest.mark.parametrize("t", [64, 60], ids=["t64", "t60"])
    @pytest.mark.parametrize("hkv", [4, 2], ids=["mha", "gqa"])
    def test_without_self_matches_jax_reference(self, t, hkv):
        """Cache-only form (attends [0, pos]) and a cache length that no
        block divides, against the JAX reference."""
        x = _decode_data(4, t=t, hkv=hkv)
        x["pos"] = np.array([0, 17, t - 1], np.int32)
        want = jdec.reference_decode_attention(
            x["q"], x["k"], x["v"], x["pos"], 1)
        got = reference_decode_attention(
            _t(x["q"]), _t(x["k"]), _t(x["v"]), _t(x["pos"]), 1)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=DECODE_TOL, atol=DECODE_TOL)
        np.testing.assert_allclose(
            decode_attention(_t(x["q"]), _t(x["k"]), _t(x["v"]),
                             _t(x["pos"]), 1).numpy(),
            got.numpy(), rtol=0, atol=0,
        )

    def test_pos_zero_attends_only_self(self):
        x = _decode_data(5, hkv=2)
        pos = torch.zeros(3, dtype=torch.int32)
        out = decode_attention(_t(x["q"]), _t(x["k"]), _t(x["v"]), pos, 0,
                               k_self=_t(x["ks"]), v_self=_t(x["vs"]))
        expect = np.repeat(x["vs"], 2, axis=1)  # each kv head serves G=2
        np.testing.assert_allclose(out.numpy(), expect, atol=DECODE_TOL)

    def test_write_token_to_cache_matches_jax(self):
        rng = np.random.default_rng(6)
        cache = _rand(rng, 2, 3, 2, 10, 4)
        new = _rand(rng, 2, 3, 2, 4)
        pos = np.array([0, 9, 4], np.int32)
        want = jdec.write_token_to_cache(jnp.asarray(cache),
                                         jnp.asarray(new), jnp.asarray(pos))
        got = torch.from_numpy(cache.copy())
        out = write_token_to_cache(got, _t(new), _t(pos))
        assert out is got  # in place
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_self_k_v_must_come_together(self):
        x = _decode_data(7)
        with pytest.raises(ValueError, match="both"):
            decode_attention(_t(x["q"]), _t(x["k"]), _t(x["v"]),
                             _t(x["pos"]), 0, k_self=_t(x["ks"]))


class TestBuild:
    def test_library_name_hashes_sources_and_flags(self):
        paths = {n: _build.library_path(n) for n in _build.KERNELS}
        assert len(set(paths.values())) == len(_build.KERNELS)
        for name, path in paths.items():
            assert path == _build.library_path(name)  # stable
            assert path.parent == _build.BUILD_DIR
            assert path.name.startswith(f"lib{name}-")
            assert (_build.CSRC / f"{name}.cu").exists()
        assert _build.BUILD_DIR.parts[-2:] == ("build", "ray_tpu_torch")
        assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS

    def test_launch_error_raises(self):
        class FakeLib:
            @staticmethod
            def rt_error_string(code):
                return b"invalid argument"

        _build.check(FakeLib, 0, "ok")
        with pytest.raises(RuntimeError, match="invalid argument"):
            _build.check(FakeLib, 1, "decode_attention")

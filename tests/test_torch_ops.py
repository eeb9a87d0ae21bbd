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
    _flash_bwd,
    _flash_fwd,
    flash_attention,
    flash_delta,
    flash_dkv,
    flash_dq,
    reference_attention,
    reference_flash_bwd,
    tma_ready,
)
from ray_tpu_torch.ops.decode_attention import (
    SPLIT_T,
    decode_attention,
    reference_decode_attention,
    reference_decode_attention_split,
    split_plan,
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
# f32 flash gradients: the JAX package allows 1e-3
# (tests/test_parallel.py:94-99); both sides compute in f32 and differ only
# in summation order, which moves gradients of size ~1 by ~1e-6.
GRAD_TOL = 1e-4


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


class TestFlashBackward:
    @pytest.mark.parametrize("causal", [True, False])
    def test_grads_match_jax_pallas_interpret(self, causal):
        """dq, dk, dv through ``_Flash`` (the plain recipe on the CPU)
        against ``jax.grad`` of the Pallas forward + dq/dkv kernels in
        interpret mode, with a random output cotangent."""
        import jax

        rng = np.random.default_rng(8)
        q, k, v, g = (_rand(rng, 2, 32, 2, 16) for _ in range(4))

        def jloss(q, k, v):
            out = jattn.flash_attention(q, k, v, causal=causal,
                                        force_pallas=True, block_q=16,
                                        block_k=16)
            return (out * g).sum()

        want = jax.grad(jloss, argnums=(0, 1, 2))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        tq, tk, tv = (_t(x).requires_grad_(True) for x in (q, k, v))
        got = torch.autograd.grad(
            flash_attention(tq, tk, tv, causal=causal), (tq, tk, tv), _t(g))
        for name, a, b in zip("qkv", got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=GRAD_TOL, atol=GRAD_TOL,
                                       err_msg=f"d{name}")

    @pytest.mark.parametrize("causal", [True, False])
    def test_plain_recipe_matches_autograd_on_fused_qkv(self, causal):
        """S=23 (no multiple of any block) on strided slices of one fused
        qkv: the gradient of qkv through ``flash_attention`` (the plain
        recipe) equals autograd through ``reference_attention``."""
        rng = np.random.default_rng(9)
        qkv = _t(_rand(rng, 2, 23, 3, 2, 16)).requires_grad_(True)
        g = _t(_rand(rng, 2, 23, 2, 16))

        def grad(fn):
            out = fn(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], causal=causal)
            return torch.autograd.grad(out, qkv, g)[0]

        np.testing.assert_allclose(grad(flash_attention).numpy(),
                                   grad(reference_attention).numpy(),
                                   rtol=GRAD_TOL, atol=GRAD_TOL)

    def test_plain_recipe_matches_autograd_with_gqa(self):
        """k/v repeated to H heads (Llama's GQA): the backward of
        ``repeat_interleave`` sums the flash gradients per kv head."""
        rng = np.random.default_rng(10)
        q = _t(_rand(rng, 2, 19, 4, 16)).requires_grad_(True)
        k, v = (_t(_rand(rng, 2, 19, 2, 16)).requires_grad_(True)
                for _ in range(2))
        g = _t(_rand(rng, 2, 19, 4, 16))

        def grads(fn):
            out = fn(q, torch.repeat_interleave(k, 2, dim=2),
                     torch.repeat_interleave(v, 2, dim=2), causal=True)
            return torch.autograd.grad(out, (q, k, v), g)

        for a, b in zip(grads(flash_attention), grads(reference_attention)):
            assert a.shape == b.shape
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=GRAD_TOL,
                                       atol=GRAD_TOL)

    def test_wrappers_and_plain_bwd_agree_on_cpu(self):
        """On CPU tensors ``_flash_bwd`` and each kernel wrapper run the
        plain versions: bit-equal to ``reference_flash_bwd``."""
        rng = np.random.default_rng(11)
        q, k, v, do = (_t(_rand(rng, 1, 21, 2, 16)) for _ in range(4))
        o, lse = _flash_fwd(q, k, v, True)
        want = reference_flash_bwd(q, k, v, o, lse, do, True)
        delta = flash_delta(o, do)
        assert delta.shape == lse.shape == (2, 21, 1)
        got = (flash_dq(q, k, v, do, lse, delta, True),
               *flash_dkv(q, k, v, do, lse, delta, True))
        for a, b, c in zip(got, _flash_bwd(q, k, v, o, lse, do, True), want):
            assert torch.equal(a, c) and torch.equal(b, c)

    def test_bf16_rounds_where_the_jax_kernels_round(self):
        """In bf16 the plain recipe rounds P and dS where the Pallas kernels
        do, so it lands within a few bf16 steps of them (interpret mode)."""
        import jax

        rng = np.random.default_rng(12)
        q, k, v, g = (_rand(rng, 1, 32, 2, 16) for _ in range(4))
        jb = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, g)]
        _, vjp = jax.vjp(
            lambda q, k, v: jattn._flash(q, k, v, True, 16, 16, True),
            *jb[:3])
        want = vjp(jb[3])
        tb = [_t(x).to(torch.bfloat16) for x in (q, k, v, g)]
        o, lse = _flash_fwd(*tb[:3], True)
        got = reference_flash_bwd(*tb[:3], o, lse, tb[3], True)
        for name, a, b in zip("qkv", got, want):
            b = np.asarray(b, np.float32)
            np.testing.assert_allclose(a.float().numpy(), b,
                                       atol=2e-2 * np.abs(b).max(), rtol=0,
                                       err_msg=f"d{name}")

    @pytest.mark.parametrize("causal", [True, False])
    def test_bf16_forward_rounds_where_the_jax_kernel_rounds(self, causal):
        """In bf16 the plain forward (out and lse) lands within 2e-2 of the
        largest value of the Pallas forward in interpret mode, which rounds
        P to bf16 before P.V as the wgmma kernel does."""
        rng = np.random.default_rng(13)
        q, k, v = (_rand(rng, 1, 48, 2, 16) for _ in range(3))
        jb = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
        want_out, want_lse = jattn._flash_fwd(*jb, causal, 16 ** -0.5, 16, 16,
                                              True)
        out, lse = _flash_fwd(*(_t(x).to(torch.bfloat16) for x in (q, k, v)),
                              causal)
        assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
        for name, a, b in (("out", out, want_out), ("lse", lse, want_lse)):
            b = np.asarray(b, np.float32)
            assert a.shape == b.shape
            np.testing.assert_allclose(a.float().numpy(), b,
                                       atol=2e-2 * np.abs(b).max(), rtol=0,
                                       err_msg=name)

    def test_backward_refuses_other_devices(self):
        x = torch.empty(1, 4, 2, 64, device="meta")
        lse = torch.empty(2, 4, 1, device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            _flash_bwd(x, x, x, x, lse, x, True)
        with pytest.raises(ValueError, match="unsupported device"):
            flash_dq(x, x, x, x, lse, lse, True)
        with pytest.raises(ValueError, match="unsupported device"):
            flash_dkv(x, x, x, x, lse, lse, True)


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


def _split_data(seed, t, h, hkv, b=8, d=16, layers=2):
    """Ragged rows around the split edges: 0, 1, SPLIT_T - 1, SPLIT_T,
    SPLIT_T + 1, a mid-cache row, T_max - 1 and T_max - 2."""
    x = _decode_data(seed, b=b, t=t, h=h, hkv=hkv, d=d, layers=layers)
    x["pos"] = np.array([0, 1, SPLIT_T - 1, SPLIT_T, SPLIT_T + 1, t // 2 + 3,
                         t - 1, t - 2], np.int32)[:b]
    return x


class TestDecodeSplit:
    """The split kernel's recipe (``reference_decode_attention_split``)
    against the JAX decode kernel and the plain version."""

    @pytest.mark.parametrize("t", [1000, 2048])
    @pytest.mark.parametrize("h,hkv", [(8, 2), (4, 4)], ids=["g4", "g1"])
    def test_self_form_matches_jax_kernel(self, t, h, hkv):
        x = _split_data(20, t, h, hkv)
        want = jdec.decode_attention(
            jnp.asarray(x["q"]), jnp.asarray(x["k"]), jnp.asarray(x["v"]),
            jnp.asarray(x["pos"]), 1, k_self=jnp.asarray(x["ks"]),
            v_self=jnp.asarray(x["vs"]), block_t=200 if t == 1000 else 256,
            kernel=True, interpret=True,
        )
        got = reference_decode_attention_split(
            _t(x["q"]), _t(x["k"]), _t(x["v"]), _t(x["pos"]), 1,
            _t(x["ks"]), _t(x["vs"]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=DECODE_TOL, atol=DECODE_TOL)

    @pytest.mark.parametrize("t", [1000, 2048])
    @pytest.mark.parametrize("h,hkv", [(8, 2), (4, 4)], ids=["g4", "g1"])
    def test_cache_only_form_matches_plain(self, t, h, hkv):
        """Without self, attending [0, pos]: pos = T_max - 1 reads the whole
        cache, pos = SPLIT_T - 1 exactly one split."""
        x = _split_data(21, t, h, hkv)
        args = (_t(x["q"]), _t(x["k"]), _t(x["v"]), _t(x["pos"]), 0)
        np.testing.assert_allclose(
            reference_decode_attention_split(*args).numpy(),
            reference_decode_attention(*args).numpy(),
            rtol=DECODE_TOL, atol=DECODE_TOL)

    def test_pos_zero_with_self_is_the_self_token(self):
        """No live cache row: the output is v_self (no split is merged, so
        no exp(-inf - -inf) reaches it)."""
        x = _split_data(22, 600, 8, 2)
        pos = torch.zeros(8, dtype=torch.int32)
        out = reference_decode_attention_split(
            _t(x["q"]), _t(x["k"]), _t(x["v"]), pos, 0, _t(x["ks"]),
            _t(x["vs"]))
        assert torch.isfinite(out).all()
        np.testing.assert_allclose(out.numpy(), np.repeat(x["vs"], 4, axis=1),
                                   atol=DECODE_TOL)

    @pytest.mark.parametrize("t_max", [1, 255, 256, 257, 512, 1000, 1024,
                                       2048, 2049])
    def test_split_plan_covers_every_row_once(self, t_max):
        plan = split_plan(t_max)
        assert len(plan) == -(-t_max // SPLIT_T)
        rows = [r for start, stop in plan for r in range(start, stop)]
        assert rows == list(range(t_max))
        assert all(0 < stop - start <= SPLIT_T for start, stop in plan)


class TestTmaReady:
    """``tma_ready`` passes a tensor TMA can read in place and copies the
    rest."""

    def test_fused_qkv_slices_and_contiguous_pass_uncopied(self):
        qkv = torch.randn(2, 40, 3, 4, 64).to(torch.bfloat16)
        for x in (qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                  qkv[:, :, 1].contiguous(),
                  torch.randn(1, 7, 2, 128).to(torch.bfloat16)):
            assert tma_ready(x).data_ptr() == x.data_ptr()

    @pytest.mark.parametrize("case", ["odd_offset", "odd_s_stride"])
    def test_unaligned_tensors_come_back_contiguous(self, case):
        if case == "odd_offset":
            flat = torch.randn(1 + 2 * 9 * 3 * 64).to(torch.bfloat16)
            x = flat[1:].view(2, 9, 3, 64)  # base 2 bytes past alignment
        else:
            # S stride of 3*64 + 5 elements: no multiple of 8 (16 bytes).
            x = torch.randn(2, 9, 3 * 64 + 5).to(torch.bfloat16)[
                :, :, :3 * 64].view(2, 9, 3, 64)
        y = tma_ready(x)
        assert y.data_ptr() != x.data_ptr() and y.is_contiguous()
        assert torch.equal(y, x)


class TestBuild:
    def test_library_name_hashes_shared_headers(self, tmp_path,
                                                monkeypatch):
        """Every library's name carries the shared headers (``sm90.cuh``
        among them), so editing one rebuilds every kernel."""
        for src in _build.CSRC.iterdir():
            (tmp_path / src.name).write_bytes(src.read_bytes())
        monkeypatch.setattr(_build, "CSRC", tmp_path)
        before = {n: _build.library_path(n) for n in _build.KERNELS}
        with open(tmp_path / "sm90.cuh", "a") as f:
            f.write("\n// edited\n")
        after = {n: _build.library_path(n) for n in _build.KERNELS}
        assert all(before[n] != after[n] for n in _build.KERNELS)

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

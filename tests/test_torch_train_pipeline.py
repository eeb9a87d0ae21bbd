"""The port's pipeline-parallel trainer against the JAX package's, on the CPU.

``build_1f1b_schedule`` and ``theoretical_bubble_fraction`` equal the JAX
functions op for op.  A torch twin of ``tests/test_train_pipeline.py``'s toy
model starts from the JAX toy's initial parameters: the port's
``reference_run`` equals JAX's at 1e-5 (f32), and ``PipelinedTrainer`` on
CPU stages equals the port's ``reference_run`` at 1e-5 with two stages,
interleaved, one microbatch, fewer microbatches than stages, DP within a
stage over a ``LocalGroup`` of CPU ranks, and within the JAX test's bound
with the q8 gradient exchange.  Stage death restarts from the synchronized
checkpoint, exhausted failures surface, and a slow stage keeps every
stage's op order.  GPT-2 tiny (f32, dense and flash on the plain path)
takes JAX's chunk parameters through ``stage_params_from_jax``: two steps
of the port's ``reference_run`` equal JAX's losses at 1e-4 and its final
parameters at ``GPT2_PARAM_ATOL``, and two pipelined stages equal the
sequential run at 1e-5.  The port's per-chunk init equals slices of its
``gpt2_init`` bit for bit.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu.train.pipeline as jpipe
import ray_tpu_torch
from ray_tpu.models.gpt2 import GPT2Config as JGPT2Config
from ray_tpu_torch.convert import stage_params_from_jax
from ray_tpu_torch.models.gpt2 import GPT2Config, gpt2_init
from ray_tpu_torch.train import PipelineConfig, PipelinedTrainer, RunConfig
from ray_tpu_torch.train.config import FailureConfig
from ray_tpu_torch.train.pipeline import (
    PipeOp,
    StageModule,
    build_1f1b_schedule,
    gpt2_stage_modules,
    reference_run,
    theoretical_bubble_fraction,
)

LR = 1e-2
# Adam's first step divides each gradient by its own magnitude, so leaves
# whose gradients sit near eps move by amounts that differ between the two
# packages' summation orders; the final GPT-2 tiny parameters are held at
# this absolute bound (the largest gap reads ~1.1e-5 on the CPU).
GPT2_PARAM_ATOL = 5e-5


@pytest.fixture(scope="module")
def cluster():
    ctx = ray_tpu_torch.init(num_cpus=8, resources={"GPU": 2})
    yield ctx
    ray_tpu_torch.shutdown()


# ------------------------------------------------------------- 1F1B schedule
GRID = [(1, 1, 1), (2, 4, 1), (3, 6, 1), (4, 2, 1), (3, 1, 1), (2, 4, 2),
        (2, 6, 3), (3, 6, 2), (4, 16, 1), (3, 5, 1)]


@pytest.mark.parametrize("S,M,V", GRID)
def test_schedule_equals_jax(S, M, V):
    got = build_1f1b_schedule(S, M, V)
    want = jpipe.build_1f1b_schedule(S, M, V)
    assert [[(o.kind, o.chunk, o.microbatch) for o in ops] for ops in got] \
        == [[(o.kind, o.chunk, o.microbatch) for o in ops] for ops in want]
    assert theoretical_bubble_fraction(S, M, V) \
        == jpipe.theoretical_bubble_fraction(S, M, V)


def test_schedule_refuses_what_jax_refuses():
    for mod in (jpipe, None):
        build = mod.build_1f1b_schedule if mod else build_1f1b_schedule
        with pytest.raises(ValueError):
            build(2, 3, interleave=2)
        with pytest.raises(ValueError):
            build(0, 1)


# ----------------------------------------------------------------- toy model
def make_jax_toy_builder():
    """``tests/test_train_pipeline.py``'s toy model."""

    def toy_builder(v, total):
        d = 8
        if v < total - 1:
            def init(rng):
                return {"w": jax.random.normal(
                    jax.random.fold_in(rng, v), (d, d)) * 0.3}

            def apply(p, x):
                return jnp.tanh(x @ p["w"])

            return jpipe.StageModule(init=init, apply=apply)

        def init(rng):
            return {"w": jax.random.normal(
                jax.random.fold_in(rng, v), (d, 1)) * 0.3}

        def apply(p, x, targets):
            return jnp.mean((x @ p["w"] - targets) ** 2)

        return jpipe.StageModule(init=init, apply=apply, is_loss_stage=True)

    return toy_builder


def jax_toy_params(total):
    """Each toy chunk's initial parameters as the JAX trainer draws them
    (``rng_seed`` 0), as numpy."""
    build = make_jax_toy_builder()
    return [{k: np.asarray(a) for k, a in
             build(v, total).init(jax.random.PRNGKey(0)).items()}
            for v in range(total)]


def make_toy_builder(params, delay_s=0.0):
    """The toy model on torch, starting from ``params`` (numpy, by chunk).
    The closure pickles by value, so stage workers never import this
    module.  ``delay_s`` slows the loss chunk (latency skew)."""

    def toy_builder(v, total):
        import time as _t

        import torch as _torch

        w0 = params[v]["w"]

        def init(gen):
            return {"w": _torch.from_numpy(w0.copy()).to(gen.device)}

        if v < total - 1:
            def apply(p, x):
                return _torch.tanh(x @ p["w"])

            return StageModule(init=init, apply=apply)

        def apply(p, x, targets):
            if delay_s:
                _t.sleep(delay_s)
            return _torch.mean((x @ p["w"] - targets) ** 2)

        return StageModule(init=init, apply=apply, is_loss_stage=True)

    return toy_builder


def toy_data(step):
    rng = np.random.RandomState(100 + step)
    return (
        rng.randn(8, 8).astype(np.float32),
        rng.randn(8, 1).astype(np.float32),
    )


def _losses(result):
    return [m["loss"] for m in result.metrics_history]


def _port_ref(total, steps, M):
    return reference_run(make_toy_builder(jax_toy_params(total)), total,
                         toy_data, steps, num_microbatches=M,
                         learning_rate=LR, device="cpu")


def _fit(total, steps=3, builder=None, run_config=None, **cfg_kw):
    defaults = dict(recv_timeout_s=30.0)
    defaults.update(cfg_kw)
    tr = PipelinedTrainer(
        builder or make_toy_builder(jax_toy_params(total)),
        pipeline_config=PipelineConfig(**defaults),
        data_per_step=toy_data,
        num_steps=steps,
        learning_rate=LR,
        run_config=run_config,
    )
    try:
        res = tr.fit()
        states = tr.get_stage_states()
    finally:
        tr.shutdown()
    return res, states


def _assert_params_equal(states, ref_states):
    for i, ref_chunk in enumerate(ref_states):
        for k, v in ref_chunk["params"].items():
            np.testing.assert_allclose(
                states[i][0]["params"][k], v, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("total,steps,M", [(2, 3, 4), (4, 2, 4), (2, 2, 1),
                                           (3, 2, 1)])
def test_toy_reference_run_equals_jax(total, steps, M):
    want, want_states = jpipe.reference_run(
        make_jax_toy_builder(), total, toy_data, steps, num_microbatches=M,
        learning_rate=LR)
    got, got_states = _port_ref(total, steps, M)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for g, w in zip(got_states, want_states):
        np.testing.assert_allclose(g["params"]["w"], w["params"]["w"],
                                   rtol=1e-5, atol=1e-6)
    assert len(got.step_walls) == steps


def test_two_stage_matches_reference(cluster):
    ref, ref_states = _port_ref(2, 3, 4)
    res, states = _fit(2, num_stages=2, num_microbatches=4)
    assert res.error is None
    np.testing.assert_allclose(ref, _losses(res), rtol=1e-5)
    _assert_params_equal(states, ref_states)
    assert 0.0 <= res.metrics["bubble_fraction"] <= 1.0


def test_interleaved_matches_reference(cluster):
    ref, _ = _port_ref(4, 2, 4)
    res, _ = _fit(4, steps=2, num_stages=2, num_microbatches=4,
                  interleave=2)
    assert res.error is None
    np.testing.assert_allclose(ref, _losses(res), rtol=1e-5)


def test_single_microbatch(cluster):
    ref, _ = _port_ref(2, 2, 1)
    res, _ = _fit(2, steps=2, num_stages=2, num_microbatches=1)
    assert res.error is None
    np.testing.assert_allclose(ref, _losses(res), rtol=1e-5)


def test_fewer_microbatches_than_stages(cluster):
    ref, _ = _port_ref(3, 2, 1)
    res, _ = _fit(3, steps=2, num_stages=3, num_microbatches=1)
    assert res.error is None
    np.testing.assert_allclose(ref, _losses(res), rtol=1e-5)


def test_quantized_grad_exchange_tracks_reference(cluster):
    """The JAX test's bound: step 0 exact (activations stay exact), later
    steps within the quantization error envelope."""
    ref, _ = _port_ref(2, 3, 4)
    res, _ = _fit(2, num_stages=2, num_microbatches=4,
                  quantized_grad_exchange=True)
    assert res.error is None
    got = _losses(res)
    assert len(got) == len(ref)
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-6)
    np.testing.assert_allclose(got, ref, rtol=0.05)


def test_dp_within_stage(cluster):
    """Each microbatch split over two CPU ranks of a LocalGroup, their
    gradients summed by its allreduce: the math of one rank."""
    ref, ref_states = _port_ref(2, 2, 2)
    res, states = _fit(2, steps=2, num_stages=2, num_microbatches=2,
                       dp_devices_per_stage=2)
    assert res.error is None
    np.testing.assert_allclose(ref, _losses(res), rtol=1e-5)
    _assert_params_equal(states, ref_states)


def test_batch_not_divisible_raises(cluster):
    tr = PipelinedTrainer(
        make_toy_builder(jax_toy_params(1)),
        pipeline_config=PipelineConfig(
            num_stages=1, num_microbatches=3, recv_timeout_s=10.0),
        data_per_step=toy_data,  # batch of 8, not divisible by 3
        num_steps=1,
        learning_rate=LR,
    )
    try:
        with pytest.raises(ValueError, match="divisible"):
            tr.fit()
    finally:
        tr.shutdown()


def test_gpu_stage_without_a_card_raises(cluster):
    """A stage that leased a card and sees no CUDA device fails its build;
    it never trains on the CPU instead."""
    tr = PipelinedTrainer(
        make_toy_builder(jax_toy_params(2)),
        pipeline_config=PipelineConfig(num_stages=2, num_microbatches=2,
                                       recv_timeout_s=10.0),
        data_per_step=toy_data,
        num_steps=1,
        learning_rate=LR,
        resources_per_stage={"CPU": 1.0, "GPU": 0.5},
    )
    try:
        with pytest.raises(Exception, match="sees no CUDA device"):
            tr.fit()
        assert tr._pg.bundles == [{"CPU": 1.0, "GPU": 0.5}] * 2
    finally:
        tr.shutdown()


def test_op_order_and_inflight_bound_with_slow_stage(cluster):
    """A slow loss stage must not reorder any stage's 1F1B op stream or
    grow its in-flight window: stalls move to the recv edges."""
    S, M = 2, 4
    tr = PipelinedTrainer(
        make_toy_builder(jax_toy_params(2), delay_s=0.15),
        pipeline_config=PipelineConfig(num_stages=S, num_microbatches=M,
                                       recv_timeout_s=30.0),
        data_per_step=toy_data,
        num_steps=1,
        learning_rate=LR,
    )
    try:
        inputs, targets = tr._microbatches(0)
        tr._create_stages()
        tr._save_checkpoint(0)
        refs = [tr.stages[0].run_step.remote(0, inputs=inputs),
                tr.stages[1].run_step.remote(0, targets=targets)]
        stats = ray_tpu_torch.get(refs, timeout=120)
    finally:
        tr.shutdown()
    expected = build_1f1b_schedule(S, M)
    for s, st in enumerate(stats):
        assert [PipeOp(k, c, m) for (k, c, m) in st["op_trace"]] \
            == expected[s]
        assert st["stash_hwm"] <= S - s
    assert stats[0]["stall_s"] > 0.1


def test_stage_death_restarts_from_synchronized_checkpoint(cluster,
                                                           tmp_path):
    marker = str(tmp_path / "died_once")
    storage = str(tmp_path / "runs")
    ref, ref_states = _port_ref(2, 4, 2)
    res, states = _fit(
        2, steps=4, num_stages=2, num_microbatches=2, recv_timeout_s=10.0,
        checkpoint_every_n_steps=1,
        debug_fail={"stage": 1, "step": 2, "marker": marker},
        run_config=RunConfig(name="recov", storage_path=storage,
                             failure_config=FailureConfig(max_failures=2)))
    assert res.error is None
    assert os.path.exists(marker)
    assert res.metrics["restarts"] == 1
    np.testing.assert_allclose(ref, _losses(res)[-4:], rtol=1e-5)
    _assert_params_equal(states, ref_states)
    assert any(d.startswith("pipeline_ckpt_")
               for d in os.listdir(os.path.join(storage, "recov")))


def test_exhausted_failures_surface_error(cluster):
    tr = PipelinedTrainer(
        make_toy_builder(jax_toy_params(2)),
        pipeline_config=PipelineConfig(
            num_stages=2, num_microbatches=2, recv_timeout_s=5.0,
            step_timeout_s=30.0,
            debug_fail={"stage": 0, "step": 0, "marker": ""}),
        data_per_step=toy_data,
        num_steps=2,
        learning_rate=LR,
        run_config=RunConfig(failure_config=FailureConfig(max_failures=1)),
    )
    try:
        res = tr.fit()
    finally:
        tr.shutdown()
    assert res.error is not None


# ---------------------------------------------------------------- GPT-2 tiny
def _gpt2_data(vocab):
    def data(step):
        rng = np.random.RandomState(step)
        toks = rng.randint(0, vocab, (4, 17)).astype(np.int32)
        return toks[:, :-1], toks[:, 1:]

    return data


def carried_builder(cfg, total, jax_params):
    """The port's ``gpt2_stage_modules`` with each chunk's initial
    parameters carried from JAX's (numpy, by chunk)."""
    base = gpt2_stage_modules(cfg, total)

    def builder(v, total_):
        from ray_tpu_torch.convert import stage_params_from_jax as carry

        mod = base(v, total_)
        tree = jax_params[v]
        return dataclasses.replace(
            mod, init=lambda gen: carry(tree, cfg, v, total_, gen.device))

    return builder


def _jax_chunk_params(jcfg, total):
    build = jpipe.gpt2_stage_modules(jcfg, total)
    return [jax.tree.map(np.asarray,
                         build(v, total).init(jax.random.PRNGKey(0)))
            for v in range(total)]


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_gpt2_tiny_reference_run_equals_jax(attention):
    jcfg = JGPT2Config.tiny(dtype="float32", attention=attention)
    cfg = GPT2Config.tiny(dtype="float32", attention=attention)
    data = _gpt2_data(cfg.vocab_size)
    jparams = _jax_chunk_params(jcfg, 2)
    want, want_states = jpipe.reference_run(
        jpipe.gpt2_stage_modules(jcfg, 2), 2, data, 2, num_microbatches=2,
        learning_rate=1e-3)
    got, got_states = reference_run(
        carried_builder(cfg, 2, jparams), 2, data, 2, num_microbatches=2,
        learning_rate=1e-3, device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-4)
    for g, w in zip(got_states, want_states):
        flat_w = jax.tree_util.tree_flatten_with_path(w["params"])[0]
        for path, leaf in flat_w:
            node = g["params"]
            for key in path:
                node = node[key.key]
            np.testing.assert_allclose(node.numpy(), np.asarray(leaf),
                                       atol=GPT2_PARAM_ATOL,
                                       err_msg=str(path))


def test_stage_params_from_jax_checks_shapes():
    jcfg = JGPT2Config.tiny(dtype="float32")
    cfg = GPT2Config.tiny(dtype="float32")
    p0, p1 = _jax_chunk_params(jcfg, 2)
    t0 = stage_params_from_jax(p0, cfg, 0, 2, device="cpu")
    t1 = stage_params_from_jax(p1, cfg, 1, 2, device="cpu")
    assert sorted(t0) == ["blocks", "wpe", "wte"]
    assert sorted(t1) == ["blocks", "lnf_b", "lnf_g", "unembed"]
    np.testing.assert_array_equal(t1["blocks"]["wqkv"].numpy(),
                                  p1["blocks"]["wqkv"])
    with pytest.raises(ValueError):
        stage_params_from_jax(p0, cfg, 1, 2, device="cpu")  # chunk 0's tree
    with pytest.raises(ValueError):
        stage_params_from_jax(p1, cfg, 0, 1, device="cpu")  # whole model


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_two_stage_gpt2_matches_reference(cluster, attention):
    cfg = GPT2Config.tiny(dtype="float32", attention=attention)
    jparams = _jax_chunk_params(
        JGPT2Config.tiny(dtype="float32", attention=attention), 2)
    builder = carried_builder(cfg, 2, jparams)
    data = _gpt2_data(cfg.vocab_size)
    ref, _ = reference_run(builder, 2, data, 2, num_microbatches=2,
                           learning_rate=1e-3, device="cpu")
    tr = PipelinedTrainer(
        builder,
        pipeline_config=PipelineConfig(num_stages=2, num_microbatches=2,
                                       recv_timeout_s=60.0),
        data_per_step=data,
        num_steps=2,
        learning_rate=1e-3,
    )
    try:
        res = tr.fit()
    finally:
        tr.shutdown()
    assert res.error is None
    pipe = _losses(res)
    assert all(np.isfinite(pipe))
    np.testing.assert_allclose(pipe, ref, rtol=1e-5)


def test_gpt2_split_validates():
    with pytest.raises(ValueError):
        gpt2_stage_modules(GPT2Config.tiny(), 3)  # 2 layers, 3 chunks


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpt2_chunk_init_matches_full_init_slices(dtype):
    """The per-chunk init draws gpt2_init's sequence and keeps its slice:
    bit for bit what slicing the port's whole-model init gives."""
    cfg = GPT2Config.tiny(dtype=dtype)
    full = gpt2_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    builder = gpt2_stage_modules(cfg, 2, seed=0)
    p0 = builder(0, 2).init(torch.Generator().manual_seed(99))
    p1 = builder(1, 2).init(torch.Generator().manual_seed(99))
    assert torch.equal(p0["wte"], full["wte"])
    assert torch.equal(p0["wpe"], full["wpe"])
    assert torch.equal(p1["unembed"], full["wte"])
    assert torch.equal(p1["lnf_g"], full["lnf_g"])
    mid = cfg.n_layer // 2
    for name, t in full.blocks.items():
        assert torch.equal(p0["blocks"][name], t[:mid]), name
        assert torch.equal(p1["blocks"][name], t[mid:]), name
    assert p0["blocks"]["wqkv"].dtype == torch.__dict__[dtype]


@pytest.mark.parametrize("shape", [(3, 1000), (7,), (2, 128)])
def test_q8_wire_format_equals_jax(shape):
    """The B-edge quantization rounds as the JAX stage's numpy twins do:
    the same int8 codes and scales, and the same dequantized gradient."""
    from ray_tpu_torch.train.pipeline import (
        _dequantize_grad_tree,
        _quantize_grad_tree,
    )

    g = np.random.default_rng(7).standard_normal(shape).astype(np.float32)
    g[..., 0] = 0.0
    want = jpipe._quantize_grad_tree({"g": g, "n": 3}, 256)
    got = _quantize_grad_tree({"g": torch.from_numpy(g), "n": 3}, 256)
    assert got["n"] == 3
    np.testing.assert_array_equal(got["g"].q.numpy(), want["g"].q)
    np.testing.assert_array_equal(got["g"].scales.numpy(), want["g"].scales)
    back = _dequantize_grad_tree(got)["g"]
    assert back.dtype == torch.float32 and tuple(back.shape) == shape
    np.testing.assert_array_equal(
        back.numpy(), jpipe._dequantize_grad_tree(want)["g"])

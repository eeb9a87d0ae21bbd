"""The port's Train layer against the JAX package's, on the CPU.

The programs of ``tests/test_train.py``, ``test_train_ingest_p2p.py`` and
``test_storage_context.py`` run through ``ray_tpu.train`` in a JAX cluster,
which then shuts down, and through ``ray_tpu_torch.train`` in a port
cluster; their outputs must be equal.  Where the JAX program runs a
``JaxTrainer``, the port runs its counterpart, a ``TorchTrainer`` (gloo:
no worker leases a whole card here).  The programs cover single- and
multi-worker fits, checkpoints and ``num_to_keep``, recovery from a
checkpoint after a worker dies, dataset shards and a missing shard,
collective p2p between actors, and the ``memory://`` storage.

Port-only: the GPU leases of ``ScalingConfig(use_gpu=...)`` and the
backend ``TorchBackend`` picks from them (in a cluster that declares two
GPUs; no card is present, so asking for NCCL must fail, never turn into
gloo); ``torch_ckpt`` round trips (bf16 bit for bit, async, an optimizer's
state, ``device=``); and data-parallel parity: a tiny f32 GPT-2 (the JAX
``gpt2_init`` weights carried across by ``params_from_jax``) takes one SGD
step in a world-2 ``TorchTrainer``, each rank on its half of the batch,
gradients MEAN-allreduced through ``ray_tpu_torch.collective``, against one
SGD step of ``jax.value_and_grad`` over the whole batch, at rtol 1e-4 /
atol 1e-5 (the tolerance of tests/test_torch_train.py).

Every loop is defined inside its program: a function at this module's top
level travels by reference, and the workers cannot import this module.
The trainer part of ``test_elastic.py`` runs through the port in
``test_torch_trainer_elastic.py``.
"""

import os
import tempfile
import jax
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu.train as jtrain
import ray_tpu_torch
import ray_tpu_torch.train as ttrain

TIMEOUT = 60


# ------------------------------------------------------------ the programs
def prog_single_worker_fit(rt, train, pkg):
    def loop(config):
        import importlib

        train = importlib.import_module(config["pkg"] + ".train")
        for step in range(3):
            train.report({"step": step, "loss": 1.0 / (step + 1)})

    result = train.DataParallelTrainer(
        loop, train_loop_config={"pkg": pkg},
        scaling_config=train.ScalingConfig(num_workers=1)).fit()
    return [result.error is None, result.metrics["step"],
            len(result.metrics_history)]


def prog_multi_worker_fit_and_checkpoint(rt, train, pkg):
    def loop(config):
        import importlib
        import os
        import tempfile

        train = importlib.import_module(config["pkg"] + ".train")
        ctx = train.get_context()
        assert ctx.world_size == 2
        for step in range(2):
            ckpt = None
            if ctx.world_rank == 0:
                d = tempfile.mkdtemp()
                with open(os.path.join(d, "state.txt"), "w") as f:
                    f.write(f"step={step}")
                ckpt = train.Checkpoint.from_directory(d)
            train.report({"step": step, "rank": ctx.world_rank},
                         checkpoint=ckpt)

    result = train.DataParallelTrainer(
        loop, train_loop_config={"pkg": pkg},
        scaling_config=train.ScalingConfig(num_workers=2),
        run_config=train.RunConfig(name="t2",
                                   storage_path=tempfile.mkdtemp())).fit()
    with open(os.path.join(result.checkpoint.path, "state.txt")) as f:
        return [result.error is None, f.read(), result.metrics["rank"]]


def prog_num_to_keep(rt, train, pkg):
    def loop(config):
        import importlib

        train = importlib.import_module(config["pkg"] + ".train")
        for step in range(5):
            train.report({"step": step},
                         checkpoint=train.Checkpoint.from_dict({"s": step}))

    result = train.DataParallelTrainer(
        loop, train_loop_config={"pkg": pkg},
        scaling_config=train.ScalingConfig(num_workers=1),
        run_config=train.RunConfig(
            name="keep", storage_path=tempfile.mkdtemp(),
            checkpoint_config=train.CheckpointConfig(num_to_keep=2))).fit()
    kept = sorted(d for d in os.listdir(result.path)
                  if d.startswith("checkpoint_"))
    return [result.error is None, len(kept), result.checkpoint.to_dict()]


def prog_failure_recovery_from_checkpoint(rt, train, pkg):
    def loop(config):
        import importlib
        import os
        import tempfile

        train = importlib.import_module(config["pkg"] + ".train")
        start = 0
        if train.get_checkpoint() is not None:
            with open(os.path.join(train.get_checkpoint().path,
                                   "s.txt")) as f:
                start = int(f.read()) + 1
        for step in range(start, 4):
            d = tempfile.mkdtemp()
            with open(os.path.join(d, "s.txt"), "w") as f:
                f.write(str(step))
            train.report({"step": step, "start": start},
                         checkpoint=train.Checkpoint.from_directory(d))
            if step == 1 and start == 0:
                os._exit(1)  # crash mid-training on the first attempt

    result = train.DataParallelTrainer(
        loop, train_loop_config={"pkg": pkg},
        scaling_config=train.ScalingConfig(num_workers=1),
        run_config=train.RunConfig(
            name="recover", storage_path=tempfile.mkdtemp(),
            failure_config=train.FailureConfig(max_failures=1))).fit()
    return [result.error is None, result.metrics["step"],
            result.metrics["start"]]


def _dp_trainer(train, pkg):
    """The package's trainer that starts its framework's runtime."""
    return train.JaxTrainer if pkg == "ray_tpu" else train.TorchTrainer


def prog_dataset_shards(rt, train, pkg):
    import importlib

    data = importlib.import_module(pkg + ".data")
    ds = data.range_dataset(64, parallelism=8).map(lambda x: x * 2)

    def loop(config):
        import importlib

        train = importlib.import_module(config["pkg"] + ".train")
        shard = train.get_dataset_shard("train")
        train.report({"total": sum(shard.iter_rows()),
                      "count": shard.count(),
                      "rank": train.get_context().world_rank})

    result = _dp_trainer(train, pkg)(
        loop, train_loop_config={"pkg": pkg},
        scaling_config=train.ScalingConfig(num_workers=2),
        datasets={"train": ds}).fit()
    return [result.error is None, result.metrics["count"],
            result.metrics["total"], result.metrics["rank"]]


def prog_missing_shard(rt, train, pkg):
    def loop(config):
        import importlib

        train = importlib.import_module(config["pkg"] + ".train")
        train.get_dataset_shard("nope")

    result = _dp_trainer(train, pkg)(
        loop, train_loop_config={"pkg": pkg},
        scaling_config=train.ScalingConfig(num_workers=1)).fit()
    return [result.error is not None, "nope" in str(result.error)]


def prog_collective_p2p_send_recv(rt, train, pkg):
    @rt.remote(max_concurrency=2)
    class Member:
        def __init__(self, rank, pkg):
            import importlib

            self.col = importlib.import_module(pkg + ".collective")
            self.rank = rank
            # The JAX local group spans this process's devices; the
            # port's takes one rank per actor on the CPU.
            kw = {} if pkg == "ray_tpu" else {"devices": ["cpu", "cpu"]}
            self.col.init_collective_group(
                world_size=2, rank=rank, backend="local",
                group_name="pair", **kw)

        def exchange(self):
            import numpy as np

            col = self.col
            if self.rank == 0:
                col.send(np.arange(8), dst_rank=1, group_name="pair")
                back = col.recv(src_rank=1, group_name="pair")
                return back.tolist()
            got = col.recv(src_rank=0, group_name="pair")
            col.send(got * 10, dst_rank=0, group_name="pair")
            return got.tolist()

    a, b = Member.remote(0, pkg), Member.remote(1, pkg)
    ra, rb = a.exchange.remote(), b.exchange.remote()
    out = [rt.get(rb, timeout=TIMEOUT), rt.get(ra, timeout=TIMEOUT)]
    for m in (a, b):
        rt.kill(m)
    return out


def prog_storage_kv_roundtrip(rt, train, pkg):
    import importlib

    storage_mod = importlib.import_module(pkg + ".train.storage")
    src = tempfile.mkdtemp()
    os.makedirs(os.path.join(src, "sub"))
    with open(os.path.join(src, "data.json"), "w") as f:
        f.write('{"a": 1}')
    with open(os.path.join(src, "sub", "weights.bin"), "wb") as f:
        f.write(b"\x00\x01\x02")
    storage = storage_mod.get_storage("memory://bucket/run1")
    uri = storage.upload_dir(src, "checkpoint_001")
    listed = storage.list_checkpoints()
    local = storage.download_dir(uri)
    with open(os.path.join(local, "data.json")) as f:
        data = f.read()
    with open(os.path.join(local, "sub", "weights.bin"), "rb") as f:
        weights = list(f.read())
    storage.delete(uri)
    return [uri, listed, data, weights, storage.list_checkpoints(),
            type(storage_mod.get_storage("/tmp/x")).__name__,
            type(storage_mod.get_storage("file:///tmp/x")).__name__]


def prog_checkpoint_manager_remote(rt, train, pkg):
    import importlib

    ck = importlib.import_module(pkg + ".train.checkpoint")
    mgr = ck.CheckpointManager("memory://bucket", "exp", num_to_keep=2)
    for i in range(3):
        ck.commit_to_storage(ck.Checkpoint.from_dict({"step": i}),
                             mgr.run_dir)
    latest = mgr.latest().to_dict()
    mgr.prune()
    return [latest, len(mgr._storage.list_checkpoints()),
            mgr.latest().to_dict()]


def prog_trainer_restores_from_remote_after_failure(rt, train, pkg):
    def loop(config=None):
        import importlib
        import os

        train = importlib.import_module(config["pkg"] + ".train")
        ctx = train.session.get_context()
        start = 0
        ck = ctx.latest_checkpoint
        if ck is not None:
            start = ck.to_dict()["step"] + 1
        for step in range(start, 4):
            train.session.report(
                {"step": step},
                checkpoint=train.Checkpoint.from_dict({"step": step}))
            if step == 1 and ck is None:
                os._exit(1)  # die after committing step 1

    result = train.DataParallelTrainer(
        loop, train_loop_config={"pkg": pkg},
        scaling_config=train.ScalingConfig(num_workers=1),
        run_config=train.RunConfig(
            name="remote-ft", storage_path="memory://bucket2",
            failure_config=train.FailureConfig(max_failures=2))).fit()
    return [result.metrics["step"], result.checkpoint is not None,
            result.checkpoint.path.startswith("memory://bucket2")]


PROGRAMS = {name[len("prog_"):]: fn for name, fn in dict(globals()).items()
            if name.startswith("prog_")}


def _run_all(rt, train, pkg, tries=1):
    """Each program's result, or what it raised.  ``tries`` > 1 runs a
    program that raised again, up to that many runs in all."""
    out = {}
    for name, prog in PROGRAMS.items():
        for _ in range(tries):
            try:
                out[name] = prog(rt, train, pkg)
                break
            except Exception as e:  # noqa: BLE001 — compared per program
                out[name] = f"raised {type(e).__name__}: {e}"
    return out


@pytest.fixture(scope="module")
def jax_results():
    """The reference results.  On a loaded host the JAX runtime can lose a
    fresh worker's first call ("connect call failed ... after 3 attempts")
    and fail a fit through no fault of the program, which left
    failure_recovery_from_checkpoint with no reference at all; so a JAX
    program that raised runs again, up to 3 times in all, until it gives
    a result.  The port's side runs once."""
    ray_tpu.init(num_cpus=8)
    try:
        return _run_all(ray_tpu, jtrain, "ray_tpu", tries=3)
    finally:
        ray_tpu.shutdown()


@pytest.fixture(scope="module")
def port(jax_results):
    """The port's cluster, started only once the JAX one is down; it
    declares two GPUs (no card is present)."""
    ray_tpu_torch.init(num_cpus=8, resources={"GPU": 2})
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


@pytest.fixture(scope="module")
def port_results(port):
    return _run_all(port, ttrain, "ray_tpu_torch")


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_same_results_as_the_jax_package(name, jax_results, port_results):
    got, want = port_results[name], jax_results[name]
    assert not (isinstance(want, str) and want.startswith("raised")), want
    assert got == want, (got, want)


# ---------------------------------------------------- GPU leases, backend
def test_scaling_config_leases_gpus():
    sc = ttrain.ScalingConfig
    assert sc().worker_resources() == {"CPU": 1.0}
    assert sc(use_gpu=True).worker_resources() == {"CPU": 1.0, "GPU": 1.0}
    assert sc(use_gpu=True, gpus_per_worker=0.5).worker_resources() == {
        "CPU": 1.0, "GPU": 0.5}
    assert sc(gpus_per_worker=2).worker_resources() == {"CPU": 1.0}
    assert sc(resources_per_worker={"CPU": 2, "GPU": 1}
              ).worker_resources() == {"CPU": 2, "GPU": 1}


def test_half_card_workers_run_gloo_on_their_lease(port):
    def loop(config):
        import os

        import torch.distributed as dist

        import ray_tpu_torch.train as train

        ctx = train.get_context()
        t = __import__("torch").ones(2) * (ctx.world_rank + 1)
        dist.all_reduce(t)
        train.report({"backend": ctx.backend,
                      "cuda": os.environ.get("CUDA_VISIBLE_DEVICES"),
                      "sum": t.tolist()})

    result = ttrain.TorchTrainer(
        loop, train_loop_config={},
        scaling_config=ttrain.ScalingConfig(
            num_workers=2, use_gpu=True, gpus_per_worker=0.5)).fit()
    assert result.error is None, result.error
    assert result.metrics["backend"] == "gloo"
    assert result.metrics["torch_backend"] == "gloo"
    assert result.metrics["cuda"] in ("0", "1")
    assert result.metrics["sum"] == [3.0, 3.0]


def test_whole_card_workers_ask_for_nccl_and_never_fall_back(port):
    """A worker leasing a whole card gets NCCL; with no card present its
    ``init_process_group`` fails, and the fit fails with it."""

    def loop(config):
        pass

    trainer = ttrain.TorchTrainer(
        loop, train_loop_config={},
        scaling_config=ttrain.ScalingConfig(num_workers=1, use_gpu=True))
    result = trainer.fit()
    assert trainer.backend.chosen == "nccl"
    assert result.error is not None
    assert "torch_backend" not in result.metrics
    # Asked for by name, gloo is taken as asked on a whole card too.
    asked = ttrain.TorchTrainer(
        loop, train_loop_config={},
        scaling_config=ttrain.ScalingConfig(num_workers=1, use_gpu=True),
        backend=ttrain.TorchBackend("gloo"))
    result = asked.fit()
    assert result.error is None, result.error
    assert result.metrics == {"torch_backend": "gloo"}


# ------------------------------------------------------------ torch_ckpt
def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def test_torch_ckpt_roundtrip_bf16_async_and_device(tmp_path):
    from ray_tpu_torch.train.torch_ckpt import (
        async_save_sharded, restore_sharded, save_sharded,
    )

    gen = torch.Generator().manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(6, 5), torch.nn.GELU(),
                                torch.nn.Linear(5, 3)).to(torch.bfloat16)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
    model(torch.randn(4, 6, generator=gen).to(torch.bfloat16)).sum(
    ).backward()
    opt.step()
    tree = {"model": model.state_dict(), "opt": opt.state_dict(),
            "extra": {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
                      "steps": [torch.tensor(7), torch.zeros(0)]}}
    save_sharded(tree, str(tmp_path / "sync"))
    back = restore_sharded(tree, str(tmp_path / "sync"))
    for k, v in model.state_dict().items():
        assert back["model"][k].dtype == torch.bfloat16
        assert torch.equal(_bits(back["model"][k]), _bits(v)), k
    assert torch.equal(back["extra"]["w"], tree["extra"]["w"])
    assert back["extra"]["steps"][0].item() == 7
    assert back["extra"]["steps"][1].shape == (0,)
    opt2 = torch.optim.AdamW(model.parameters(), lr=1e-3)
    opt2.load_state_dict(back["opt"])
    assert opt2.state_dict()["param_groups"][0]["lr"] == 1e-3

    handle = async_save_sharded(tree, str(tmp_path / "async"))
    # The copy to the host is done: the tensors may change at once.
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1)
    handle.wait(timeout=30)
    assert handle.host_copy_s >= 0 and handle.write_s >= 0
    back2 = restore_sharded(tree, str(tmp_path / "async"), device="cpu")
    for k, v in back["model"].items():
        assert torch.equal(_bits(back2["model"][k]), _bits(v)), k


def test_torch_ckpt_matches_jax_ckpt_leaf_names(tmp_path):
    """The same tree saves under the same leaf names in both packages."""
    import jax.numpy as jnp

    from ray_tpu.train.jax_ckpt import save_sharded as jax_save
    from ray_tpu_torch.train.torch_ckpt import save_sharded

    jtree = {"w": jnp.ones((2, 3)), "b": {"x": jnp.zeros(4)},
             "l": [jnp.ones(1), jnp.ones(2)]}
    ttree = {"w": torch.ones(2, 3), "b": {"x": torch.zeros(4)},
             "l": [torch.ones(1), torch.ones(2)]}
    jax_save(jtree, str(tmp_path / "j"))
    save_sharded(ttree, str(tmp_path / "t"))
    jnames = {f[:-4] for f in os.listdir(tmp_path / "j")
              if f.endswith(".npy")}
    tnames = {f[:-4] for f in os.listdir(tmp_path / "t")
              if f.endswith(".bin")}
    assert jnames == tnames == {"w", "b_x", "l_0", "l_1"}


# ------------------------------------------------ data-parallel parity
def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def test_data_parallel_step_matches_jax_full_batch(port):
    import ray_tpu.models as jm

    lr = 0.5
    jcfg = jm.GPT2Config.tiny(dtype="float32", attention="flash")
    jparams = jax.tree.map(np.asarray,
                           jm.gpt2_init(jax.random.PRNGKey(0), jcfg))
    tokens = np.random.default_rng(1).integers(0, 512, (4, 17))
    loss, grads = jax.value_and_grad(jm.gpt2_loss)(jparams, tokens, jcfg)
    want = {k: np.asarray(v) - lr * np.asarray(_flat(grads)[k])
            for k, v in _flat(jparams).items()}

    def loop(config):
        import torch

        import ray_tpu_torch.train as train
        from ray_tpu_torch import collective as col
        from ray_tpu_torch.collective.types import ReduceOp
        from ray_tpu_torch.convert import params_from_jax
        from ray_tpu_torch.models import GPT2Config, gpt2_loss

        ctx = train.get_context()
        rank, world = ctx.world_rank, ctx.world_size
        col.init_collective_group(world, rank, backend="gloo",
                                  group_name="dp")
        cfg = GPT2Config.tiny(dtype="float32", attention="flash")
        params = params_from_jax(config["params"], cfg, device="cpu")
        params.requires_grad_(True)
        tokens = torch.from_numpy(config["tokens"])
        half = tokens.shape[0] // world
        loss = gpt2_loss(params, tokens[rank * half:(rank + 1) * half], cfg)
        loss.backward()
        with torch.no_grad():
            for p in params.parameters():
                g = col.allreduce(p.grad, "dp", op=ReduceOp.MEAN)
                p -= config["lr"] * g
        flat = torch.cat([p.detach().reshape(-1)
                          for p in params.parameters()])
        every = col.allgather(flat, "dp")
        col.destroy_collective_group("dp")
        train.report({
            "params": {n: p.detach().numpy()
                       for n, p in params.named_parameters()},
            "ranks_equal": all(torch.equal(every[0], e) for e in every)})

    result = ttrain.TorchTrainer(
        loop, train_loop_config={"params": jparams, "tokens": tokens,
                                 "lr": lr},
        scaling_config=ttrain.ScalingConfig(num_workers=2)).fit()
    assert result.error is None, result.error
    assert result.metrics["torch_backend"] == "gloo"
    assert result.metrics["ranks_equal"]
    got = result.metrics["params"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)

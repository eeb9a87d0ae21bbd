"""North-star config #5 through the port on the CPU: the twin of
tests/test_northstar.py's ``test_vit_serve_batch_inference``.

A ViT deployment of the port's Serve with ``@serve.batch`` dynamic
batching: concurrent single-image requests must coalesce into batched
forwards (the largest batch seen above 1, the JAX test's assertion), and
every answer must be a class in [0, 10).  The replica holds the JAX
``vit_init`` weights (the same config and key as the JAX test), carried by
``params_from_jax`` and shipped by value, so each answer must also equal
the argmax of the JAX ``vit_apply`` over the same image.

North-star config #4, the twin of
``test_gpt2_streaming_data_sharded_optimizer``: GPT-2 trained in a ``TorchTrainer`` of 4 gloo workers from dataset shards,
its parameters and AdamW state sharded by ``shard_pytree`` over a
``(data=2, fsdp=2)`` mesh of the workers, against the JAX loop on the same
weights and the same global batches.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from torch_rllib_common import one_intra_op_thread  # noqa: F401

import ray_tpu.models as jm
import ray_tpu_torch
from ray_tpu.parallel import MeshConfig as JMeshConfig
from ray_tpu.parallel import build_mesh as jbuild_mesh
from ray_tpu.parallel import shard_pytree as jshard

CFG = dict(image_size=32, patch_size=8, n_layer=2, n_head=4, d_model=64,
           num_classes=10, dtype="float32")


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.init(num_cpus=8)
    yield ray_tpu_torch
    import ray_tpu_torch.serve as serve

    serve.shutdown()
    ray_tpu_torch.shutdown()


def test_vit_serve_batch_inference(cluster):
    import ray_tpu_torch.serve as serve

    jcfg = jm.ViTConfig(**CFG)
    jparams = jm.vit_init(jax.random.PRNGKey(0), jcfg)
    weights = jax.tree.map(np.asarray, jparams)

    @serve.deployment(ray_actor_options={"num_cpus": 0},
                      max_ongoing_requests=16)
    class ViTClassifier:
        def __init__(self, cfg_kw, weights):
            from ray_tpu_torch.convert import params_from_jax
            from ray_tpu_torch.models import ViTConfig

            self.cfg = ViTConfig(**cfg_kw)
            self.params = params_from_jax(weights, self.cfg, device="cpu")
            self.batch_sizes = []

        @serve.batch(max_batch_size=8, batch_wait_timeout_s=0.05)
        async def classify(self, images):
            import numpy as np_
            import torch

            from ray_tpu_torch.models import vit_apply

            with torch.no_grad():
                logits = vit_apply(self.params,
                                   torch.from_numpy(np_.stack(images)),
                                   self.cfg)
            self.batch_sizes.append(len(images))
            return [int(i) for i in logits.argmax(dim=-1)]

        async def __call__(self, image):
            return await self.classify(image)

        def seen_batches(self):
            return self.batch_sizes

    handle = serve.run(ViTClassifier.bind(CFG, weights))
    rng = np.random.default_rng(1)
    images = [rng.normal(size=(32, 32, 3)).astype(np.float32)
              for _ in range(8)]
    responses = [handle.remote(img) for img in images]
    preds = [r.result(timeout=120) for r in responses]
    assert len(preds) == 8
    assert all(0 <= p < 10 for p in preds)
    want = np.asarray(jm.vit_apply(jparams, jnp.asarray(np.stack(images)),
                                   jcfg).argmax(axis=-1))
    assert preds == [int(p) for p in want]
    # Dynamic batching actually coalesced requests.
    batches = serve.get_handle("ViTClassifier").seen_batches.remote().result(
        timeout=30)
    assert max(batches) > 1, batches
    assert sum(batches) == 8
    serve.delete("ViTClassifier")


# North-star #4: the JAX test's data and model, its AdamW (optax's defaults:
# weight decay 1e-4 on every leaf), 3 epochs of a global batch of 8.
NS4_CFG = dict(vocab_size=128, max_seq=64, dtype="float32")
NS4_WORKERS, NS4_BATCH, NS4_EPOCHS, NS4_LR = 4, 8, 3, 1e-2
FWD, GRAD = 2e-4, 1e-3  # tests/test_torch_models_sharded.py's tolerances


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def test_gpt2_streaming_data_sharded_optimizer(cluster):
    """North-star #4 through the port: 4 gloo ``TorchTrainer`` workers,
    each reading its own ``get_dataset_shard("train")`` of
    ``from_items(..., parallelism=4)``, train tiny f32 GPT-2 with its
    parameters and AdamW state sharded by ``shard_pytree`` over a
    ``(data=2, fsdp=2)`` mesh of the 4 workers (``LocalShardOptimizer``).

    ``gpt2_loss(..., mesh)`` takes the global ``[B, S+1]`` batch and each
    rank computes its own block of it (``Spmd.tokens``), as the JAX single
    controller reads the whole batch.  So each step every worker reads 2
    rows of its shard and an all-gather over the gang builds the global
    batch of 8 in rank order (rank r's rows at ``[2r, 2r + 2)``).  Rank 0
    reports each step's global batch, loss and, at step 1, every
    gradient leaf; the JAX loop (``jax.devices()[:4]`` of conftest's
    virtual devices, the same ``gpt2_init(PRNGKey(0))`` weights carried in
    by ``params_from_jax``, ``optax.adamw(1e-2)``) then runs on the same
    global batches in order.  Held in f32: step 1's loss and every later
    step's within ``FWD`` (2e-4; measured: 0 at step 1, drifting with
    AdamW's steps to 8.8e-5 at step 24), step 1's gradient leaves within
    ``GRAD`` (1e-3; measured 5.0e-7), relative to each leaf's largest
    magnitude.  Plus the JAX test's own assertions, and that the
    shards are disjoint, cover the dataset, and stay each worker's own."""
    import ray_tpu_torch.data as rdata
    import ray_tpu_torch.train as train

    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 128, size=(64, 33)).astype(np.int32)
    ds = rdata.from_items([{"tokens": t} for t in tokens], parallelism=4)
    jcfg = jm.GPT2Config.tiny(**NS4_CFG)
    jparams = jm.gpt2_init(jax.random.PRNGKey(0), jcfg)

    def loop(config):
        import numpy as np_
        import torch
        import torch.distributed as dist

        import ray_tpu_torch.train as train_
        from ray_tpu_torch.convert import params_from_jax
        from ray_tpu_torch.models import (
            GPT2Config,
            gpt2_loss,
            gpt2_param_axes,
        )
        from ray_tpu_torch.parallel import MeshConfig, build_mesh, shard_pytree
        from ray_tpu_torch.parallel.spmd import LocalShardOptimizer

        ctx = train_.get_context()
        assert ctx.backend == "gloo", ctx.backend
        world = ctx.world_size
        # SPMD across the gang: one rank a process, the dp×fsdp mesh over
        # the trainer's process group; AdamW's state shards with params.
        mesh = build_mesh(MeshConfig(data=2, fsdp=2))
        cfg = GPT2Config.tiny(**config["cfg"])
        params = shard_pytree(
            params_from_jax(config["params"], cfg, device="cpu"),
            gpt2_param_axes(), mesh).requires_grad_(True)
        opt = LocalShardOptimizer(params.parameters(), torch.optim.AdamW,
                                  lr=config["lr"], betas=(0.9, 0.999),
                                  eps=1e-8, weight_decay=1e-4)
        shard = train_.get_dataset_shard("train")
        losses = []
        for epoch in range(config["epochs"]):
            for batch in shard.iter_batches(
                    batch_size=config["batch"] // world,
                    batch_format="numpy", drop_last=True):
                mine = torch.from_numpy(np_.asarray(batch["tokens"])).long()
                rows = [torch.empty_like(mine) for _ in range(world)]
                dist.all_gather(rows, mine)
                global_batch = torch.cat(rows)
                loss = gpt2_loss(params, global_batch, cfg, mesh)
                loss.backward()
                report = {"loss": float(loss), "epoch": epoch,
                          "tokens": global_batch.numpy()}
                if not losses:  # every rank gathers; rank 0 reports
                    report["grads"] = {
                        name: p.grad.full_tensor().numpy()
                        for name, p in params.named_parameters()}
                opt.step()
                opt.zero_grad()
                losses.append(report["loss"])
                train_.report(report)
        assert losses[-1] < losses[0], (losses[0], losses[-1])

    result = train.TorchTrainer(
        loop,
        train_loop_config={"cfg": NS4_CFG, "lr": NS4_LR,
                           "batch": NS4_BATCH, "epochs": NS4_EPOCHS,
                           "params": jax.tree.map(np.asarray, jparams)},
        scaling_config=train.ScalingConfig(num_workers=NS4_WORKERS),
        datasets={"train": ds},
    ).fit()
    # The JAX test's assertions.
    assert result.error is None
    assert result.metrics["loss"] > 0
    assert result.metrics["torch_backend"] == "gloo"
    steps = result.metrics_history
    per_epoch = len(tokens) // NS4_BATCH
    assert len(steps) == NS4_EPOCHS * per_epoch
    assert steps[-1]["loss"] < steps[0]["loss"]

    # The shards: worker r's rows sit at [2r, 2r + 2) of each global batch;
    # in each epoch the 4 workers read 16 rows each, disjoint, every row of
    # the dataset once, the same 16 rows every epoch.
    index = {t.tobytes(): i for i, t in enumerate(tokens.astype(np.int64))}
    per = NS4_BATCH // NS4_WORKERS
    shards = {}
    for s in steps:
        got = [index[row.tobytes()] for row in s["tokens"]]
        for r in range(NS4_WORKERS):
            shards.setdefault((s["epoch"], r), []).extend(
                got[r * per:(r + 1) * per])
    for epoch in range(NS4_EPOCHS):
        mine = [shards[(epoch, r)] for r in range(NS4_WORKERS)]
        assert sorted(i for m in mine for i in m) == list(range(len(tokens)))
        assert [sorted(m) for m in mine] == [
            sorted(shards[(0, r)]) for r in range(NS4_WORKERS)]

    # The JAX loop on the same global batches, in order.
    mesh = jbuild_mesh(JMeshConfig(data=2, fsdp=2), jax.devices()[:4])
    params = jshard(jparams, jm.gpt2_param_axes(), mesh)
    tx = optax.adamw(NS4_LR)
    opt_state = tx.init(params)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, b: jm.gpt2_loss(p, b, jcfg, mesh)))

    @jax.jit
    def step(params, opt_state, batch):
        loss, grads = grad_fn(params, batch)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    _, first_grads = grad_fn(params, jnp.asarray(steps[0]["tokens"]))
    want = _flat(jax.tree.map(np.asarray, first_grads))
    got = steps[0]["grads"]
    assert set(got) == set(want)
    for name, w in want.items():
        err = np.abs(got[name] - w).max() / np.abs(w).max()
        assert err <= GRAD, (name, err)
    gaps = []
    for s in steps:
        params, opt_state, loss = step(params, opt_state,
                                       jnp.asarray(s["tokens"]))
        gaps.append(abs(s["loss"] - float(loss)))
    assert max(gaps) <= FWD, gaps

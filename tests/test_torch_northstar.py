"""North-star config #5 through the port on the CPU: the twin of
tests/test_northstar.py's ``test_vit_serve_batch_inference``.

A ViT deployment of the port's Serve with ``@serve.batch`` dynamic
batching: concurrent single-image requests must coalesce into batched
forwards (the largest batch seen above 1, the JAX test's assertion), and
every answer must be a class in [0, 10).  The replica holds the JAX
``vit_init`` weights (the same config and key as the JAX test), carried by
``params_from_jax`` and shipped by value, so each answer must also equal
the argmax of the JAX ``vit_apply`` over the same image.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ray_tpu.models as jm
import ray_tpu_torch

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

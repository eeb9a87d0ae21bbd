"""Deleting the disaggregated OpenAI app frees its actors' GPU leases.

``LLMDisaggServer``'s replica starts a prefill and a decode actor that
lease half a card each.  The serve controller kills a deleted replica
without a teardown call, and an actor shares its fate with its job only,
so the children watch their replica (``serve_app._exit_with``): once it
is dead they exit, and the node agent returns their leases.  A port
cluster with two GPUs declared (no card is present; engines on the CPU)
must show the whole 2.0 free again within ``LEASE_RETURN_S`` of
``serve.delete``.
"""

import time

import pytest

import ray_tpu_torch
from ray_tpu_torch import models as tm
from ray_tpu_torch import serve
from ray_tpu_torch.llm import EngineConfig, build_disagg_openai_app
from ray_tpu_torch.llm import serve_app
from ray_tpu_torch.util.state import list_actors

TIMEOUT = 120
# One owner poll (serve_app.OWNER_POLL_S), the worker's exit, and the node
# agent noticing it; generous for a loaded test host.
LEASE_RETURN_S = 30.0


def _free_gpu():
    return ray_tpu_torch.available_resources().get("GPU", 0.0)


def _wait(pred, timeout, what):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return time.monotonic()
        time.sleep(0.2)
    raise AssertionError(f"timed out after {timeout} s waiting for {what}")


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.init(num_cpus=4, resources={"GPU": 2})
    yield
    serve.shutdown()
    ray_tpu_torch.shutdown()


def test_delete_returns_the_actors_gpu_leases(cluster):
    cfg = EngineConfig(model=tm.GPT2Config.tiny(vocab_size=384, max_seq=64,
                                                dtype="float32"),
                       max_batch_size=2, max_seq_len=64, seed=0)
    handle = serve.run(build_disagg_openai_app(cfg, device="cpu"))
    out = handle.remote({"prompt": "hello", "max_tokens": 4}).result(
        timeout=TIMEOUT)
    assert out["usage"]["completion_tokens"] == 4
    # The prefill and the decode actor hold half a card each.
    _wait(lambda: _free_gpu() == 1.0, TIMEOUT, "the two actors' leases")
    # The replica and its two actors; the serve controller has a name.
    app_actors = {a["actor_id"] for a in list_actors()
                  if a["state"] == "ALIVE" and a["name"] is None}
    assert len(app_actors) == 3
    t0 = time.monotonic()
    serve.delete("LLMDisaggServer")
    t_free = _wait(lambda: _free_gpu() == 2.0, LEASE_RETURN_S,
                   "the GPU leases to return after serve.delete")
    assert t_free - t0 < LEASE_RETURN_S
    states = {a["actor_id"]: a["state"] for a in list_actors()}
    assert {states[a] for a in app_actors} == {"DEAD"}


def test_exit_with_nothing_to_watch_starts_no_thread():
    import threading

    before = threading.active_count()
    serve_app._exit_with(None)
    assert threading.active_count() == before

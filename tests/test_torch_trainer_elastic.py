"""The trainer program of ``tests/test_elastic.py`` through the port.

An elastic ``DataParallelTrainer`` of ``ray_tpu_torch.train`` crosses a grow
and a shrink and resumes from its checkpoints each time, with final
parameters bit-identical to an uninterrupted run, as the JAX package's
test requires of ``ray_tpu.train``.  Smaller than the JAX test, to keep
this file's time down: 200 steps in place of 600, gangs of 1 and 2 in
place of 2 and 4, in a cluster of 2 CPUs in place of 4.  As in the JAX
test, the grown gang fills the cluster, so the resource view the elastic
probe reads (refreshed on a period) can only under-count the room after
the burst, and the probe then waits a heartbeat and reads it again.  The
reference is the same numpy arithmetic, so the comparison is exact.  Its
own file: the controller's poll of the preempted gang waits out its 60 s
timeout, so this one test takes over a minute on the CPU.

The loop is defined inside the test: a function at this module's top
level travels by reference, and the workers cannot import this module.
"""

import os
import tempfile
import threading
import time

import numpy as np
import pytest

import ray_tpu_torch
import ray_tpu_torch.train as ttrain

DIM, LR, TOTAL_STEPS = 16, 0.05, 200


def _reference_params(n_steps):
    params = np.zeros(DIM, dtype=np.float64)
    for s in range(n_steps):
        params = params + LR * np.random.RandomState(s).standard_normal(DIM)
    return params


@pytest.fixture
def port():
    ray_tpu_torch.init(num_cpus=2)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def _wait(cond, what, timeout=120.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.1)


class _WatchedTrainer(ttrain.DataParallelTrainer):
    """The trainer, with the metrics its fit has drained so far visible to
    the test while ``fit`` runs in another thread."""

    history = None

    def _poll_until_done(self, group, run_refs, ckpt_mgr, metrics_history):
        self.history = metrics_history
        return super()._poll_until_done(group, run_refs, ckpt_mgr,
                                        metrics_history)

    def seen_world(self, n: int) -> bool:
        return any(m.get("world") == n for m in list(self.history or []))


def test_trainer_grow_shrink_loss_parity(port):
    """World 1 (1 of 2 CPUs held) -> the holder goes, the gang grows to
    2 -> a high-priority burst preempts it back to 1; the final
    parameters equal an uninterrupted run's."""
    from ray_tpu_torch.util.state.api import StateApiClient

    def alive():
        return sum(1 for a in StateApiClient().get_state()["actors"]
                   if a.get("state") == "ALIVE")

    @port.remote(num_cpus=1)
    class Occupier:
        def ping(self):
            return "pong"

    base = alive()
    occupier = Occupier.remote()
    assert port.get(occupier.ping.remote(), timeout=30) == "pong"
    # The elastic probe reads available_resources(): wait for the lease.
    _wait(lambda: port.available_resources().get("CPU", 0.0) <= 1.0,
          "the occupier's lease never showed")

    def loop(config):
        import os
        import tempfile
        import time

        import numpy as np

        import ray_tpu_torch.train as train

        tctx = train.get_context()
        start = 0
        params = np.zeros(config["dim"], dtype=np.float64)
        ck = train.get_checkpoint()
        if ck is not None:
            blob = np.load(os.path.join(ck.path, "state.npz"))
            start, params = int(blob["step"]), blob["params"]

        def save(step_done):
            ckpt = None
            if tctx.world_rank == 0:
                d = tempfile.mkdtemp()
                np.savez(os.path.join(d, "state.npz"), step=step_done,
                         params=params)
                ckpt = train.Checkpoint.from_directory(d)
            train.report({"step": step_done, "world": tctx.world_size},
                         checkpoint=ckpt)

        for step in range(start, config["total"]):
            params = params + config["lr"] * np.random.RandomState(
                step).standard_normal(config["dim"])
            time.sleep(0.03)
            offered = train.should_stop()
            if offered or (step + 1) % 10 == 0 or step + 1 == config["total"]:
                save(step + 1)
            if offered:
                return  # cooperative stop: re-form at the new size

    trainer = _WatchedTrainer(
        loop, train_loop_config={"dim": DIM, "lr": LR, "total": TOTAL_STEPS},
        scaling_config=ttrain.ScalingConfig(
            num_workers=2, min_workers=1, resources_per_worker={"CPU": 1.0},
            resize_check_period_s=0.3, resize_confirm_probes=2),
        run_config=ttrain.RunConfig(
            name="elastic-parity", storage_path=tempfile.mkdtemp(),
            failure_config=ttrain.FailureConfig(max_failures=3)))
    box = {}
    fit = threading.Thread(target=lambda: box.update(r=trainer.fit()),
                           daemon=True, name="elastic-fit")
    fit.start()
    burst = None
    try:
        _wait(lambda: alive() >= base + 2, "the gang of 1 never formed")
        _wait(lambda: trainer.seen_world(1), "no world-1 metric reached fit")
        port.kill(occupier)  # grow: room for 2
        _wait(lambda: alive() < base + 2, "the occupier never went")
        _wait(lambda: alive() >= base + 2, "the gang never grew to 2")
        # Steps at world 2: wait until fit has drained a metric of the gang
        # of 2, which a loaded host can delay well past any fixed sleep (a
        # report the gang made but fit had not yet polled is lost when the
        # burst preempts it).
        _wait(lambda: trainer.seen_world(2), "no world-2 metric reached fit")
        # shrink: a burst takes a CPU out from under the gang of 2
        burst = port.placement_group([{"CPU": 1.0}], name="burst",
                                     priority=10000)
        assert burst.ready(timeout=60)
        fit.join(timeout=120)
        assert not fit.is_alive(), "fit did not complete"
    finally:
        if burst is not None:
            port.remove_placement_group(burst)
    result = box["r"]
    assert result.error is None, f"fit failed: {result.error}"
    directions = [e["direction"] for e in result.resize_events or []]
    assert "grow" in directions and "shrink" in directions, directions
    assert max(e["to"] for e in result.resize_events) == 2
    worlds = {m.get("world") for m in result.metrics_history or []}
    assert worlds == {1, 2}, worlds
    blob = np.load(os.path.join(result.checkpoint.path, "state.npz"))
    assert int(blob["step"]) == TOTAL_STEPS
    assert np.array_equal(blob["params"], _reference_params(TOTAL_STEPS)), (
        "parameters diverged across elastic crossings")

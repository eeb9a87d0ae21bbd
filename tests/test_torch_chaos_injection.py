"""The port's twin of ``tests/test_chaos_injection.py``, case for case,
with the two name moves (``ray_tpu`` → ``ray_tpu_torch``, ``RAY_TPU_`` →
``RAY_TPU_TORCH_``), its toy pipeline stages on torch.

Chaos scenarios for the self-healing loop: each test injects a real
fault through ``ray_tpu_torch.devtools.chaos``, then asserts the full
detect → remediate → recovered-SLO arc end-to-end WITHOUT test
intervention — the test only injects, watches, and (where the fault is
external load) stops the load after the system absorbed it.

Fast subset runs in tier-1 (marked ``chaos``); the restart-storm soak
variant is additionally ``slow`` like test_chaos_soak.py."""

import threading
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.devtools import chaos
from ray_tpu_torch.util import remediation as rem
from ray_tpu_torch.util.slo import (
    CollectiveBandwidthDriftRule,
    PipelineStragglerRule,
    QueuePressureRule,
    RestartStormRule,
    SloEngine,
)

pytestmark = pytest.mark.chaos


@pytest.fixture(scope="module")
def cluster():
    ctx = ray_tpu_torch.init(num_cpus=8)
    yield ctx
    ray_tpu_torch.shutdown()


def _wait_for(pred, timeout=60, msg="condition", period=0.25):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(period)
    raise AssertionError(f"timed out waiting for {msg}")


@pytest.fixture
def controller_slot():
    """Install-and-restore for the process-wide controller, so the CLI
    surface sees the scenario's controller and later tests see none."""
    installed = []

    def install(controller, period_s=0.5):
        prev = rem.set_remediation_controller(controller)
        installed.append((controller, prev))
        controller.attach(period_s=period_s)
        return controller

    yield install
    for controller, prev in reversed(installed):
        controller.detach()
        rem.set_remediation_controller(prev)


def _applied(controller, action):
    return [a for a in controller.actions
            if a.action == action and a.outcome == rem.OUTCOME_APPLIED]


def _slo_clean(controller):
    """Recovered = the controller's engine is still beating and its last
    evaluation found nothing."""
    return controller.beats > 2 and not controller.engine.last_violations


def _assert_surfaced(action_kind, capsys, expect_rc=(0, 1)):
    """The acceptance surface for every scenario: the applied action is
    visible in `cli slo` and as a span in the cluster timeline."""
    from ray_tpu_torch.scripts import cli
    from ray_tpu_torch.util import obs

    rc = cli.main(["slo", "--window", "0"])
    out = capsys.readouterr().out
    assert rc in expect_rc, out
    assert action_kind in out

    trace = obs.cluster_timeline()
    names = {e.get("name") for e in trace["traceEvents"]}
    assert f"remediation.{action_kind}" in names


# --------------------------------------------------------------- toy model
def make_toy_builder():
    """By-value closure (stage workers never import this module): the JAX
    test's toy chunks on torch, each drawn from its chunk's generator."""

    def toy_builder(v, total):
        import torch

        from ray_tpu_torch.train.pipeline import StageModule

        d = 8
        if v < total - 1:
            def init(gen):
                return {"w": torch.randn((d, d), generator=gen,
                                         device=gen.device) * 0.3}

            def apply(p, x):
                return torch.tanh(x @ p["w"])

            return StageModule(init=init, apply=apply)

        def init(gen):
            return {"w": torch.randn((d, 1), generator=gen,
                                     device=gen.device) * 0.3}

        def apply(p, x, targets):
            return torch.mean((x @ p["w"] - targets) ** 2)

        return StageModule(init=init, apply=apply, is_loss_stage=True)

    return toy_builder


def toy_data(step):
    rng = np.random.RandomState(100 + step)
    return (rng.randn(8, 8).astype(np.float32),
            rng.randn(8, 1).astype(np.float32))


@pytest.fixture
def trainer(cluster):
    from ray_tpu_torch.train import PipelineConfig, PipelinedTrainer, RunConfig
    from ray_tpu_torch.train.config import FailureConfig

    tr = PipelinedTrainer(
        make_toy_builder(),
        pipeline_config=PipelineConfig(
            num_stages=2, num_microbatches=4, recv_timeout_s=30.0,
            checkpoint_every_n_steps=5,
        ),
        data_per_step=toy_data,
        num_steps=1_000_000,  # runs until the test ends it
        learning_rate=1e-2,
        run_config=RunConfig(
            failure_config=FailureConfig(max_failures=20)
        ),
    )
    box = {}
    th = threading.Thread(
        target=lambda: box.update(result=tr.fit()),
        name="chaos-trainer", daemon=True,
    )
    th.start()
    yield tr
    tr.num_steps = 0  # the fit loop checks this every step
    th.join(timeout=120)
    tr.shutdown()
    assert "result" in box and box["result"].error is None, box


# ----------------------------------------------- scenario 1: slow stage
def test_slow_pipeline_stage_respawn_recovers(cluster, trainer,
                                              controller_slot, capsys):
    """A slow host under stage 1: the straggler rule flags the stalling
    victim (stage 0), the trainer's actuator localizes the culprit by
    compute share and respawns stage 1 through the generation-fenced
    restart — which clears the injected fault (fresh actor) — and the
    SLO report recovers on its own."""
    _wait_for(lambda: trainer._last_step_stats, 120, "first trainer step")
    controller = controller_slot(rem.RemediationController(
        engine=SloEngine(rules=[
            PipelineStragglerRule(window_s=8.0, min_samples=3),
            RestartStormRule(),
        ]),
        cooldown_s=20.0, burst=1, max_actions_per_incident=3,
        straggler_sustain_s=1.0,
    ))
    restarts_before = trainer._restarts
    with chaos.SlowPipelineStage(trainer, stage=1, compute_delay_s=0.12):
        _wait_for(
            lambda: _applied(controller, rem.ACTION_PIPELINE_RESPAWN),
            120, "respawn action applied",
        )
        _wait_for(lambda: trainer._restarts > restarts_before, 90,
                  "stage respawned")
        # Recovery WITHOUT reverting: the respawn replaced the faulted
        # actor, so the chaos is gone and the SLO window drains clean.
        _wait_for(lambda: _slo_clean(controller), 90, "clean SLO report")
    action = _applied(controller, rem.ACTION_PIPELINE_RESPAWN)[0]
    assert "stage 1 respawn requested" in action.detail  # culprit, not victim
    assert "culprit by compute share" in action.detail
    # Visible in `cli slo` (not exit 2 — nothing was quarantined) and as
    # a span in the cluster timeline.
    _assert_surfaced(rem.ACTION_PIPELINE_RESPAWN, capsys)


# ------------------------------------------ scenario 2: overloaded serve
def test_overloaded_serve_replica_scales_and_recovers(cluster,
                                                      controller_slot,
                                                      capsys):
    """Offered load exceeds one replica's capacity; the native
    autoscaler signals are neutered so the remediation path is the only
    fixer: queue_pressure (recorded queue-wait window) → serve replica
    scale-up through the controller's autoscale path, repeated under
    the rate limit until the SLO report is clean WHILE the load keeps
    running."""
    import ray_tpu_torch.serve as serve

    @serve.deployment(
        name="chaosd",
        ray_actor_options={"num_cpus": 0},
        max_ongoing_requests=1,
        autoscaling_config={
            "min_replicas": 1,
            "max_replicas": 4,
            # Native signals off: queue-depth target unreachable, no
            # recorded-signal target, downscale effectively never.
            "target_ongoing_requests": 1000.0,
            "upscale_delay_s": 3600.0,
            "downscale_delay_s": 3600.0,
            "target_queue_wait_s": None,
        },
    )
    class SlowOnce:
        def __call__(self, x):
            time.sleep(0.25)
            return x

    handle = serve.run(SlowOnce.bind())
    try:
        controller = controller_slot(rem.RemediationController(
            engine=SloEngine(rules=[
                QueuePressureRule(depth=1e9, sustain_s=1.5,
                                  queue_wait_s=0.3),
                RestartStormRule(),
            ]),
            cooldown_s=3.0, burst=1, max_actions_per_incident=4,
        ))
        load = chaos.OverloadedServeReplica(
            lambda: handle.remote(1).result(timeout=60), concurrency=5,
        )
        with load:
            _wait_for(
                lambda: _applied(controller, rem.ACTION_SERVE_SCALE_UP),
                90, "serve scale-up applied",
            )
            _wait_for(
                lambda: serve.status()["chaosd"]["num_replicas"] >= 2,
                60, "replicas grew",
            )
            # The SLO must come back clean while the load continues —
            # the added replicas absorb it.
            _wait_for(lambda: _slo_clean(controller), 90,
                      "clean SLO under sustained load")
        assert load.requests > 0
        action = _applied(controller, rem.ACTION_SERVE_SCALE_UP)[0]
        assert action.target == "chaosd"
        assert "replicas ->" in action.detail
        assert not controller.quarantined
        _assert_surfaced(rem.ACTION_SERVE_SCALE_UP, capsys)
    finally:
        serve.delete("chaosd")


# --------------------------------------- scenario 3: throttled collective
def test_throttled_collective_link_reprobe_recovers(cluster,
                                                    controller_slot,
                                                    capsys):
    """One fabric member's committed-algorithm bandwidth collapses (a
    degraded link).  The drift rule flags the member; remediation
    broadcasts a forced tuner re-probe through the node agents to every
    worker; the member's tuner re-commits around the throttled path and
    its recorded bandwidth — and the SLO — recover, with the throttle
    still applied."""
    Member = ray_tpu_torch.remote(chaos.CollectiveFabricMember)
    a = Member.remote()
    b = Member.remote()

    stop = threading.Event()

    def pump_loop():
        while not stop.is_set():
            try:
                ray_tpu_torch.get(
                    [a.run_ops.remote(3), b.run_ops.remote(3)], timeout=60
                )
                ray_tpu_torch.get(
                    [a.flush_metrics.remote(), b.flush_metrics.remote()],
                    timeout=30,
                )
            except Exception:  # noqa: BLE001 — teardown race at test end
                return
            stop.wait(0.2)

    # Drive both members to a tuner commitment AND deep into the
    # decaying re-probe schedule (a long-stable fabric probes rarely —
    # the exact regime where only the FORCED re-probe reacts in time;
    # with a young schedule the tuner's own decay self-heals first and
    # the remediation path is never exercised).
    for _ in range(2):
        ray_tpu_torch.get(
            [a.run_ops.remote(125), b.run_ops.remote(125)], timeout=120
        )
    committed = ray_tpu_torch.get(a.committed.remote(), timeout=30)
    assert committed is not None

    pump = threading.Thread(target=pump_loop, name="chaos-fabric",
                            daemon=True)
    pump.start()
    try:
        controller = controller_slot(rem.RemediationController(
            engine=SloEngine(rules=[
                CollectiveBandwidthDriftRule(frac=0.5, window_s=8.0,
                                             min_samples=2),
                RestartStormRule(),
            ]),
            cooldown_s=5.0, burst=1, max_actions_per_incident=5,
        ))
        with chaos.ThrottledCollectiveLink(a, committed, factor=100.0):
            _wait_for(
                lambda: _applied(controller,
                                 rem.ACTION_COLLECTIVE_REPROBE),
                120, "collective re-probe applied",
            )
            # The re-probe reached the member's process and its tuner
            # re-committed AWAY from the throttled algorithm...
            _wait_for(
                lambda: ray_tpu_torch.get(a.committed.remote(), timeout=30)
                != committed,
                90, "tuner re-committed around the throttled link",
            )
            # ...which is what recovers the SLO — throttle still on.
            _wait_for(lambda: _slo_clean(controller), 90,
                      "clean SLO with throttle still applied")
        action = _applied(controller, rem.ACTION_COLLECTIVE_REPROBE)[0]
        assert "directive reached" in action.detail
        assert not controller.quarantined
        _assert_surfaced(rem.ACTION_COLLECTIVE_REPROBE, capsys)
    finally:
        stop.set()
        pump.join(timeout=60)
        for h in (a, b):
            ray_tpu_torch.kill(h)


# ------------------------------------- soak: restart storm -> quarantine
@pytest.mark.slow
def test_restart_storm_quarantines_not_amplifies(cluster, trainer,
                                                 controller_slot, capsys):
    """Soak variant: a stage actor killed over and over (a crash loop
    remediation cannot fix).  The storm rule fires; the controller
    QUARANTINES the stage instead of stacking respawns on top of the
    trainer's own recovery, and `cli slo` exits 2."""
    _wait_for(lambda: trainer._last_step_stats, 120, "first trainer step")
    controller = controller_slot(rem.RemediationController(
        engine=SloEngine(rules=[
            RestartStormRule(max_restarts=3, window_s=240.0),
            PipelineStragglerRule(window_s=8.0),
        ]),
        cooldown_s=5.0, quarantine_s=600.0,
    ))

    def step_of():
        stats = trainer._last_step_stats
        return stats[0]["step"] if stats else -1

    kills = 0
    deadline = time.monotonic() + 300
    while time.monotonic() < deadline and not controller.quarantined:
        restarts = trainer._restarts
        before_step = step_of()
        chaos.KilledStageActor(trainer, stage=1).apply()
        kills += 1
        _wait_for(lambda: trainer._restarts > restarts, 180,
                  "trainer absorbed the kill")
        # Distinct crash events, not kills racing the rebuild: wait for
        # a post-recovery step to complete before the next kill.
        _wait_for(lambda: step_of() != before_step, 180,
                  "post-recovery step")
    assert kills >= 4  # the storm threshold had to be crossed
    assert any("stage=1" in t for t in controller.quarantined)
    applied = _applied(controller, rem.ACTION_PIPELINE_RESPAWN)
    assert applied == []  # the controller never fed the loop

    from ray_tpu_torch.scripts import cli

    rc = cli.main(["slo", "--window", "0"])
    out = capsys.readouterr().out
    assert rc == 2
    assert "QUARANTINED" in out

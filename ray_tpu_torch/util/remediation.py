"""Self-healing remediation controller: the reflex arc over the SLO engine.

PR 10 built the eyes — stitched traces and an ``SloEngine`` that detects
pipeline stragglers, restart storms, collective bandwidth drift, and
queue pressure.  This module closes the loop: a controller that
subscribes to the engine's findings each aggregation beat and maps
rule → action through a pluggable policy table, driving the actuators
that already exist in the runtime:

  ===================== ==========================================
  rule                  default action
  ===================== ==========================================
  queue_pressure        serve replica scale-up through the serve
                        controller's autoscale path (deployments),
                        or a data actor-pool scale-up (streaming ops)
  pipeline_straggler    respawn-and-replace the straggling stage via
                        the generation-fenced pipeline restart
                        (sustained findings only — a respawn costs a
                        checkpoint rollback)
  collective_bw_drift   forced collective-tuner re-probe, fanned to
                        every worker through the node agents so group
                        members re-probe in lockstep
  restart_storm         back off and QUARANTINE the target: stop
                        remediating it, raise severity — the
                        controller must never amplify a crash loop
  ===================== ==========================================

Safety properties (the part that makes this shippable):

  - **Rate limited.**  Every (rule, target) pair draws from a token
    bucket (``burst`` actions, one refill per ``cooldown_s``) — a
    finding re-arriving every beat cannot fire an actuator every beat.
  - **Idempotent.**  An ongoing incident (the engine's fingerprint
    dedupe) that was already acted on records ``rate_limited`` at most
    once per state change instead of stacking duplicate actions.
  - **Bounded.**  ``max_actions_per_incident`` actions on one incident
    without the finding clearing quarantines the target; a
    ``restart_storm`` finding quarantines its target immediately.
    Quarantine expires after ``quarantine_s`` (a human's pager window).
  - **Observable.**  Every decision is a
    ``ray_tpu_remediation_actions_total{rule,action,outcome}`` count, a
    ``remediation.<action>`` span in the cluster timeline, and a row in
    ``cli slo`` / ``/api/slo`` (``cli slo`` exits 2 while quarantined).

Actuators are resolved through a process-local registry
(``register_actuator``) with built-in fallbacks for the serve
controller and the collective tuner; live components (the pipelined
trainer, streaming actor pools) register themselves while they run.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from ..core.config import GlobalConfig
from .debug_locks import make_lock

logger = logging.getLogger(__name__)

# Action outcomes (the {outcome} tag of the remediation counter).
OUTCOME_APPLIED = "applied"          # actuator ran and accepted the action
OUTCOME_SKIPPED = "skipped"          # actuator declined (e.g. at max replicas)
OUTCOME_FAILED = "failed"            # actuator raised
OUTCOME_RATE_LIMITED = "rate_limited"  # token bucket empty
OUTCOME_QUARANTINED = "quarantined"  # target quarantined — no action taken
OUTCOME_NO_ACTUATOR = "no_actuator"  # nothing registered for the action

# Action kinds (the {action} tag; also the actuator-registry keys).
ACTION_SERVE_SCALE_UP = "serve_scale_up"
ACTION_PIPELINE_RESPAWN = "pipeline_stage_respawn"
ACTION_COLLECTIVE_REPROBE = "collective_reprobe"
ACTION_DATA_POOL_SCALE_UP = "data_pool_scale_up"
ACTION_QUARANTINE = "quarantine"
ACTION_PREEMPT_LOW_PRIORITY = "preempt_low_priority"


class RemediationSkipped(Exception):
    """Raised by an actuator that declines an action (not an error):
    e.g. a scale-up at ``max_replicas``.  Recorded as ``skipped``."""


@dataclasses.dataclass
class RemediationAction:
    """One controller decision, as surfaced in ``cli slo`` and
    ``/api/slo``."""

    rule: str
    action: str
    target: str
    outcome: str
    detail: str
    ts: float

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class RemediationPlan:
    """What a policy wants done about one violation."""

    action: str
    target: str
    min_ongoing_s: float = 0.0   # finding must be this old before acting
    kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)


class _TokenBucket:
    """Per-(rule, target) action budget: ``capacity`` tokens, one refill
    every ``1/refill_per_s`` seconds."""

    def __init__(self, capacity: int, refill_per_s: float):
        self.capacity = max(1, capacity)
        self.refill_per_s = refill_per_s
        self.tokens = float(self.capacity)
        self._ts: Optional[float] = None

    def take(self, now: float) -> bool:
        if self._ts is not None and now > self._ts:
            self.tokens = min(
                float(self.capacity),
                self.tokens + (now - self._ts) * self.refill_per_s,
            )
        self._ts = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False


# --------------------------------------------------------- actuator registry
# kind -> {target_or_"*": [(token, fn), ...]} — a STACK per slot, newest
# wins, so two live components sharing a slot (two pools mapping the
# same op label, two concurrent trainers) never clobber each other: each
# unregisters only its own token and the other's hook survives.
# fn(target, violation, **kwargs) -> detail str.  Live components
# (PipelinedTrainer, streaming actor pools) register here for their
# lifetime; built-ins below cover the serve controller and the
# collective tuner without registration.
_actuators: Dict[str, Dict[str, List[tuple]]] = {}
_actuators_lock = make_lock("remediation.actuators")
_actuator_seq = [0]


def register_actuator(kind: str, fn: Callable, target: str = "*") -> tuple:
    """Register ``fn(target, violation, **kwargs) -> detail`` for action
    ``kind`` (optionally for one specific target).  Returns a handle for
    ``unregister_actuator``; the newest registration on a slot wins."""
    with _actuators_lock:
        _actuator_seq[0] += 1
        token = _actuator_seq[0]
        _actuators.setdefault(kind, {}).setdefault(target, []).append(
            (token, fn)
        )
    return (kind, target, token)


def unregister_actuator(handle: tuple) -> None:
    kind, target, token = handle
    with _actuators_lock:
        kinds = _actuators.get(kind)
        stack = kinds.get(target) if kinds is not None else None
        if stack is not None:
            stack[:] = [e for e in stack if e[0] != token]
            if not stack:
                kinds.pop(target, None)
            if not kinds:
                _actuators.pop(kind, None)


_BUILTIN_ACTUATORS: Dict[str, Callable] = {}


def _registered_actuator(kind: str, target: str) -> Optional[Callable]:
    with _actuators_lock:
        kinds = _actuators.get(kind) or {}
        stack = kinds.get(target) or kinds.get("*")
        return stack[-1][1] if stack else None


def _resolve_actuator(kind: str, target: str) -> Optional[Callable]:
    return _registered_actuator(kind, target) or _BUILTIN_ACTUATORS.get(kind)


# ----------------------------------------------------------- built-in actors
def _builtin_serve_scale_up(target: str, violation, **_kw) -> str:
    """One-replica scale-up through the serve controller's autoscale
    path (drain bookkeeping, event recording, max_replicas clamp)."""
    import ray_tpu_torch
    from ..serve.controller import CONTROLLER_NAME

    controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    reply = ray_tpu_torch.get(
        controller.remediation_scale_up.remote(target), timeout=30
    )
    if not reply.get("scaled"):
        # Fair-share fallback (multi-tenant arbitration): a deployment
        # pinned at max_replicas under sustained queue pressure is a
        # capacity fight, not a config ceiling — free the chips by
        # checkpoint-then-evicting lower-priority training instead of
        # declining outright.  The preemption spends the control plane's
        # token-bucket budget, so a flapping finding cannot evict the
        # world (see docs/scheduling.md).
        resources = reply.get("replica_resources")
        if resources:
            detail = _builtin_preempt_low_priority(
                target, violation, resources=resources,
                cause=f"serve queue pressure on {target!r} "
                      f"({reply.get('reason', 'declined')})",
            )
            if detail is not None:
                return detail
        raise RemediationSkipped(reply.get("reason", "declined"))
    return f"deployment {target}: replicas -> {reply['replicas']}"


def _builtin_preempt_low_priority(
    target: str,
    violation,
    resources: Optional[Dict[str, float]] = None,
    priority: Optional[int] = None,
    max_victims: Optional[int] = None,
    cause: str = "",
    **_kw,
) -> Optional[str]:
    """Ask the control plane to checkpoint-then-evict lower-priority
    placement groups so ``resources`` worth of capacity frees up for
    ``target``.  Returns a detail string, or None when the control plane
    declines (no victims / budget exhausted) — callers treat None as
    "fall through to skipped"."""
    from ..core.core_worker import try_global_worker

    w = try_global_worker()
    if w is None:
        return None
    reply = w._run_sync(
        w.cp.call(
            "request_preemption",
            {
                "bundles": [dict(resources or {"CPU": 1.0})],
                "priority": priority,
                "max_victims": max_victims
                if max_victims is not None
                else GlobalConfig.sched_preemption_burst,
                "cause": cause or f"remediation for {target!r}",
            },
            timeout=30,
        )
    )
    preempted = reply.get("preempted") or []
    if not preempted:
        logger.debug(
            "preempt_low_priority for %s declined: %s",
            target, reply.get("reason"),
        )
        return None
    short = ", ".join(p[:8] for p in preempted)
    return (
        f"{target}: preempted {len(preempted)} lower-priority "
        f"placement group(s) [{short}]"
    )


def _builtin_collective_reprobe(target: str, violation,
                                op: Optional[str] = None, **_kw) -> str:
    """Arm the local tuner's forced re-probe AND broadcast the directive
    to every worker via the node agents, so multi-member groups re-probe
    in lockstep (see ``CollectiveTuner.force_reprobe``)."""
    from ..collective.tuner import get_tuner

    armed = get_tuner().force_reprobe(op)
    reached = broadcast_directive(
        {"kind": ACTION_COLLECTIVE_REPROBE, "op": op, "target": target}
    )
    return (f"armed {armed} local bucket(s); directive reached "
            f"{reached} worker(s)")


_BUILTIN_ACTUATORS[ACTION_SERVE_SCALE_UP] = _builtin_serve_scale_up
_BUILTIN_ACTUATORS[ACTION_COLLECTIVE_REPROBE] = _builtin_collective_reprobe


def _preempt_actuator(target: str, violation, **kw) -> str:
    """Registry wrapper for ``ACTION_PREEMPT_LOW_PRIORITY``: unlike the
    serve fallback it treats a control-plane decline as ``skipped``."""
    detail = _builtin_preempt_low_priority(target, violation, **kw)
    if detail is None:
        raise RemediationSkipped("control plane declined preemption")
    return detail


_BUILTIN_ACTUATORS[ACTION_PREEMPT_LOW_PRIORITY] = _preempt_actuator


def broadcast_directive(directive: Dict[str, Any],
                        timeout: float = 15.0) -> int:
    """Fan a remediation directive to every live node agent (one
    ``remediate`` RPC each; agents forward to their local workers).
    Returns the number of worker processes that applied it.  Best
    effort: an unreachable agent costs coverage, not the action."""
    from ..core.core_worker import try_global_worker

    w = try_global_worker()
    if w is None:
        return 0

    async def send_all():
        view = await w.cp.call("get_cluster_view", {})

        async def one(address):
            try:
                return await w.agent_clients.get(address).call(
                    "remediate", {"directives": [directive]},
                    timeout=timeout, retries=1,
                )
            except Exception:  # noqa: BLE001 — coverage, not correctness
                from . import flight_recorder

                flight_recorder.count_suppressed("remediate_broadcast")
                return None

        replies = await asyncio.gather(*(
            one(node["agent_address"])
            for node in view.get("nodes", {}).values()
        ))
        return sum(r.get("workers", 0) for r in replies if r)

    return w._run_sync(send_all(), timeout=timeout + 5)


def apply_local_directive(directive: Dict[str, Any]) -> Dict[str, Any]:
    """Apply one broadcast directive inside THIS process (the worker's
    ``remediate`` RPC handler lands here)."""
    kind = directive.get("kind")
    if kind == ACTION_COLLECTIVE_REPROBE:
        from ..collective.tuner import get_tuner

        return {"kind": kind,
                "armed": get_tuner().force_reprobe(directive.get("op"))}
    fn = _registered_actuator(kind, directive.get("target", "*"))
    if fn is None:
        return {"kind": kind, "error": "no local actuator"}
    try:
        return {"kind": kind,
                "detail": fn(directive.get("target", "*"), None)}
    except Exception as e:  # noqa: BLE001 — a bad actuator must not kill the fan-out
        return {"kind": kind, "error": f"{type(e).__name__}: {e}"}


# ------------------------------------------------------------ subject parsing
def subject_tags(subject: str) -> Dict[str, str]:
    """Extract ``k=v`` pairs from an SLO finding subject — handles both
    the brace form (``name{stage=0,group=g}``) and bare tokens
    (``stage=2``, ``worker:ab12 op=allreduce``)."""
    out: Dict[str, str] = {}
    body = subject
    if "{" in subject and subject.endswith("}"):
        body = subject[subject.index("{") + 1:-1]
        for pair in body.split(","):
            if "=" in pair:
                k, v = pair.split("=", 1)
                out[k.strip()] = v.strip()
        return out
    for token in body.replace(",", " ").split():
        if "=" in token:
            k, v = token.split("=", 1)
            out[k] = v
    return out


# ------------------------------------------------------------ default policy
def default_policies(straggler_sustain_s: float = 5.0,
                     ) -> Dict[str, Callable]:
    """The rule → plan table.  Pluggable: pass a modified copy to
    ``RemediationController(policies=...)`` to change mappings or add
    rules."""
    from .metric_registry import DATA_QUEUE_DEPTH

    def queue_pressure(v) -> Optional[RemediationPlan]:
        tags = subject_tags(v.subject)
        if v.subject.startswith("serve_queue_wait") and "deployment" in tags:
            return RemediationPlan(
                ACTION_SERVE_SCALE_UP, tags["deployment"]
            )
        if v.subject.startswith(DATA_QUEUE_DEPTH) and "op" in tags:
            return RemediationPlan(ACTION_DATA_POOL_SCALE_UP, tags["op"])
        return None  # lease/RL queues: no safe actuator yet

    def pipeline_straggler(v) -> Optional[RemediationPlan]:
        tags = subject_tags(v.subject)
        if "stage" not in tags:
            return None
        # Sustained only: a respawn rolls every stage back to the last
        # synchronized checkpoint — not a response to one bad window.
        return RemediationPlan(
            ACTION_PIPELINE_RESPAWN, f"stage={tags['stage']}",
            min_ongoing_s=straggler_sustain_s,
        )

    def collective_bw_drift(v) -> Optional[RemediationPlan]:
        tags = subject_tags(v.subject)
        return RemediationPlan(
            ACTION_COLLECTIVE_REPROBE, v.subject,
            kwargs={"op": tags.get("op")},
        )

    return {
        "queue_pressure": queue_pressure,
        "pipeline_straggler": pipeline_straggler,
        "collective_bw_drift": collective_bw_drift,
    }


# --------------------------------------------------------------- controller
class RemediationController:
    """Maps SLO findings to actuator actions, bounded by token buckets
    and quarantine.  Drive it with ``step()`` (one aggregation beat) or
    ``attach()`` (a background beat thread)."""

    def __init__(
        self,
        engine=None,
        *,
        policies: Optional[Dict[str, Callable]] = None,
        cooldown_s: float = 30.0,
        burst: int = 1,
        max_actions_per_incident: int = 3,
        quarantine_s: float = 600.0,
        straggler_sustain_s: float = 5.0,
        history: int = 200,
        publish: bool = True,
    ):
        from . import slo as _slo

        self.engine = engine if engine is not None else _slo.get_slo_engine()
        self.policies = (
            default_policies(straggler_sustain_s)
            if policies is None else dict(policies)
        )
        self.cooldown_s = cooldown_s
        self.burst = burst
        self.max_actions_per_incident = max_actions_per_incident
        self.quarantine_s = quarantine_s
        self.publish = publish
        self.actions: deque = deque(maxlen=history)
        self.totals: Dict[str, int] = {}
        self.beats = 0
        # target -> {"until": ts, "reason": str, "rule": str, "since": ts}
        self.quarantined: Dict[str, Dict[str, Any]] = {}
        self._buckets: Dict[tuple, _TokenBucket] = {}
        self._incidents: Dict[tuple, Dict[str, Any]] = {}
        self._last_outcome: Dict[tuple, tuple] = {}
        # Guards the REPORTED state (actions/totals/quarantined) against
        # concurrent report() readers; the process/step path itself is
        # single-threaded (the beat thread, or a test driving step()),
        # and actuator calls — which can be slow RPCs — deliberately run
        # outside the lock.
        self._lock = make_lock("remediation.controller")
        self._beat_rows: List[RemediationAction] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_obs_beat: Optional[int] = None

    # ------------------------------------------------------------- recording
    def _record(self, rule: str, action: str, target: str, outcome: str,
                detail: str, now: float,
                start: Optional[float] = None) -> RemediationAction:
        from . import flight_recorder, tracing

        row = RemediationAction(rule, action, target, outcome, detail, now)
        with self._lock:
            self.actions.append(row)
            self.totals[outcome] = self.totals.get(outcome, 0) + 1
        self._beat_rows.append(row)
        flight_recorder.record_remediation_action(rule, action, outcome)
        try:
            span = tracing.detached_span(
                f"remediation.{action}",
                {"rule": rule, "target": target, "outcome": outcome,
                 "detail": detail[:200]},
            )
            if start is not None:
                span.start = start
            tracing.finish_span(span)
        except Exception:  # noqa: BLE001 — a span must never block an action
            flight_recorder.count_suppressed("remediation_span")
        return row

    def _record_once(self, fp: tuple, rule: str, action: str, target: str,
                     outcome: str, detail: str, now: float) -> None:
        """Record non-action outcomes (rate_limited/quarantined/...) only
        when they CHANGE for this incident — an ongoing condition must
        not stack one identical row per beat."""
        if self._last_outcome.get(fp) == (action, outcome):
            return
        self._last_outcome[fp] = (action, outcome)
        self._record(rule, action, target, outcome, detail, now)

    # ------------------------------------------------------------ quarantine
    def _quarantine(self, target: str, now: float, rule: str,
                    reason: str) -> bool:
        """Returns True when this call newly (re)opened the quarantine."""
        with self._lock:
            ent = self.quarantined.get(target)
            fresh = ent is None or ent["until"] <= now
            self.quarantined[target] = {
                "until": now + self.quarantine_s,
                "since": ent["since"] if ent and not fresh else now,
                "rule": rule,
                "reason": reason,
            }
        return fresh

    def _is_quarantined(self, target: str, now: float) -> bool:
        with self._lock:
            ent = self.quarantined.get(target)
        return ent is not None and ent["until"] > now

    def quarantine_active(self, now: Optional[float] = None) -> bool:
        now = time.time() if now is None else now
        with self._lock:
            return any(e["until"] > now for e in self.quarantined.values())

    # --------------------------------------------------------------- process
    def process(self, violations: List[Any],
                now: Optional[float] = None) -> List[RemediationAction]:
        """Map one beat's findings to actions.  Returns the actions
        RECORDED this beat (including rate-limit/quarantine decisions)."""
        from . import flight_recorder

        now = time.time() if now is None else now
        self._beat_rows = []
        seen = set()
        for v in violations:
            fp = (v.rule, v.subject)
            seen.add(fp)
            if v.rule == "restart_storm":
                self._handle_storm(v, fp, now)
                continue
            policy = self.policies.get(v.rule)
            plan = policy(v) if policy is not None else None
            if plan is None:
                continue
            self._apply_plan(v, fp, plan, now)
        # Condition cleared: forget its incident budget and outcome
        # latch so a future recurrence is a fresh incident.
        for fp in [f for f in self._incidents if f not in seen]:
            del self._incidents[fp]
        for fp in [f for f in self._last_outcome if f not in seen]:
            del self._last_outcome[fp]
        with self._lock:
            for t in [t for t, e in self.quarantined.items()
                      if e["until"] <= now]:
                del self.quarantined[t]
            n_quarantined = len(self.quarantined)
        flight_recorder.record_remediation_quarantine(n_quarantined)
        return self._beat_rows

    def _handle_storm(self, v, fp: tuple, now: float) -> None:
        """Restart storm: never act — quarantine every target named by
        the finding so the controller cannot feed the loop."""
        tags = subject_tags(v.subject)
        targets = (
            [f"{k}={val}" for k, val in sorted(tags.items())]
            or [v.subject]
        )
        v.severity = "critical"
        for target in targets:
            if self._quarantine(target, now, v.rule, v.detail):
                self._record(v.rule, ACTION_QUARANTINE, target,
                             OUTCOME_QUARANTINED, v.detail, now)

    def _apply_plan(self, v, fp: tuple, plan: RemediationPlan,
                    now: float) -> None:
        if self._is_quarantined(plan.target, now):
            v.severity = "critical"
            self._record_once(fp, v.rule, plan.action, plan.target,
                              OUTCOME_QUARANTINED, "target quarantined",
                              now)
            return
        first = v.first_seen or now
        if plan.min_ongoing_s > 0 and now - first < plan.min_ongoing_s:
            return  # not sustained yet: waiting is not an action
        incident = self._incidents.setdefault(
            fp, {"actions": 0, "last_action": 0.0}
        )
        if incident["actions"] >= self.max_actions_per_incident:
            # The budget is spent and the condition STILL stands:
            # remediation is not working — stop and page.
            self._quarantine(
                plan.target, now, v.rule,
                f"{incident['actions']} action(s) did not clear "
                f"{v.rule} on {v.subject}",
            )
            v.severity = "critical"
            self._record_once(fp, v.rule, plan.action, plan.target,
                              OUTCOME_QUARANTINED,
                              "remediation budget exhausted", now)
            return
        bucket = self._buckets.setdefault(
            (v.rule, plan.target),
            _TokenBucket(self.burst, 1.0 / max(self.cooldown_s, 1e-9)),
        )
        if not bucket.take(now):
            self._record_once(fp, v.rule, plan.action, plan.target,
                              OUTCOME_RATE_LIMITED,
                              f"cooldown {self.cooldown_s:.0f}s", now)
            return
        fn = _resolve_actuator(plan.action, plan.target)
        if fn is None:
            self._record_once(fp, v.rule, plan.action, plan.target,
                              OUTCOME_NO_ACTUATOR,
                              "no actuator registered", now)
            return
        start = time.time()
        try:
            detail = fn(plan.target, v, **plan.kwargs) or ""
            outcome = OUTCOME_APPLIED
        except RemediationSkipped as e:
            outcome, detail = OUTCOME_SKIPPED, str(e)
        except Exception as e:  # noqa: BLE001 — a failing actuator is an outcome, not a crash
            outcome, detail = OUTCOME_FAILED, f"{type(e).__name__}: {e}"
        # Failed and skipped attempts spend incident budget too: an
        # actuator that cannot help converges on quarantine instead of
        # being retried forever.
        incident["actions"] += 1
        incident["last_action"] = now
        self._last_outcome[fp] = (plan.action, outcome)
        self._record(v.rule, plan.action, plan.target, outcome,
                     str(detail), now, start=start)

    # ------------------------------------------------------------------ beat
    def step(self, now: Optional[float] = None) -> List[RemediationAction]:
        """One aggregation beat: evaluate the engine, act, publish."""
        now = time.time() if now is None else now
        violations = self.engine.evaluate(now=now)
        actions = self.process(violations, now=now)
        self.beats += 1
        if self.publish:
            self._publish_report()
        return actions

    def _publish_report(self) -> None:
        """Drop the report into the cluster KV so ``cli slo`` from any
        process can see what the controller did."""
        from ..core.core_worker import try_global_worker

        w = try_global_worker()
        if w is None:
            return
        try:
            w.kv_put("remediation", "report", self.report())
        except Exception:  # noqa: BLE001 — visibility is best-effort
            from . import flight_recorder

            flight_recorder.count_suppressed("remediation_publish")

    def _cluster_obs_beat(self) -> Optional[int]:
        """The control plane's aggregation-beat counter (obs_report
        arrivals) — lets the beat thread skip evaluations when no new
        telemetry landed."""
        from ..core.core_worker import try_global_worker

        w = try_global_worker()
        if w is None:
            return None
        try:
            reply = w._run_sync(
                w.cp.call("debug_control_plane", {}), timeout=5
            )
            return reply.get("obs_beats")
        except Exception:  # noqa: BLE001 — beat alignment is an optimization
            return None

    def _beat_loop(self, period_s: float) -> None:
        from . import flight_recorder

        idle = 0
        while not self._stop.wait(period_s):
            try:
                beat = self._cluster_obs_beat()
                if beat is not None and beat == self._last_obs_beat:
                    # No new aggregation beat: skip, but never starve
                    # the sustain/rate windows for long.
                    idle += 1
                    if idle < 5:
                        continue
                self._last_obs_beat = beat
                idle = 0
                self.step()
            except Exception:  # noqa: BLE001 — the reflex arc must outlive one bad beat
                flight_recorder.count_suppressed("remediation_beat")

    def attach(self, period_s: Optional[float] = None) -> None:
        """Start the background beat thread (default period: the agent
        heartbeat / aggregation cadence)."""
        if self._thread is not None and self._thread.is_alive():
            return
        if period_s is None:
            period_s = (
                GlobalConfig.remediation_beat_s
                or GlobalConfig.health_check_period_s
            )
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._beat_loop, args=(period_s,),
            name="remediation-beat", daemon=True,
        )
        self._thread.start()

    def detach(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=10)
        self._thread = None

    @property
    def attached(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    # ---------------------------------------------------------------- report
    def report(self) -> Dict[str, Any]:
        now = time.time()
        with self._lock:
            return {
                "attached": self.attached,
                "beats": self.beats,
                "actions": [a.to_dict() for a in self.actions],
                "totals": dict(self.totals),
                # Expired entries are filtered here too (not only on the
                # beat): a detached controller's — or a KV-published —
                # report must stop saying QUARANTINED once the window
                # has passed, or `cli slo` exits 2 forever.
                "quarantined": {
                    t: dict(e) for t, e in self.quarantined.items()
                    if e["until"] > now
                },
                "policies": sorted(self.policies),
            }


# ------------------------------------------------------------- process-wide
_controller: Optional[RemediationController] = None
_controller_lock = make_lock("remediation.singleton")


def get_remediation_controller(
    create: bool = False, **kwargs
) -> Optional[RemediationController]:
    """The process-wide controller (``cli slo`` / ``/api/slo`` read its
    report).  ``create=True`` builds one on first use."""
    global _controller
    with _controller_lock:
        if _controller is None and create:
            _controller = RemediationController(**kwargs)
        return _controller


def set_remediation_controller(
    controller: Optional[RemediationController],
) -> Optional[RemediationController]:
    """Install (or clear, with None) the process-wide controller;
    returns the previous one.  Chaos tests install purpose-built
    controllers here so the CLI/dashboard surface them."""
    global _controller
    with _controller_lock:
        prev, _controller = _controller, controller
    return prev


def start(period_s: Optional[float] = None,
          **kwargs) -> RemediationController:
    """Build, install, and attach the process-wide controller."""
    controller = RemediationController(**kwargs)
    prev = set_remediation_controller(controller)
    if prev is not None:
        prev.detach()
    controller.attach(period_s)
    return controller


def stop() -> None:
    prev = set_remediation_controller(None)
    if prev is not None:
        prev.detach()


def report_snapshot() -> Optional[Dict[str, Any]]:
    """The local controller's report, or the last KV-published report
    from a controller elsewhere in the cluster (``cli slo`` from a
    different process), or None.  Quarantine entries whose window has
    expired are pruned — a dead controller's stale report must not keep
    paging (exit 2) after the incident window closed."""
    controller = get_remediation_controller()
    if controller is not None:
        return controller.report()
    from ..core.core_worker import try_global_worker

    w = try_global_worker()
    if w is None:
        return None
    try:
        report = w.kv_get("remediation", "report")
    except Exception:  # noqa: BLE001 — no cluster: no remote report
        return None
    if report and report.get("quarantined"):
        now = time.time()
        report["quarantined"] = {
            t: e for t, e in report["quarantined"].items()
            if e.get("until", 0) > now
        }
    return report

"""Serve control plane: controller + replica actors.

Reference architecture (ray ``python/ray/serve/_private/controller.py:107``,
``deployment_state.py``, ``replica.py``, ``autoscaling_state.py``): a
singleton controller actor owns deployment state and runs a reconcile loop
that (a) replaces dead replicas and (b) autoscales replica counts from
queue metrics; replicas wrap the user callable and report queue depth used
by the router's power-of-two-choices.
"""

from __future__ import annotations

import asyncio
import inspect
import logging
import threading
import time
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.core.serialization import loads_function
from ray_tpu_torch.util.debug_locks import make_lock

logger = logging.getLogger(__name__)

CONTROLLER_NAME = "_serve_controller"

_AUTOSCALE_DEFAULTS = {
    "min_replicas": 1,
    "max_replicas": 4,
    "target_ongoing_requests": 2.0,
    "upscale_delay_s": 0.5,
    "downscale_delay_s": 5.0,
    # Recorded-signal threshold (PR-10 per-request telemetry): sustained
    # window-mean queue wait above this upscales even when instantaneous
    # queue-depth probes look calm (queue wait integrates the pressure
    # the probes sample).  None disables the recorded signal.
    "target_queue_wait_s": 1.0,
    # Downscale is drain-then-retire: the replica leaves the routable
    # set immediately, keeps its in-flight work, and is killed when its
    # queue empties — or force-killed after this timeout.
    "drain_timeout_s": 30.0,
}


@ray_tpu_torch.remote
class Replica:
    """Hosts one copy of the user callable."""

    def __init__(self, payload: bytes, init_args, init_kwargs,
                 max_ongoing_requests: int = 16,
                 deployment_name: str = ""):
        import os as _os

        obj = loads_function(payload)
        if isinstance(obj, type):
            self.callable = obj(*init_args, **init_kwargs)
            self._is_class = True
        else:
            self.callable = obj
            self._is_class = False
        self._ongoing = 0
        self._lock = make_lock("serve.replica.stats")
        self._total = 0
        # Per-request serving telemetry identity: TTFT / inter-token /
        # queue-wait histograms are tagged per deployment+replica.
        self._deployment = deployment_name or "anonymous"
        self._replica_tag = _os.urandom(3).hex()
        # User-request concurrency is gated HERE, not by actor-level
        # max_concurrency: system calls (queue_len / health_check) must
        # bypass the user queue or a saturated replica looks dead and its
        # metrics go dark (reference: replica system vs user concurrency).
        self._user_sem = asyncio.Semaphore(max(1, max_ongoing_requests))

    def queue_len(self) -> int:
        return self._ongoing

    def stats(self) -> Dict[str, Any]:
        return {"ongoing": self._ongoing, "total": self._total}

    async def handle_request(self, method: str, args, kwargs,
                             metadata: Optional[dict] = None):
        from . import multiplex
        from ray_tpu_torch.util import flight_recorder, tracing

        t_arrive = time.perf_counter()
        with self._lock:
            # Counts queued + executing — the backlog signal autoscaling
            # and pow-2 routing want.
            self._ongoing += 1
            self._total += 1
        token = None
        if metadata and metadata.get("multiplexed_model_id") is not None:
            token = multiplex._model_id_var.set(
                metadata["multiplexed_model_id"]
            )
        await self._user_sem.acquire()
        queue_wait_s = time.perf_counter() - t_arrive
        outcome = "ok"
        try:
            with tracing.start_span(
                "serve.request",
                {"deployment": self._deployment,
                 "replica": self._replica_tag,
                 "method": method or "__call__"},
            ):
                if self._is_class:
                    target = getattr(self.callable, method or "__call__")
                else:
                    target = self.callable
                if asyncio.iscoroutinefunction(target):
                    result = target(*args, **kwargs)
                else:
                    # Sync callables must NOT run on the replica's event
                    # loop: a blocking call (e.g. composing another
                    # deployment handle's .result()) would deadlock the
                    # loop and trip the worker watchdog.
                    loop = asyncio.get_running_loop()
                    ctx = __import__("contextvars").copy_context()
                    result = await loop.run_in_executor(
                        None, lambda: ctx.run(target, *args, **kwargs)
                    )
                if inspect.iscoroutine(result):
                    # inspect, not asyncio: asyncio.iscoroutine() also
                    # matches plain generators (legacy @coroutine support
                    # on py<=3.11), and awaiting a user generator raises
                    # TypeError.
                    result = await result
                return result
        except BaseException:
            outcome = "error"
            raise
        finally:
            self._user_sem.release()
            try:
                flight_recorder.record_serve_request(
                    self._deployment, self._replica_tag, queue_wait_s,
                    time.perf_counter() - t_arrive, outcome=outcome,
                )
            except Exception:  # raylint: waive[RTL003] telemetry must not corrupt replica accounting
                pass
            if token is not None:
                multiplex._model_id_var.reset(token)
            with self._lock:
                self._ongoing -= 1

    async def handle_request_streaming(self, method: str, args, kwargs,
                                       metadata: Optional[dict] = None):
        """Streaming twin of handle_request: the target must be a generator
        (sync or async); each yielded chunk streams to the caller via the
        core runtime's streaming actor-method path."""
        from . import multiplex
        from ray_tpu_torch.util import flight_recorder, tracing

        t_arrive = time.perf_counter()
        t_wall = time.time()
        with self._lock:
            self._ongoing += 1
            self._total += 1
        token = None
        if metadata and metadata.get("multiplexed_model_id") is not None:
            token = multiplex._model_id_var.set(
                metadata["multiplexed_model_id"]
            )
        await self._user_sem.acquire()
        # Per-chunk cost stays an append; histograms land in one batch at
        # stream end (TTFT + every inter-chunk gap — the inter-token
        # stall distribution the serving SLOs gate on).
        tele = flight_recorder.StreamTelemetry(
            self._deployment, self._replica_tag,
            time.perf_counter() - t_arrive,
        )
        outcome = "ok"
        try:
            if self._is_class:
                target = getattr(self.callable, method or "__call__")
            else:
                target = self.callable
            result = target(*args, **kwargs)
            if inspect.iscoroutine(result):
                # e.g. an async __call__ that returns a generator when the
                # request asked for streaming.  inspect, not asyncio: a
                # SYNC generator target also lands here, and
                # asyncio.iscoroutine() matching it (legacy generator
                # coroutines, py<=3.11) would await-and-TypeError it.
                result = await result
            if hasattr(result, "__aiter__"):
                async for item in result:
                    tele.tick()
                    yield item
            elif hasattr(result, "__iter__"):
                # Sync generator: pull items on a thread so a blocking body
                # can't stall the replica loop.  Copy the context so the
                # multiplexed-model-id contextvar set above is visible
                # inside the generator frames (run_in_executor does not
                # propagate context by itself).
                import contextvars

                ctx = contextvars.copy_context()
                loop = asyncio.get_running_loop()
                sentinel = object()
                it = iter(result)
                while True:
                    item = await loop.run_in_executor(
                        None, lambda: ctx.run(next, it, sentinel)
                    )
                    if item is sentinel:
                        break
                    tele.tick()
                    yield item
            else:
                raise TypeError(
                    f"stream=True requires {method or '__call__'} to be a "
                    f"generator; got {type(result).__name__}"
                )
        except BaseException:
            outcome = "error"
            raise
        finally:
            self._user_sem.release()
            try:
                tele.done(outcome)
                # A completed span per stream (recorded, not opened, so
                # no contextvar crosses the generator's yields); parents
                # to the task:handle_request_streaming span when the
                # call is traced.
                tracing.record_span(
                    "serve.request.stream", t_wall, time.time(),
                    {"deployment": self._deployment,
                     "replica": self._replica_tag,
                     "ttft_s": tele.ttft_s,
                     "chunks": len(tele.gaps) + (1 if tele.ttft_s else 0),
                     "outcome": outcome},
                )
            except Exception:  # raylint: waive[RTL003] telemetry must not corrupt replica accounting
                pass
            if token is not None:
                multiplex._model_id_var.reset(token)
            with self._lock:
                self._ongoing -= 1

    def reconfigure(self, user_config):
        if hasattr(self.callable, "reconfigure"):
            self.callable.reconfigure(user_config)
        return True

    def health_check(self) -> bool:
        if hasattr(self.callable, "check_health"):
            self.callable.check_health()
        return True


@ray_tpu_torch.remote
class ServeController:
    """Singleton named actor owning all deployment state."""

    RECONCILE_PERIOD_S = 0.5

    def __init__(self):
        # name -> {"spec": {...}, "replicas": [handles], "version": str, ...}
        self.deployments: Dict[str, dict] = {}
        self._lock = make_lock("serve.controller.state")
        self._stop = threading.Event()
        # Long-poll host state (reference LongPollHost, serve/_private/
        # long_poll.py:252): per-key monotonically-increasing snapshot ids;
        # listeners block in listen_for_change until a key advances.
        # Mutations happen on actor calls AND the reconcile thread, so the
        # snapshot table is lock-guarded and waiters are asyncio events
        # woken via their owning loop.
        self._lp_lock = make_lock("serve.controller.long_poll")
        self._lp_snapshots: Dict[tuple, tuple] = {}  # key -> (id, value)
        self._lp_waiters: list = []  # [(loop, asyncio.Event)]
        # Recorded-signal state for autoscaling: a rate-limited snapshot
        # of the merged serving histograms, the per-deployment
        # (count, sum) watermark for window-delta queue-wait means, and
        # the last computed window mean (held between refreshes — the
        # snapshot TTL exceeds the reconcile period, and a None on
        # cached cycles would reset the sustain timer every round,
        # making the recorded signal unable to survive upscale_delay_s).
        self._serving_cache: Dict[str, Any] = {"ts": 0.0, "stats": {}}
        self._qw_prev: Dict[str, tuple] = {}
        self._qw_window: Dict[str, Optional[float]] = {}
        self._reconciler = threading.Thread(
            target=self._reconcile_loop, daemon=True, name="serve-reconcile"
        )
        self._reconciler.start()

    # ----------------------------------------------------------- long poll
    def _publish(self, key: tuple, value) -> None:
        with self._lp_lock:
            next_id = self._lp_snapshots.get(key, (0, None))[0] + 1
            self._lp_snapshots[key] = (next_id, value)
            waiters, self._lp_waiters = self._lp_waiters, []
        for loop, ev in waiters:
            try:
                loop.call_soon_threadsafe(ev.set)
            except RuntimeError:
                pass  # loop gone (shutdown)

    def _publish_state(self, name: Optional[str] = None) -> None:
        """Push the current replica list (for ``name``) and route table."""
        if name is not None:
            entry = self.deployments.get(name)
            self._publish(
                ("replicas", name),
                list(entry["replicas"]) if entry is not None else [],
            )
        self._publish(("routes",), self.get_routes())

    async def listen_for_change(
        self, keys_to_ids: Dict[tuple, int], timeout_s: float = 30.0
    ) -> Dict[tuple, tuple]:
        """Block until any subscribed key's snapshot id exceeds the
        client's, then return every advanced key's (id, snapshot).  Returns
        {} on timeout (client re-issues)."""
        import asyncio

        keys_to_ids = {tuple(k): v for k, v in keys_to_ids.items()}
        deadline = time.monotonic() + timeout_s
        while True:
            with self._lp_lock:
                updates = {
                    k: self._lp_snapshots[k]
                    for k, i in keys_to_ids.items()
                    if k in self._lp_snapshots and self._lp_snapshots[k][0] > i
                }
                if updates:
                    return updates
                ev = asyncio.Event()
                self._lp_waiters.append((asyncio.get_running_loop(), ev))
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                with self._lp_lock:
                    self._lp_waiters = [
                        w for w in self._lp_waiters if w[1] is not ev
                    ]
                return {}
            try:
                await asyncio.wait_for(ev.wait(), remaining)
            except asyncio.TimeoutError:
                # Drop our waiter: timed-out listens must not accrete in
                # the host's waiter list on an idle cluster.
                with self._lp_lock:
                    self._lp_waiters = [
                        w for w in self._lp_waiters if w[1] is not ev
                    ]
                return {}

    # ------------------------------------------------------------- deploy API
    def deploy(self, name: str, payload: bytes, init_args, init_kwargs,
               num_replicas: int, ray_actor_options: dict, version: str,
               max_ongoing_requests: int, route_prefix,
               autoscaling_config: Optional[dict] = None):
        with self._lock:
            entry = self.deployments.get(name)
            if entry is not None and entry["version"] != version:
                # Versioned update: replace replicas in place.
                for h in entry["replicas"]:
                    self._kill(h)
                for h, _t0 in entry.get("draining", []):
                    self._kill(h)
                entry = None
            if entry is None:
                entry = {"replicas": [], "version": version}
            opts = dict(ray_actor_options or {})
            # Actor-level concurrency must never be the user-request gate:
            # queued handle_request coroutines waiting on _user_sem hold
            # actor slots, and system calls (queue_len/health_check) need a
            # slot immediately even when the replica is saturated.  So the
            # actor runs effectively unbounded and _user_sem alone caps
            # concurrent user work.
            opts.setdefault("max_concurrency", 1000)
            entry["spec"] = {
                "name": name,
                "payload": payload,
                "init_args": init_args,
                "init_kwargs": init_kwargs,
                "opts": opts,
                "max_ongoing_requests": max_ongoing_requests,
            }
            entry["version"] = version
            # Normalize once at registration ('/v1/' == '/v1'); the proxy
            # does prefix matching against these keys.
            prefix = route_prefix or f"/{name}"
            entry["route_prefix"] = "/" + prefix.strip("/")
            entry["max_ongoing_requests"] = max_ongoing_requests
            if autoscaling_config is not None:
                entry["autoscaling"] = dict(
                    _AUTOSCALE_DEFAULTS, **autoscaling_config
                )
                num_replicas = max(
                    entry["autoscaling"]["min_replicas"],
                    min(num_replicas, entry["autoscaling"]["max_replicas"]),
                )
            else:
                entry.pop("autoscaling", None)
            entry["last_scale_ts"] = time.monotonic()
            entry["scale_pressure_since"] = None
            entry.setdefault("draining", [])  # [(handle, drain_start_ts)]
            self._set_replica_count(entry, num_replicas)
            self.deployments[name] = entry
            self._publish_state(name)
            return {"name": name, "num_replicas": len(entry["replicas"])}

    def _spawn_replica(self, entry: dict):
        spec = entry["spec"]
        return Replica.options(**spec["opts"]).remote(
            spec["payload"],
            spec["init_args"],
            spec["init_kwargs"],
            spec.get("max_ongoing_requests", 16),
            spec.get("name", ""),
        )

    def _set_replica_count(self, entry: dict, n: int,
                           drain: bool = False) -> None:
        current = len(entry["replicas"])
        if n > current:
            for _ in range(n - current):
                entry["replicas"].append(self._spawn_replica(entry))
        elif n < current:
            surplus = entry["replicas"][n:]
            entry["replicas"] = entry["replicas"][:n]
            if drain:
                # Drain-then-retire: out of the routable set now, killed
                # by _reap_draining once the queue empties (autoscale
                # downscales must not drop in-flight requests).
                now = time.monotonic()
                entry.setdefault("draining", []).extend(
                    (h, now) for h in surplus
                )
            else:
                for h in surplus:
                    self._kill(h)

    @staticmethod
    def _kill(handle) -> None:
        try:
            ray_tpu_torch.kill(handle)
        except Exception as e:
            logger.debug("replica kill failed: %s", e)

    # --------------------------------------------------------- reconcile loop
    def _reconcile_loop(self):
        while not self._stop.wait(self.RECONCILE_PERIOD_S):
            try:
                self._reconcile_once()
            except Exception as e:  # noqa: BLE001
                logger.warning("serve reconcile round failed: %s", e)

    def _reconcile_once(self):
        with self._lock:
            entries = list(self.deployments.items())
        for name, entry in entries:
            self._replace_dead_replicas(name, entry)
            if "autoscaling" in entry:
                self._autoscale(name, entry)
            if entry.get("draining"):
                self._reap_draining(name, entry)

    # ---------------------------------------------- recorded queue-wait
    def _recorded_queue_wait(self, name: str) -> Optional[float]:
        """Window-delta mean of the recorded per-request queue-wait
        histogram for deployment ``name`` (the PR-10 serving telemetry) —
        the autoscaler's second signal next to instantaneous queue-depth
        probes.  Returns None when no new samples landed this window or
        the merged registry is unreachable."""
        now = time.monotonic()
        if now - self._serving_cache["ts"] > 2.0:
            try:
                from ray_tpu_torch.util import obs

                self._serving_cache["stats"] = obs.serving_stats()
                self._serving_cache["ts"] = now
            except Exception as e:  # noqa: BLE001 — probes still autoscale
                logger.debug("serving-stats pull failed: %s", e)
                return self._qw_window.get(name)
            # Fresh snapshot: advance the watermark and recompute the
            # window mean for EVERY deployment in sight — only one
            # deployment's call triggers each refresh, and recomputing
            # just that one would leave the siblings' windows frozen
            # (None forever, or stuck at a stale high value that blocks
            # their downscale).  An idle window clears the value.
            stats = self._serving_cache["stats"]
            for dep in set(stats) | set(self._qw_prev):
                row = (stats.get(dep) or {}).get("queue_wait")
                if not row or not row.get("count"):
                    self._qw_window[dep] = None
                    continue
                count = row["count"]
                total = row.get("mean_s", 0.0) * count
                prev_count, prev_total = self._qw_prev.get(dep, (0, 0.0))
                self._qw_prev[dep] = (count, total)
                self._qw_window[dep] = (
                    (total - prev_total) / (count - prev_count)
                    if count > prev_count else None
                )
        # Held between refreshes so sustained pressure can out-live the
        # snapshot TTL and actually reach upscale_delay_s.
        return self._qw_window.get(name)

    def _reap_draining(self, name: str, entry: dict):
        """Retire draining replicas whose queues emptied; force-kill past
        the drain timeout.  Runs on the reconcile thread."""
        from ray_tpu_torch.util import flight_recorder

        cfg = entry.get("autoscaling") or {}
        timeout = cfg.get("drain_timeout_s",
                          _AUTOSCALE_DEFAULTS["drain_timeout_s"])
        now = time.monotonic()
        keep = []
        events = []
        for h, t0 in list(entry.get("draining", [])):
            try:
                qlen = ray_tpu_torch.get(h.queue_len.remote(), timeout=5)
            except Exception:  # noqa: BLE001 — dead already: reap it
                qlen = 0
            if qlen <= 0:
                self._kill(h)
                events.append("drain_retired")
            elif now - t0 > timeout:
                logger.warning(
                    "deployment %s: force-killing draining replica with %d "
                    "requests still queued after %.0fs", name, qlen, timeout,
                )
                self._kill(h)
                events.append("drain_forced")
            else:
                keep.append((h, t0))
        with self._lock:
            if self.deployments.get(name) is not entry:
                return
            entry["draining"] = keep
        for direction in events:
            flight_recorder.record_serve_autoscale(
                name, direction, len(entry["replicas"]) + len(keep)
            )

    def _replace_dead_replicas(self, name: str, entry: dict):
        """Health check every replica; respawn the dead (reference:
        DeploymentState reconciling target vs. actual).  Checks are issued
        concurrently up-front; each replica then gets an INDEPENDENT
        ``serve_health_check_timeout_s`` budget measured from its own
        await — one stuck replica consuming its full window must not
        starve later replicas down to a floor where a merely-slow-but-
        healthy co-deployed replica accumulates spurious strikes and gets
        replaced (worst-case sweep time is n_stuck x timeout, which the
        consecutive-failure threshold already bounds in practice).
        Respawn revalidates the entry under the lock — deploy()/delete()
        may have replaced it while the (slow) checks ran."""
        from ray_tpu_torch.core.config import GlobalConfig

        replicas = list(entry["replicas"])
        refs = [(h, h.health_check.remote()) for h in replicas]
        per_replica_timeout = GlobalConfig.serve_health_check_timeout_s
        fails = entry.setdefault("_health_fails", {})
        # Keyed by the STABLE actor id, and pruned to live replicas each
        # sweep: an id(handle) key would leak strikes across downscales,
        # and CPython id() reuse could charge a fresh replica with a dead
        # predecessor's count — killing it on its first slow (tolerated)
        # health check.
        live = {h._actor_id.hex() for h in replicas}
        for key in [k for k in fails if k not in live]:
            del fails[key]
        dead = []
        for h, ref in refs:
            hid = h._actor_id.hex()
            try:
                ray_tpu_torch.get(ref, timeout=per_replica_timeout)
                fails.pop(hid, None)
            except Exception as e:  # noqa: BLE001
                # Tolerate consecutive timeouts before replacing
                # (reference: serve replica health uses a 30s+ budget):
                # a replica compiling its first jax program holds the GIL
                # for tens of seconds — busy-but-alive, and killing it
                # fails the very request that triggered the compile.  An
                # actor that is actually DEAD fails fast (dead-actor
                # error), not by timeout — replace it immediately.
                from ray_tpu_torch.core.exceptions import GetTimeoutError

                if isinstance(e, GetTimeoutError):
                    n = fails.get(hid, 0) + 1
                    fails[hid] = n
                    if n < GlobalConfig.serve_health_failure_threshold:
                        continue
                dead.append(h)
                fails.pop(hid, None)
        if not dead:
            return
        with self._lock:
            if self.deployments.get(name) is not entry:
                return  # entry was redeployed/deleted while we checked
            for h in dead:
                try:
                    idx = entry["replicas"].index(h)
                except ValueError:
                    continue  # already scaled away
                logger.warning(
                    "deployment %s replica %d unhealthy; replacing", name, idx
                )
                self._kill(h)
                entry["replicas"][idx] = self._spawn_replica(entry)
            self._publish_state(name)

    def _autoscale(self, name: str, entry: dict):
        """Scale replica counts from TWO signals: instantaneous queue-
        depth probes (reference pow-2 metric) and the recorded window-mean
        queue wait (PR-10 per-request histograms — pressure the probes
        can sample past).  Up on sustained pressure from either; down via
        drain-then-retire on sustained starvation."""
        from ray_tpu_torch.util import flight_recorder

        cfg = entry["autoscaling"]
        replicas = entry["replicas"]
        if not replicas:
            return
        try:
            queue_lens = ray_tpu_torch.get(
                [h.queue_len.remote() for h in replicas], timeout=5
            )
        except Exception:  # noqa: BLE001 — dead replicas handled above
            return
        per_replica = sum(queue_lens) / len(replicas)
        target = cfg["target_ongoing_requests"]
        qw_target = cfg.get("target_queue_wait_s")
        qw_mean = (
            self._recorded_queue_wait(name) if qw_target is not None else None
        )
        qw_pressure = qw_mean is not None and qw_mean > qw_target
        now = time.monotonic()
        desired = None
        direction = None
        if (per_replica > target or qw_pressure) and (
            len(replicas) < cfg["max_replicas"]
        ):
            if entry["scale_pressure_since"] is None:
                entry["scale_pressure_since"] = now
            if now - entry["scale_pressure_since"] >= cfg["upscale_delay_s"]:
                desired = min(
                    cfg["max_replicas"],
                    max(
                        len(replicas) + 1,
                        int(len(replicas) * per_replica / target),
                    ),
                )
                direction = "up"
        elif (
            per_replica < target * 0.5
            and not qw_pressure
            and len(replicas) > cfg["min_replicas"]
        ):
            if entry["scale_pressure_since"] is None:
                entry["scale_pressure_since"] = now
            if now - entry["scale_pressure_since"] >= cfg["downscale_delay_s"]:
                desired = max(cfg["min_replicas"], len(replicas) - 1)
                direction = "down"
        else:
            entry["scale_pressure_since"] = None
        if desired is not None and desired != len(replicas):
            logger.info(
                "autoscaling %s: %d -> %d (avg ongoing %.2f, target %.2f, "
                "queue-wait window mean %s)",
                name, len(replicas), desired, per_replica, target,
                f"{qw_mean:.3f}s" if qw_mean is not None else "n/a",
            )
            with self._lock:
                if self.deployments.get(name) is not entry:
                    return
                self._set_replica_count(entry, desired,
                                        drain=direction == "down")
                entry["scale_pressure_since"] = None
                entry["last_scale_ts"] = now
                self._publish_state(name)
                total = len(entry["replicas"]) + len(entry.get("draining", []))
            flight_recorder.record_serve_autoscale(name, direction, total)

    def remediation_scale_up(self, name: str) -> Dict[str, Any]:
        """SLO-remediation nudge: one replica up through the same
        bookkeeping the reconcile-loop autoscaler uses (max_replicas
        clamp, pressure-timer reset, state publish, autoscale-event
        recording) — the remediation controller's queue-pressure
        actuator.  Idempotent at the max: declines instead of
        overshooting, so a finding re-delivered every beat cannot grow
        the fleet past the deployment's own bound."""
        from ray_tpu_torch.util import flight_recorder

        with self._lock:
            entry = self.deployments.get(name)
            if entry is None:
                return {"scaled": False, "reason": f"unknown deployment {name!r}"}
            cfg = entry.get("autoscaling") or _AUTOSCALE_DEFAULTS
            current = len(entry["replicas"])
            if current >= cfg["max_replicas"]:
                # The decline carries the replica resource shape so the
                # remediation controller's fair-share fallback knows what
                # bundle to free (preempt low-priority training) instead
                # of just giving up — see util/remediation.py.
                opts = (entry.get("spec") or {}).get("opts") or {}
                return {"scaled": False, "replicas": current,
                        "reason": f"at max_replicas={cfg['max_replicas']}",
                        "replica_resources": dict(
                            opts.get("resources") or {"CPU": 1.0}
                        )}
            self._set_replica_count(entry, current + 1)
            entry["scale_pressure_since"] = None
            entry["last_scale_ts"] = time.monotonic()
            self._publish_state(name)
            total = len(entry["replicas"]) + len(entry.get("draining", []))
        flight_recorder.record_serve_autoscale(name, "up", total)
        logger.info(
            "remediation scale-up: deployment %s %d -> %d replicas",
            name, current, current + 1,
        )
        return {"scaled": True, "replicas": current + 1}

    # -------------------------------------------------------------- query API
    def get_replicas(self, name: str) -> List:
        entry = self.deployments.get(name)
        if entry is None:
            raise KeyError(f"deployment {name!r} not found")
        return list(entry["replicas"])

    def get_routes(self) -> Dict[str, str]:
        return {
            e["route_prefix"]: name for name, e in self.deployments.items()
        }

    def delete_deployment(self, name: str) -> bool:
        with self._lock:
            entry = self.deployments.pop(name, None)
            if entry is None:
                return False
            for h in entry["replicas"]:
                self._kill(h)
            for h, _t0 in entry.get("draining", []):
                self._kill(h)
            self._publish_state(name)
            return True

    def status(self) -> Dict[str, Any]:
        return {
            name: {
                "num_replicas": len(e["replicas"]),
                "num_draining": len(e.get("draining", [])),
                "version": e["version"],
                "route_prefix": e["route_prefix"],
                "autoscaling": e.get("autoscaling"),
            }
            for name, e in self.deployments.items()
        }

    def list_deployments(self) -> List[str]:
        return list(self.deployments)

"""Dashboard: live HTML UI + cluster state + metrics over HTTP.

Role-equivalent of the reference dashboard (ray ``python/ray/dashboard/``:
the head process aggregating state + the metrics pipeline to Prometheus),
with a single-file HTML frontend (``dashboard_ui.py``) instead of the
TypeScript app.  Endpoints:

    GET /                    live dashboard UI (auto-refreshing tables)
    GET /api                 endpoint index
    GET /api/cluster         resource + actor/job summary
    GET /api/nodes|actors|tasks|jobs|placement_groups
    GET /api/timeline        Chrome-trace events
    GET /metrics             Prometheus exposition (ray.util.metrics analog)
"""

from __future__ import annotations

import asyncio
import json
import logging
import threading
from typing import Any, Dict, Optional

logger = logging.getLogger(__name__)

_state: Dict[str, Any] = {}


def start_dashboard(
    host: str = "127.0.0.1", port: int = 8265, address: Optional[str] = None
) -> str:
    """Start the dashboard HTTP server (connects a driver if needed)."""
    import ray_tpu_torch
    from aiohttp import web

    if _state:
        # Only one dashboard per process; replace the previous instance
        # instead of orphaning its loop/thread/socket.
        stop_dashboard()
    if not ray_tpu_torch.is_initialized():
        ray_tpu_torch.init(address=address or "auto")

    from .core.config import GlobalConfig

    if GlobalConfig.enable_remediation:
        # Self-healing opt-in: attach the process-wide remediation
        # controller to the aggregation beat (util/remediation.py).
        from .util import remediation as remediation_mod

        if remediation_mod.get_remediation_controller() is None:
            remediation_mod.start()

    from .util.state import api as state_api
    from .util.state.api import StateApiClient, chrome_trace_events

    client = StateApiClient()

    def _json(data, status=200):
        return web.json_response(
            json.loads(json.dumps(data, default=str)), status=status
        )

    async def run_sync(fn, *args, **kw):
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(None, lambda: fn(*args, **kw))

    async def index(request):
        from .dashboard_ui import INDEX_HTML

        return web.Response(text=INDEX_HTML, content_type="text/html")

    async def api_index(request):
        return _json(
            {
                "endpoints": [
                    "/api/cluster", "/api/nodes", "/api/actors",
                    "/api/tasks", "/api/jobs", "/api/placement_groups",
                    "/api/timeline", "/api/timeline?cluster=1",
                    "/api/task_phases", "/api/slo", "/metrics",
                ]
            }
        )

    async def cluster(request):
        state = await run_sync(client.get_state)
        alive = [n for n in state["nodes"].values() if n["alive"]]
        total: Dict[str, float] = {}
        avail: Dict[str, float] = {}
        for info in alive:
            for k, v in info["snapshot"]["total"].items():
                total[k] = total.get(k, 0) + v
            for k, v in info["snapshot"]["available"].items():
                avail[k] = avail.get(k, 0) + v
        actors: Dict[str, int] = {}
        for a in state["actors"]:
            actors[a["state"]] = actors.get(a["state"], 0) + 1
        return _json(
            {
                "nodes_alive": len(alive),
                "nodes_total": len(state["nodes"]),
                "resources_total": total,
                "resources_available": avail,
                "actors_by_state": actors,
                "jobs_running": sum(
                    1 for j in state["jobs"].values()
                    if j["state"] == "RUNNING"
                ),
                # Per-job arbitration state (priority, quota, charged
                # usage, admission-queued counts) — who is starving whom.
                "scheduling": state.get("scheduling", {}),
                # Control-plane HA: role, lease epoch, journal stats and
                # per-standby replication lag (see docs/ha.md).
                "cp": state.get("cp", {}),
                # Elastic capacity: the autoscaler's per-round status blob
                # (last decision, pending demand, per-type counts/backoff,
                # in-flight drains — see docs/elastic.md).
                "autoscaler": state.get("autoscaler", {}),
                "nodes_draining": sum(
                    1 for n in alive if n.get("draining")
                ),
            }
        )

    async def nodes(request):
        return _json(await run_sync(state_api.list_nodes))

    async def actors(request):
        return _json(await run_sync(state_api.list_actors))

    async def tasks(request):
        limit = int(request.query.get("limit", "1000"))
        filters = None
        if "name" in request.query:
            filters = {"name": request.query["name"]}
        return _json(
            await run_sync(state_api.list_tasks, None, filters, limit)
        )

    async def jobs(request):
        """Driver jobs (cluster state) + submission jobs (REST-managed)
        in one listing: driver jobs carry ``job_id``, submissions carry
        ``submission_id`` — the client filters by the field it knows."""
        driver_jobs = await run_sync(state_api.list_jobs)
        try:
            subs = await run_sync(
                lambda: [j.__dict__ for j in _job_client().list_jobs()]
            )
        except Exception:  # noqa: BLE001 — submissions list is best-effort
            subs = []
        return _json(driver_jobs + subs)

    # ---- REST job submission (reference: dashboard/modules/job/
    # job_manager.py:61 + sdk.py:36 — JobSubmissionClient speaks HTTP to
    # the dashboard; the implementation behind the endpoint is the
    # supervisor-actor machinery in ray_tpu_torch.job).
    def _job_client():
        from .job.sdk import JobSubmissionClient

        return JobSubmissionClient()

    async def submit_job(request):
        body = await request.json()
        if "entrypoint" not in body:
            return _json({"error": "entrypoint required"}, status=400)
        try:
            sid = await run_sync(
                lambda: _job_client().submit_job(
                    entrypoint=body["entrypoint"],
                    submission_id=body.get("submission_id"),
                    runtime_env=body.get("runtime_env"),
                    metadata=body.get("metadata"),
                )
            )
        except ValueError as e:
            return _json({"error": str(e)}, status=409)
        except Exception as e:  # noqa: BLE001
            return _json({"error": str(e)}, status=500)
        return _json({"submission_id": sid})

    async def job_info(request):
        sid = request.match_info["sid"]
        info = await run_sync(lambda: _job_client().get_job_info(sid))
        if info is None:
            return _json({"error": f"no job {sid}"}, status=404)
        return _json(info.__dict__)

    async def job_logs(request):
        sid = request.match_info["sid"]
        text = await run_sync(lambda: _job_client().get_job_logs(sid))
        return _json({"logs": text})

    async def job_stop(request):
        sid = request.match_info["sid"]
        ok = await run_sync(lambda: _job_client().stop_job(sid))
        return _json({"stopped": bool(ok)})

    async def job_delete(request):
        sid = request.match_info["sid"]
        try:
            ok = await run_sync(lambda: _job_client().delete_job(sid))
        except RuntimeError as e:
            return _json({"error": str(e)}, status=400)
        return _json({"deleted": bool(ok)})

    async def pgs(request):
        return _json(await run_sync(state_api.list_placement_groups))

    async def timeline(request):
        if request.query.get("cluster", "") not in ("", "0", "false"):
            # Cluster-merged Chrome trace: spans from every process,
            # cross-process flow links, explicit truncation metadata.
            from .util import obs

            return _json(await run_sync(obs.cluster_timeline))
        reply = await run_sync(client.list_task_events, None, 100000)
        return _json(chrome_trace_events(reply))

    async def task_phases(request):
        """Flight-recorder phase percentiles (queue wait, arg resolution,
        execute, return-put, backpressure wait)."""
        return _json(await run_sync(state_api.summarize_task_phases))

    async def slo(request):
        """SLO/anomaly engine findings over the aggregated stream (one
        process-wide engine: rate/sustain rules accumulate state across
        requests), plus the remediation controller's actions/quarantine
        state when one is running (here or elsewhere in the cluster)."""
        from .util import remediation as remediation_mod
        from .util.slo import get_slo_engine

        engine = get_slo_engine()
        await run_sync(engine.evaluate)
        report = engine.report()
        rem = await run_sync(remediation_mod.report_snapshot)
        if rem is not None:
            report["remediation"] = rem
        return _json(report)

    async def metrics(request):
        from .util import metrics as metrics_mod

        text = await run_sync(metrics_mod.prometheus_text)
        return web.Response(text=text, content_type="text/plain")

    app = web.Application()
    app.router.add_get("/", index)
    app.router.add_get("/api", api_index)
    app.router.add_get("/api/cluster", cluster)
    app.router.add_get("/api/nodes", nodes)
    app.router.add_get("/api/actors", actors)
    app.router.add_get("/api/tasks", tasks)
    app.router.add_get("/api/jobs", jobs)
    app.router.add_post("/api/jobs", submit_job)
    app.router.add_get("/api/jobs/{sid}", job_info)
    app.router.add_get("/api/jobs/{sid}/logs", job_logs)
    app.router.add_post("/api/jobs/{sid}/stop", job_stop)
    app.router.add_delete("/api/jobs/{sid}", job_delete)
    app.router.add_get("/api/placement_groups", pgs)
    app.router.add_get("/api/timeline", timeline)
    app.router.add_get("/api/task_phases", task_phases)
    app.router.add_get("/api/slo", slo)
    app.router.add_get("/metrics", metrics)

    loop = asyncio.new_event_loop()
    started = threading.Event()
    runner_box: Dict[str, Any] = {}

    def serve_forever():
        asyncio.set_event_loop(loop)
        runner = web.AppRunner(app)
        loop.run_until_complete(runner.setup())
        site = web.TCPSite(runner, host, port)
        loop.run_until_complete(site.start())
        runner_box["runner"] = runner
        started.set()
        loop.run_forever()

    t = threading.Thread(target=serve_forever, daemon=True,
                         name="rtpu-dashboard")
    t.start()
    if not started.wait(timeout=10):
        raise RuntimeError("dashboard failed to start")
    _state.update(loop=loop, thread=t, runner=runner_box.get("runner"))
    return f"http://{host}:{port}"


def stop_dashboard() -> None:
    loop = _state.get("loop")
    runner = _state.get("runner")
    if loop is None:
        return
    if runner is not None:
        # Release the listening socket before stopping the loop, else a
        # restart on the same port hits address-in-use until GC.
        fut = asyncio.run_coroutine_threadsafe(runner.cleanup(), loop)
        try:
            fut.result(timeout=5)
        except Exception as e:
            # Socket release is best-effort; a restart on this port may
            # hit address-in-use until GC, so leave a trail.
            logger.warning("dashboard runner cleanup failed: %s", e)
    loop.call_soon_threadsafe(loop.stop)
    _state.clear()

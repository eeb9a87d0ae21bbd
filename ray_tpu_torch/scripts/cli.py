"""``ray-tpu-torch`` CLI: start/stop nodes, inspect cluster state, manage jobs.

Role-equivalent of the reference's click CLI (ray
``python/ray/scripts/scripts.py``: ``ray start:682``, ``ray stop:1225``,
``ray status``) plus the state CLI (``ray list/get/summary``, ray
``python/ray/util/state/state_cli.py``) and ``ray timeline``
(``scripts.py:241``).  Invokable as ``python -m ray_tpu_torch <cmd>``.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time
from typing import List, Optional


def _fmt_table(rows: List[dict], columns: List[str]) -> str:
    if not rows:
        return "(none)"
    widths = {c: len(c) for c in columns}
    str_rows = []
    for row in rows:
        sr = {c: str(row.get(c, "")) for c in columns}
        str_rows.append(sr)
        for c in columns:
            widths[c] = max(widths[c], len(sr[c]))
    lines = ["  ".join(c.ljust(widths[c]) for c in columns)]
    lines.append("  ".join("-" * widths[c] for c in columns))
    for sr in str_rows:
        lines.append("  ".join(sr[c].ljust(widths[c]) for c in columns))
    return "\n".join(lines)


def _parse_filters(pairs: Optional[List[str]]) -> Optional[dict]:
    if not pairs:
        return None
    out = {}
    for pair in pairs:
        if "=" not in pair:
            raise SystemExit(f"--filter expects key=value, got {pair!r}")
        k, v = pair.split("=", 1)
        out[k] = v
    return out


# ------------------------------------------------------------------ commands
def cmd_start(args) -> int:
    from ..core import node as node_mod

    resources = json.loads(args.resources) if args.resources else None
    labels = json.loads(args.labels) if args.labels else None
    if args.head:
        node = node_mod.Node(
            head=True,
            resources=resources,
            labels=labels,
            num_cpus=args.num_cpus,
            port=args.port,
        )
        node.start()
        print(f"head started: control plane at {node.cp_address}")
        print(f"session: {node.session_id}")
        print(f"logs: {node.log_dir}")
        print("join workers with:\n"
              f"  ray-tpu-torch start --address={node.cp_address}")
    else:
        if not args.address:
            raise SystemExit("worker start requires --address=<head host:port>")
        # Adopt the local head's session only when actually joining THAT
        # head — a stale/foreign head_info.json must not alias shm arenas.
        info = node_mod.read_head_info()
        if info and info.get("cp_address") == args.address:
            session = info["session_id"]
        else:
            session = "remote-" + args.address.replace(":", "-")
        node = node_mod.Node(
            head=False,
            cp_address=args.address,
            resources=resources,
            labels=labels,
            session_id=session,
            num_cpus=args.num_cpus,
        )
        node.start()
        print(f"node started, joined {args.address}")
        print(f"logs: {node.log_dir}")
    if args.block:
        try:
            while all(p.poll() is None for p in node.pg.procs):
                time.sleep(1)
            print("a system process exited; shutting node down", file=sys.stderr)
            node.stop()
            return 1
        except KeyboardInterrupt:
            node.stop()
    return 0


def _iter_ray_tpu_pids():
    """Find local ray_tpu_torch system processes by /proc cmdline scan."""
    markers = (
        "ray_tpu_torch.core.control_plane",
        "ray_tpu_torch.core.node_agent",
        "ray_tpu_torch.core.worker_main",
    )
    for pid_dir in os.listdir("/proc"):
        if not pid_dir.isdigit():
            continue
        pid = int(pid_dir)
        if pid == os.getpid():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmdline = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:
            continue
        if any(m in cmdline for m in markers):
            yield pid, cmdline


def cmd_stop(args) -> int:
    found = list(_iter_ray_tpu_pids())
    for pid, cmdline in found:
        try:
            os.kill(pid, signal.SIGTERM)
            if args.verbose:
                print(f"SIGTERM {pid}: {cmdline[:90]}")
        except OSError:
            pass
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and list(_iter_ray_tpu_pids()):
        time.sleep(0.2)
    for pid, _ in _iter_ray_tpu_pids():
        try:
            os.kill(pid, signal.SIGKILL)
        except OSError:
            pass
    print(f"stopped {len(found)} process(es)")
    from ..core.node import _HEAD_INFO_FILE

    try:
        os.remove(_HEAD_INFO_FILE)
    except OSError:
        pass
    return 0


def cmd_status(args) -> int:
    from ..util.state.api import StateApiClient

    client = StateApiClient(args.address)
    state = client.get_state()
    nodes = state["nodes"]
    alive = [n for n in nodes.values() if n["alive"]]
    cp = state.get("cp") or {}
    if cp.get("ha"):
        journal = cp.get("journal") or {}
        line = (f"control plane: role={cp.get('role', '?')} "
                f"epoch={cp.get('epoch', 0)}")
        if journal:
            line += (f" journal-seq={journal.get('applied_seq', 0)}"
                     f" records={journal.get('records_written', 0)}")
        print(line)
        for sb in cp.get("standbys") or []:
            print(f"  standby {sb.get('holder', '?')} "
                  f"lag={sb.get('lag_records', '?')} records")
    draining = [n for n in alive if n.get("draining")]
    line = f"nodes: {len(alive)} alive / {len(nodes)} total"
    if draining:
        line += f" ({len(draining)} draining)"
    print(line)
    total, avail = {}, {}
    for info in alive:
        for k, v in info["snapshot"]["total"].items():
            total[k] = total.get(k, 0) + v
        for k, v in info["snapshot"]["available"].items():
            avail[k] = avail.get(k, 0) + v
    print("resources:")
    for k in sorted(total):
        print(f"  {avail.get(k, 0):g}/{total[k]:g} {k}")
    actors = state["actors"]
    by_state = {}
    for a in actors:
        by_state[a["state"]] = by_state.get(a["state"], 0) + 1
    if actors:
        print(f"actors: " + ", ".join(f"{v} {k}" for k, v in sorted(by_state.items())))
    jobs = [j for j in state["jobs"].values() if j["state"] == "RUNNING"]
    print(f"jobs running: {len(jobs)}")
    sched = state.get("scheduling") or {}
    if sched:
        # Who is starving whom: per-job priority, quota caps, charged
        # usage, and how much demand admission is currently holding back.
        print("scheduling (per job):")
        for job_hex, row in sched.items():
            quota = ",".join(
                f"{k}={v:g}" for k, v in sorted(row["quota"].items())
            ) or "unlimited"
            usage = ",".join(
                f"{k}={v:g}" for k, v in sorted(row["usage"].items())
                if v > 1e-9
            ) or "-"
            line = (f"  {job_hex[:12]} priority={row['priority']} "
                    f"quota={quota} in-use={usage} "
                    f"queued={row['queued_now']} "
                    f"(ever {row['queued_total']})")
            if row.get("quarantined_until", 0.0) > 0.0:
                line += " [preemption-quarantined]"
            print(line)
    autoscaler = state.get("autoscaler") or {}
    if autoscaler:
        # The panel the autoscaler publishes to cluster KV each round:
        # last decision, pending demand, per-type counts/backoff, drains.
        last = autoscaler.get("last_decision") or {}
        launch = ",".join(
            f"{t}+{n}" for t, n in (last.get("to_launch") or {}).items()
        ) or "-"
        print("autoscaler:")
        print(f"  last decision: launch={launch} "
              f"terminate={len(last.get('to_terminate') or [])} "
              f"infeasible={last.get('infeasible', 0)}")
        demand = autoscaler.get("pending_demand") or {}
        if demand.get("count"):
            shape = ",".join(
                f"{k}={v:g}"
                for k, v in sorted((demand.get("resources") or {}).items())
            )
            print(f"  pending demand: {demand['count']} bundles ({shape})")
        for tname, row in sorted(
            (autoscaler.get("node_types") or {}).items()
        ):
            line = f"  {tname}: {row.get('count', 0)} node(s)"
            if row.get("launch_failures"):
                line += (f" [{row['launch_failures']} launch failure(s), "
                         f"retry in {row.get('backoff_remaining_s', 0):g}s]")
            print(line)
        for d in autoscaler.get("draining") or []:
            print(f"  draining {d.get('provider_id')} "
                  f"({d.get('cause', '?')}, {d.get('age_s', 0):g}s)")
    return 0


def cmd_list(args) -> int:
    from ..util.state import api as state_api

    filters = _parse_filters(args.filter)
    kind = args.kind.replace("-", "_")
    if kind == "nodes":
        rows = state_api.list_nodes(args.address)
        cols = ["node_id", "alive", "total", "available"]
    elif kind == "actors":
        rows = state_api.list_actors(args.address, filters)
        cols = ["actor_id", "name", "state", "incarnation", "death_cause"]
    elif kind == "tasks":
        rows = state_api.list_tasks(args.address, filters, args.limit)
        cols = ["task_id", "name", "state", "attempt", "node_id", "error"]
    elif kind == "jobs":
        rows = state_api.list_jobs(args.address)
        cols = ["job_id", "state", "start_time"]
    elif kind in ("placement_groups", "pgs"):
        rows = state_api.list_placement_groups(args.address)
        cols = ["pg_id", "state", "strategy", "bundles"]
    elif kind == "objects":
        rows = state_api.list_objects(args.address)
        cols = ["object_id", "size", "tier", "node_id"]
    else:
        raise SystemExit(f"unknown entity {args.kind!r}")
    rows = rows[: args.limit]
    if args.format == "json":
        print(json.dumps(rows, default=str, indent=2))
    else:
        print(_fmt_table(rows, cols))
    return 0


def cmd_summary(args) -> int:
    from ..util.state import api as state_api

    if args.kind == "tasks":
        print(json.dumps(state_api.summarize_tasks(args.address), indent=2))
    elif args.kind == "actors":
        print(json.dumps(state_api.summarize_actors(args.address), indent=2))
    else:
        raise SystemExit(f"unknown entity {args.kind!r}")
    return 0


def cmd_timeline(args) -> int:
    from ..util.state.api import StateApiClient, chrome_trace_events

    out = args.output or f"ray-tpu-timeline-{int(time.time())}.json"
    if getattr(args, "cluster", False):
        # Cluster-merged trace: spans from every process, cross-process
        # flow links, and explicit truncation metadata.
        from ..util import obs

        trace = obs.cluster_timeline(args.address)
        with open(out, "w") as f:
            json.dump(trace, f)
        meta = trace["otherData"]
        print(f"wrote {len(trace['traceEvents'])} events "
              f"({meta['num_spans']} spans, {meta['num_traces']} traces) "
              f"to {out} (open in chrome://tracing or ui.perfetto.dev)")
        if meta["truncated"]:
            print(f"WARNING: {meta['spans_dropped']} spans were shed from "
                  "the task-event channel — traces may be incomplete")
        return 0
    client = StateApiClient(args.address)
    events = chrome_trace_events(client.list_task_events(limit=100000))
    with open(out, "w") as f:
        json.dump(events, f)
    print(f"wrote {len(events)} events to {out} "
          "(open in chrome://tracing or ui.perfetto.dev)")
    return 0


def cmd_slo(args) -> int:
    """Evaluate the SLO/anomaly rules against the running cluster and
    print current violations (rate rules need two samples — the command
    evaluates, waits ``--window``, and evaluates again) plus the
    remediation controller's state: actions taken, rate-limit and
    quarantine status.  Exit codes: 0 clean, 1 violations found, 2 a
    remediation target is QUARANTINED (the self-healing loop stopped
    itself — a human is needed)."""
    import ray_tpu_torch
    from ..util import remediation as remediation_mod
    from ..util.slo import SloEngine

    if not ray_tpu_torch.is_initialized():
        ray_tpu_torch.init(address=args.address or "auto")
    engine = SloEngine()
    engine.evaluate()
    if args.window > 0:
        time.sleep(args.window)
    violations = engine.evaluate()
    report = engine.report()
    remediation = remediation_mod.report_snapshot()
    if remediation is not None:
        report["remediation"] = remediation
    quarantined = bool(remediation and remediation.get("quarantined"))
    rc = 2 if quarantined else (1 if violations else 0)
    if args.json:
        print(json.dumps(report, indent=2))
        return rc
    if not violations:
        print(f"no SLO violations (rules: {', '.join(report['rules'])})")
    else:
        print(_fmt_table(
            [v.to_dict() for v in violations],
            ["rule", "subject", "value", "threshold", "ongoing", "detail"],
        ))
    if remediation:
        actions = remediation.get("actions") or []
        if actions:
            print("\nremediation actions (most recent last):")
            print(_fmt_table(
                actions[-20:],
                ["rule", "action", "target", "outcome", "detail"],
            ))
        if quarantined:
            print("\nQUARANTINED (remediation stopped itself; "
                  "human attention needed):")
            for target, entry in remediation["quarantined"].items():
                print(f"  {target}: {entry.get('reason', '')} "
                      f"[rule={entry.get('rule', '?')}]")
    return rc


def cmd_logs(args) -> int:
    """List or tail system-process logs from the newest session directory
    (reference: ``ray logs``)."""
    import glob as _glob
    import tempfile

    base = os.path.join(tempfile.gettempdir(), "ray_tpu_torch")
    sessions = sorted(
        _glob.glob(os.path.join(base, "session_*")),
        key=os.path.getmtime,
        reverse=True,
    )
    if not sessions:
        print("no sessions found")
        return 1
    session = sessions[0]
    logs = sorted(_glob.glob(os.path.join(session, "*.log")))
    if not args.component:
        print(f"session: {session}")
        for path in logs:
            print(f"  {os.path.basename(path)}  "
                  f"({os.path.getsize(path)} bytes)")
        return 0
    matches = [p for p in logs if args.component in os.path.basename(p)]
    if not matches:
        print(f"no log matching {args.component!r}")
        return 1
    for path in matches:
        print(f"==> {os.path.basename(path)} <==")
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            f.seek(max(0, size - args.tail_bytes))
            sys.stdout.write(f.read().decode(errors="replace"))
    return 0


def cmd_stack(args) -> int:
    """Dump live stacks of every local system process (reference:
    ``ray stack``, ``scripts/scripts.py:2011`` — py-spy there; SIGUSR1 →
    in-process asyncio await-chain dumps here, see core/stack_dump.py).
    Signals each process, waits for the dumps to land in the session
    logs, then prints what each log gained."""
    import glob as _glob
    import tempfile

    base = os.path.join(tempfile.gettempdir(), "ray_tpu_torch")
    sessions = sorted(
        _glob.glob(os.path.join(base, "session_*")),
        key=os.path.getmtime,
        reverse=True,
    )
    logs = (
        sorted(_glob.glob(os.path.join(sessions[0], "*.log")))
        if sessions else []
    )
    sizes = {p: os.path.getsize(p) for p in logs}

    found = list(_iter_ray_tpu_pids())
    if not found:
        print("no ray_tpu_torch system processes found")
        return 1
    for pid, cmdline in found:
        try:
            os.kill(pid, signal.SIGUSR1)
            print(f"signalled {pid}: {cmdline[:80]}")
        except OSError as e:
            print(f"failed to signal {pid}: {e}")
    time.sleep(args.wait)

    for path in logs:
        try:
            new = os.path.getsize(path) - sizes.get(path, 0)
        except OSError:
            continue
        if new <= 0:
            continue
        print(f"\n==> {os.path.basename(path)} <==")
        with open(path, "rb") as f:
            f.seek(sizes.get(path, 0))
            sys.stdout.write(f.read().decode(errors="replace"))
    return 0


def cmd_dashboard(args) -> int:
    from ..dashboard import start_dashboard

    url = start_dashboard(
        host=args.host, port=args.port, address=args.address
    )
    print(f"dashboard at {url} (endpoints at {url}/)")
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="ray-tpu-torch", description="ray_tpu_torch cluster CLI"
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("start", help="start a head or worker node")
    p.add_argument("--head", action="store_true")
    p.add_argument("--address", help="head control-plane host:port (worker)")
    p.add_argument("--port", type=int, help="control-plane port (head)")
    p.add_argument("--num-cpus", type=float, default=None)
    p.add_argument("--resources", help='JSON, e.g. \'{"GPU": 4}\'')
    p.add_argument("--labels", help="JSON node labels")
    p.add_argument("--block", action="store_true", help="stay in foreground")
    p.set_defaults(fn=cmd_start)

    p = sub.add_parser("stop", help="stop all local ray_tpu_torch processes")
    p.add_argument("-v", "--verbose", action="store_true")
    p.set_defaults(fn=cmd_stop)

    p = sub.add_parser("status", help="cluster resource/actor/job summary")
    p.add_argument("--address", default=None)
    p.set_defaults(fn=cmd_status)

    p = sub.add_parser("list", help="list cluster entities")
    p.add_argument(
        "kind",
        choices=["nodes", "actors", "tasks", "jobs", "placement-groups",
                 "pgs", "objects"],
    )
    p.add_argument("--address", default=None)
    p.add_argument("--filter", action="append", help="key=value (repeatable)")
    p.add_argument("--limit", type=int, default=100)
    p.add_argument("--format", choices=["table", "json"], default="table")
    p.set_defaults(fn=cmd_list)

    p = sub.add_parser("summary", help="summarize tasks or actors")
    p.add_argument("kind", choices=["tasks", "actors"])
    p.add_argument("--address", default=None)
    p.set_defaults(fn=cmd_summary)

    p = sub.add_parser("timeline", help="dump Chrome-trace task timeline")
    p.add_argument("--address", default=None)
    p.add_argument("-o", "--output", default=None)
    p.add_argument("--cluster", action="store_true",
                   help="cluster-merged trace: spans from every process, "
                   "cross-process flow links, truncation metadata")
    p.set_defaults(fn=cmd_timeline)

    p = sub.add_parser("slo", help="print current SLO/anomaly violations")
    p.add_argument("--address", default=None)
    p.add_argument("--window", type=float, default=1.0,
                   help="seconds between the two evaluations rate rules "
                   "need (0 = single evaluation)")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_slo)

    p = sub.add_parser("logs", help="list/tail system logs of the newest session")
    p.add_argument("component", nargs="?", default=None,
                   help="substring of the log file name (e.g. control_plane)")
    p.add_argument("--tail-bytes", type=int, default=1 << 16)
    p.set_defaults(fn=cmd_logs)

    p = sub.add_parser(
        "stack", help="dump live asyncio/thread stacks of system processes"
    )
    p.add_argument("--wait", type=float, default=1.0,
                   help="seconds to wait for dumps to land in logs")
    p.set_defaults(fn=cmd_stack)

    p = sub.add_parser("dashboard", help="serve cluster state + metrics over HTTP")
    p.add_argument("--address", default=None)
    p.add_argument("--port", type=int, default=8265)
    p.add_argument("--host", default="127.0.0.1")
    p.set_defaults(fn=cmd_dashboard)

    from . import job_cli, serve_cli

    job_cli.register(sub)
    serve_cli.register(sub)
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

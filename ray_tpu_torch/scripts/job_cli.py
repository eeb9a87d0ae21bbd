"""``ray-tpu job …`` subcommands (reference: ``ray job submit/status/logs/
stop/list`` in ray ``dashboard/modules/job/cli.py``)."""

from __future__ import annotations

import json
import shlex


def _client(args):
    from ..job import JobSubmissionClient

    return JobSubmissionClient(address=args.address)


def cmd_job_submit(args) -> int:
    client = _client(args)
    runtime_env = None
    if args.working_dir or args.runtime_env_json:
        runtime_env = json.loads(args.runtime_env_json or "{}")
        if args.working_dir:
            runtime_env["working_dir"] = args.working_dir
    sid = client.submit_job(
        entrypoint=shlex.join(args.entrypoint),
        submission_id=args.submission_id,
        runtime_env=runtime_env,
    )
    print(f"submitted: {sid}")
    if args.no_wait:
        return 0
    status = client.wait_until_finished(sid, timeout=args.timeout)
    print(client.get_job_logs(sid), end="")
    print(f"job {sid}: {status}")
    return 0 if status == "SUCCEEDED" else 1


def cmd_job_status(args) -> int:
    info = _client(args).get_job_info(args.submission_id)
    if info is None:
        print("not found")
        return 1
    print(json.dumps(info.__dict__, indent=2, default=str))
    return 0


def cmd_job_logs(args) -> int:
    print(_client(args).get_job_logs(args.submission_id), end="")
    return 0


def cmd_job_stop(args) -> int:
    ok = _client(args).stop_job(args.submission_id)
    print("stopped" if ok else "not running")
    return 0


def cmd_job_list(args) -> int:
    rows = [j.__dict__ for j in _client(args).list_jobs()]
    print(json.dumps(rows, indent=2, default=str))
    return 0


def register(sub) -> None:
    job = sub.add_parser("job", help="job submission").add_subparsers(
        dest="job_cmd", required=True
    )

    p = job.add_parser("submit", help="submit an entrypoint command")
    p.add_argument("entrypoint", nargs="+")
    p.add_argument("--address", default=None)
    p.add_argument("--submission-id", default=None)
    p.add_argument("--working-dir", default=None)
    p.add_argument("--runtime-env-json", default=None)
    p.add_argument("--no-wait", action="store_true")
    p.add_argument("--timeout", type=float, default=3600)
    p.set_defaults(fn=cmd_job_submit)

    p = job.add_parser("status")
    p.add_argument("submission_id")
    p.add_argument("--address", default=None)
    p.set_defaults(fn=cmd_job_status)

    p = job.add_parser("logs")
    p.add_argument("submission_id")
    p.add_argument("--address", default=None)
    p.set_defaults(fn=cmd_job_logs)

    p = job.add_parser("stop")
    p.add_argument("submission_id")
    p.add_argument("--address", default=None)
    p.set_defaults(fn=cmd_job_stop)

    p = job.add_parser("list")
    p.add_argument("--address", default=None)
    p.set_defaults(fn=cmd_job_list)

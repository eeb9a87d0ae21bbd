"""The port's jobs, CLI and dashboard against the JAX package's, on the CPU.

The programs of ``tests/test_state_jobs.py`` (job submission, failure,
stop, the CLI's ``status``, ``list``, ``summary``, ``timeline`` and ``job``
commands), ``tests/test_job_rest.py`` (jobs over the dashboard's REST
routes) and ``tests/test_spill_oom_dashboard.py``'s dashboard test run
through ``ray_tpu`` and through ``ray_tpu_torch``: one cluster per package
for the module, the JAX one shut down before the port's starts.  Their
answers must be equal field for field, where a field does not name the
package (times, ids and the package's own name are left out).  The port's
cluster declares one GPU, which its ``status``, ``list nodes`` and
dashboard must show; ``python -m ray_tpu_torch`` must run the CLI.
"""

import contextlib
import io
import json
import os
import socket
import subprocess
import sys
import time
import urllib.request

import pytest

import ray_tpu
import ray_tpu.job  # noqa: F401 — `pkg.job` in the programs
import ray_tpu_torch
import ray_tpu_torch.job  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120
JOB_FIELDS = ("entrypoint", "status", "message", "metadata",
              "driver_exit_code")


def _wait_for(pred, timeout=30, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.1)
    raise AssertionError(f"timed out waiting for {msg}")


def _cli(pkg, *argv):
    """(exit code, stdout) of the package's CLI ``main`` in this process."""
    main = __import__(f"{pkg.__name__}.scripts.cli",
                      fromlist=["main"]).main
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = main(list(argv))
    return code, out.getvalue()


def _job_fields(info):
    return {k: info[k] if isinstance(info, dict) else getattr(info, k)
            for k in JOB_FIELDS}


def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _fetch(url, raw=False):
    body = urllib.request.urlopen(url, timeout=30).read()
    return body if raw else json.loads(body)


# ------------------------------------------------------------ the programs
def prog_job_lifecycle(rt, pkg):
    client = pkg.job.JobSubmissionClient()
    sid = client.submit_job(
        entrypoint=f"{sys.executable} -c \"print('job says hi')\"",
        metadata={"who": "parity"})
    status = client.wait_until_finished(sid, timeout=60)
    logs = client.get_job_logs(sid)
    info = _job_fields(client.get_job_info(sid))
    listed = sid in [j.submission_id for j in client.list_jobs()]
    deleted = client.delete_job(sid)
    return {"status": status, "logs": logs, "info": info, "listed": listed,
            "deleted": deleted, "after": client.get_job_info(sid)}


def prog_job_failure_and_stop(rt, pkg):
    JobStatus = pkg.job.JobStatus
    client = pkg.job.JobSubmissionClient()
    sid = client.submit_job(
        entrypoint=f"{sys.executable} -c 'raise SystemExit(3)'")
    failed = client.wait_until_finished(sid, timeout=60)
    code = client.get_job_info(sid).driver_exit_code
    sid2 = client.submit_job(
        entrypoint=f"{sys.executable} -c 'import time; time.sleep(600)'")
    _wait_for(lambda: client.get_job_status(sid2) == JobStatus.RUNNING,
              msg="job to start")
    stopped = client.stop_job(sid2)
    _wait_for(lambda: client.get_job_status(sid2) == JobStatus.STOPPED,
              msg="job to stop")
    _wait_for(lambda: client.get_job_info(sid2).driver_exit_code
              is not None, msg="the stopped entrypoint to be reaped")
    return {"failed": failed, "exit_code": code, "stop": stopped,
            "info": _job_fields(client.get_job_info(sid2)),
            "stop_again": client.stop_job(sid2),
            "unknown": [client.get_job_info("nope"), client.stop_job("nope")]}


def prog_job_cli(rt, pkg):
    code, out = _cli(pkg, "job", "submit", "--submission-id", "cli-job",
                     "--", sys.executable, "-c", "print('from the cli')")
    listed = _cli(pkg, "job", "list")
    status = _cli(pkg, "job", "status", "cli-job")
    logs = _cli(pkg, "job", "logs", "cli-job")
    return {"submit": (code, out), "listed": (
        listed[0], "cli-job" in [j["submission_id"]
                                 for j in json.loads(listed[1])]),
        "status": (status[0], _job_fields(json.loads(status[1]))),
        "logs": logs, "stop": _cli(pkg, "job", "stop", "cli-job"),
        "missing": _cli(pkg, "job", "status", "no-such-job")}


def prog_cli_status_list_summary(rt, pkg):
    @rt.remote
    def noop():
        return None

    rt.get(noop.remote(), timeout=TIMEOUT)

    def noop_tasks():
        tasks = json.loads(_cli(pkg, "list", "tasks", "--format",
                                "json")[1])
        return sorted({t["name"].rsplit(".", 1)[-1] for t in tasks
                       if t["name"].endswith("noop")})

    _wait_for(noop_tasks, msg="the task's events to flush")
    code, out = _cli(pkg, "status")
    # Totals only: a finished task's lease comes back a moment later.
    lines = [line if line.startswith("nodes:") else line.split("/", 1)[1]
             for line in out.splitlines()
             if line.startswith("nodes:") or line.endswith(" CPU")]
    codes = [_cli(pkg, "list", "nodes")[0],
             _cli(pkg, "summary", "actors")[0]]
    code_tasks = _cli(pkg, "list", "tasks", "--format", "json")[0]
    nodes = json.loads(_cli(pkg, "list", "nodes", "--format", "json")[1])
    return {"status": (code, lines), "codes": codes + [code_tasks],
            "noop_tasks": noop_tasks(), "nodes": len(nodes),
            "node_fields": sorted(nodes[0])}


def prog_cli_timeline(rt, pkg, tmp):
    @rt.remote
    def tock():
        return 1

    rt.get(tock.remote(), timeout=TIMEOUT)
    path = os.path.join(tmp, f"{pkg.__name__}-timeline.json")
    got = {}

    def written():
        got["code"], got["out"] = _cli(pkg, "timeline", "-o", path)
        with open(path) as f:
            got["events"] = json.load(f)
        return any(e.get("name", "").endswith("tock")
                   for e in got["events"])

    _wait_for(written, msg="the task's events to flush")
    return {"code": got["code"], "is_list": isinstance(got["events"], list),
            "said": got["out"].startswith("wrote ")}


def prog_rest_jobs(rt, pkg):
    from importlib import import_module

    dashboard = import_module(f"{pkg.__name__}.dashboard")
    sdk = import_module(f"{pkg.__name__}.job.sdk")
    url = dashboard.start_dashboard(port=_free_port())
    try:
        client = sdk.JobSubmissionClient(address=url)
        kind = type(client).__name__
        sid = client.submit_job(
            entrypoint="echo rest-job-ran && echo done-marker",
            metadata={"who": "rest-test"})
        status = client.wait_until_finished(sid, timeout=TIMEOUT)
        info = _job_fields(client.get_job_info(sid))
        marker = "done-marker" in client.get_job_logs(sid)
        listed = sid in [j.submission_id for j in client.list_jobs()]
        deleted = client.delete_job(sid)
        gone = client.get_job_info(sid)
        sid2 = client.submit_job(entrypoint="sleep 60")
        stop = client.stop_job(sid2)
        stopped = client.wait_until_finished(sid2, timeout=60)
        try:
            client.submit_job(entrypoint="echo y", submission_id=sid2)
            duplicate = None
        except ValueError:
            duplicate = "ValueError"
        return {"kind": kind, "status": status, "info": info,
                "marker": marker, "listed": listed, "deleted": deleted,
                "gone": gone, "stop": stop, "stopped": stopped,
                "duplicate": duplicate,
                "unknown": [client.get_job_info("nope"),
                            client.stop_job("nope")]}
    finally:
        dashboard.stop_dashboard()


def prog_dashboard_routes(rt, pkg):
    from importlib import import_module

    dashboard = import_module(f"{pkg.__name__}.dashboard")
    metrics = import_module(f"{pkg.__name__}.util.metrics")

    @rt.remote
    def tick():
        return 1

    rt.get([tick.remote() for _ in range(3)], timeout=TIMEOUT)
    metrics.Counter("dash_parity_total", tag_keys=()).inc(5)
    url = dashboard.start_dashboard(port=_free_port())
    try:
        html = _fetch(url + "/", raw=True)
        cluster = _fetch(url + "/api/cluster")
        nodes = _fetch(url + "/api/nodes")
        _wait_for(lambda: len(_fetch(url + "/api/tasks?name=tick")) >= 3,
                  msg="the tasks' events to flush")
        deadline = time.monotonic() + 30
        phases = set()
        while time.monotonic() < deadline:
            phases = {e["args"].get("phase") for e in _fetch(
                url + "/api/timeline")
                if e.get("cat") == "profile" and e.get("args")}
            if {"queue_wait", "arg_resolution", "execute",
                    "return_put"} <= phases:
                break
            time.sleep(0.5)
        text = _fetch(url + "/metrics", raw=True).decode()
        return {
            "ui": f"{pkg.__name__} dashboard" in html.decode(),
            "endpoints": _fetch(url + "/api")["endpoints"],
            "cluster_fields": sorted(cluster),
            "nodes_alive": cluster["nodes_alive"],
            "cpus": cluster["resources_total"]["CPU"],
            "nodes": [sorted(n) for n in nodes],
            "ticks": len(_fetch(url + "/api/tasks?name=tick")),
            "phases": sorted(p for p in phases if p),
            "executed": _fetch(url + "/api/task_phases")["execute"]["count"]
            >= 3,
            "metrics": ["dash_parity_total" in text,
                        "_task_phase_s_bucket" in text,
                        'le="+Inf"' in text]}
    finally:
        dashboard.stop_dashboard()


PROGRAMS = {f.__name__[len("prog_"):]: f for f in (
    prog_job_lifecycle, prog_job_failure_and_stop, prog_job_cli,
    prog_cli_status_list_summary, prog_cli_timeline, prog_rest_jobs,
    prog_dashboard_routes)}

EXPECTED = {  # what the JAX package's tests assert
    "job_lifecycle": {"status": "SUCCEEDED", "listed": True,
                      "deleted": True, "after": None},
    "job_failure_and_stop": {"failed": "FAILED", "exit_code": 3,
                             "stop": True},
    "cli_timeline": {"code": 0, "is_list": True, "said": True},
    "rest_jobs": {"kind": "_HttpJobSubmissionClient", "status": "SUCCEEDED",
                  "marker": True, "listed": True, "deleted": True,
                  "gone": None, "stop": True, "stopped": "STOPPED",
                  "duplicate": "ValueError", "unknown": [None, False]},
}


def _run_all(rt, tmp):
    out = {}
    for name, prog in PROGRAMS.items():
        args = (tmp,) if name == "cli_timeline" else ()
        out[name] = prog(rt, rt, *args)
    return out


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    ray_tpu.init(num_cpus=4)
    try:
        return _run_all(ray_tpu, str(tmp_path_factory.mktemp("jax")))
    finally:
        ray_tpu.shutdown()


@pytest.fixture(scope="module")
def port(jax_results):
    """The port's cluster, started only once the JAX one is down; it
    declares one GPU (there is no card here)."""
    ray_tpu_torch.init(num_cpus=4, resources={"GPU": 1})
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


@pytest.fixture(scope="module")
def port_results(port, tmp_path_factory):
    return _run_all(port, str(tmp_path_factory.mktemp("port")))


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_same_answers_as_the_jax_package(name, jax_results, port_results):
    assert port_results[name] == jax_results[name], (
        port_results[name], jax_results[name])
    for key, want in EXPECTED.get(name, {}).items():
        assert port_results[name][key] == want, (key, port_results[name])


def test_cli_and_dashboard_show_the_gpu(port):
    code, out = _cli(port, "status")
    assert code == 0 and "  1/1 GPU" in out.splitlines()
    nodes = json.loads(_cli(port, "list", "nodes", "--format", "json")[1])
    assert [n["total"].get("GPU") for n in nodes] == [1.0]
    from ray_tpu_torch.dashboard import start_dashboard, stop_dashboard

    url = start_dashboard(port=_free_port())
    try:
        cluster = _fetch(url + "/api/cluster")
        assert cluster["resources_total"]["GPU"] == 1.0
        assert cluster["resources_available"]["GPU"] == 1.0
    finally:
        stop_dashboard()


def test_python_m_runs_the_port_cli(port):
    # The address by name: other test files' port clusters may run beside
    # this one, and "auto" reads whichever head wrote its info last.
    address = port.core.core_worker.global_worker().cp_address
    proc = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch", "status", "--address",
         address], capture_output=True, text=True, timeout=TIMEOUT,
        cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert "nodes: 1 alive" in proc.stdout and "  1/1 GPU" in proc.stdout
    proc = subprocess.run([sys.executable, "-m", "ray_tpu_torch", "--help"],
                          capture_output=True, text=True, timeout=TIMEOUT,
                          cwd=REPO)
    assert proc.stdout.startswith("usage: ray-tpu-torch")


def test_stop_scans_for_the_port_processes_only(port):
    from ray_tpu_torch.scripts import cli

    found = list(cli._iter_ray_tpu_pids())
    assert found and all("ray_tpu_torch.core." in c for _, c in found)


def test_api_module_resolves_as_an_attribute():
    """``ray_tpu_torch.api`` in a fresh process, as the job supervisor
    reaches it in its worker (the JAX package imports ``api`` eagerly;
    the port's package resolves it on first use, still without torch)."""
    code = ("import sys, ray_tpu_torch; "
            "assert 'ray_tpu_torch.api' not in sys.modules; "
            "assert callable(ray_tpu_torch.api.global_worker); "
            "assert ray_tpu_torch.dag.InputNode; "
            "assert 'torch' not in sys.modules")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=TIMEOUT, cwd=REPO)
    assert proc.returncode == 0, proc.stderr

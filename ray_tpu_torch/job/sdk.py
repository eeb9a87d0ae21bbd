"""Job submission SDK.

Reference: ``JobSubmissionClient`` (ray ``dashboard/modules/job/sdk.py:36``,
``submit_job:126``) + ``JobManager``/``JobSupervisor`` (ray
``dashboard/modules/job/job_manager.py:61``).  Architecture kept: one
detached supervisor actor per job owns the entrypoint subprocess; job
metadata lives in the control-plane KV so any client can list jobs.  The
supervisor is placed like any actor (it requests no resources, so its
worker, and the entrypoint subprocess after it, sees no card: the job
reaches a GPU only through the leases of its own tasks and actors), and the
entrypoint subprocess inherits the cluster address so its own
``ray_tpu_torch.init(address=…)`` joins the same cluster.
"""

from __future__ import annotations

import os
import subprocess
import tempfile
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Dict, List, Optional

_KV_NS = "_job_submissions"


class JobStatus:
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"
    STOPPED = "STOPPED"

    TERMINAL = (SUCCEEDED, FAILED, STOPPED)


@dataclass
class JobInfo:
    submission_id: str
    entrypoint: str
    status: str = JobStatus.PENDING
    message: str = ""
    start_time: float = 0.0
    end_time: float = 0.0
    metadata: Dict[str, str] = field(default_factory=dict)
    driver_exit_code: Optional[int] = None


class JobSupervisor:
    """Detached actor owning one job's entrypoint subprocess (ray
    ``dashboard/modules/job/job_manager.py`` JobSupervisor analog)."""

    def __init__(self, submission_id: str, entrypoint: str,
                 metadata: Optional[Dict[str, str]] = None,
                 env_vars: Optional[Dict[str, str]] = None):
        self._info = JobInfo(
            submission_id=submission_id,
            entrypoint=entrypoint,
            metadata=metadata or {},
        )
        self._env_vars = env_vars or {}
        self._proc: Optional[subprocess.Popen] = None
        self._log_path = os.path.join(
            os.environ.get("RAY_TPU_TORCH_LOG_DIR",
                           os.path.join(tempfile.gettempdir(), "ray_tpu_torch")),
            f"job-{submission_id}.log",
        )
        self._lock = threading.Lock()
        self._publish()

    def _publish(self):
        import ray_tpu_torch

        worker = ray_tpu_torch.api.global_worker()
        worker.kv_put(_KV_NS, self._info.submission_id, self._info.__dict__)

    def run(self) -> str:
        """Start the entrypoint subprocess and reap it in the background."""
        env = dict(os.environ)
        env.update(self._env_vars)
        env["RAY_TPU_TORCH_JOB_SUBMISSION_ID"] = self._info.submission_id
        with self._lock:
            if self._proc is not None:
                return self._info.status
            out = open(self._log_path, "ab")
            try:
                self._proc = subprocess.Popen(
                    self._info.entrypoint,
                    shell=True,
                    stdout=out,
                    stderr=subprocess.STDOUT,
                    env=env,
                    start_new_session=True,
                )
            except OSError as e:
                self._info.status = JobStatus.FAILED
                self._info.message = f"failed to start entrypoint: {e}"
                self._publish()
                return self._info.status
            self._info.status = JobStatus.RUNNING
            self._info.start_time = time.time()
            self._publish()
        threading.Thread(target=self._reap, daemon=True,
                         name="job-reaper").start()
        return self._info.status

    def _reap(self):
        code = self._proc.wait()
        with self._lock:
            if self._info.status == JobStatus.RUNNING:
                self._info.status = (
                    JobStatus.SUCCEEDED if code == 0 else JobStatus.FAILED
                )
                self._info.message = f"entrypoint exited with code {code}"
            self._info.driver_exit_code = code
            self._info.end_time = time.time()
            self._publish()

    def status(self) -> dict:
        return dict(self._info.__dict__)

    def logs(self, tail_bytes: int = 1 << 20) -> str:
        try:
            with open(self._log_path, "rb") as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                f.seek(max(0, size - tail_bytes))
                return f.read().decode(errors="replace")
        except FileNotFoundError:
            return ""

    def stop(self) -> bool:
        with self._lock:
            if self._proc is None or self._proc.poll() is not None:
                return False
            self._info.status = JobStatus.STOPPED
            self._info.message = "stopped by user"
        try:
            os.killpg(os.getpgid(self._proc.pid), 15)
        except OSError:
            pass

        def force_kill():
            time.sleep(3)
            if self._proc.poll() is None:
                try:
                    os.killpg(os.getpgid(self._proc.pid), 9)
                except OSError:
                    pass

        threading.Thread(target=force_kill, daemon=True,
                         name="job-force-kill").start()
        self._publish()
        return True


def _supervisor_name(submission_id: str) -> str:
    return f"_rtpu_job:{submission_id}"


class JobSubmissionClient:
    """Submit and manage jobs on a running cluster (ray
    ``dashboard/modules/job/sdk.py:36`` analog).

    Two transports, chosen by the address scheme:

    - ``http://host:port`` — REST against the dashboard's ``/api/jobs``
      endpoints, from OUTSIDE the cluster (no ray_tpu_torch.init), exactly like
      the reference client.
    - anything else (or None) — the cluster's own actor RPC from a
      connected driver.
    """

    def __new__(cls, address: Optional[str] = None):
        if address and address.startswith(("http://", "https://")):
            return object.__new__(_HttpJobSubmissionClient)
        return object.__new__(cls)

    def __init__(self, address: Optional[str] = None):
        import ray_tpu_torch

        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init(address=address or "auto")
        self._ray = ray_tpu_torch

    def submit_job(
        self,
        *,
        entrypoint: str,
        submission_id: Optional[str] = None,
        runtime_env: Optional[dict] = None,
        metadata: Optional[Dict[str, str]] = None,
    ) -> str:
        from ..core.runtime_env import resolve_runtime_env

        submission_id = submission_id or f"rtpu-job-{uuid.uuid4().hex[:10]}"
        if self.get_job_info(submission_id) is not None:
            raise ValueError(f"job {submission_id!r} already exists")
        env_vars = resolve_runtime_env(runtime_env) or {}
        supervisor_cls = self._ray.remote(num_cpus=0)(JobSupervisor)
        supervisor = supervisor_cls.options(
            name=_supervisor_name(submission_id),
            lifetime="detached",
        ).remote(submission_id, entrypoint, metadata, env_vars)
        # Synchronous start so submit errors surface here.
        self._ray.get(supervisor.run.remote(), timeout=60)
        return submission_id

    def _supervisor(self, submission_id: str):
        try:
            return self._ray.get_actor(_supervisor_name(submission_id))
        except ValueError:
            return None

    def get_job_info(self, submission_id: str) -> Optional[JobInfo]:
        worker = self._ray.api.global_worker()
        raw = worker.kv_get(_KV_NS, submission_id)
        if raw is None:
            return None
        return JobInfo(**raw)

    def get_job_status(self, submission_id: str) -> Optional[str]:
        info = self.get_job_info(submission_id)
        return info.status if info else None

    def get_job_logs(self, submission_id: str) -> str:
        sup = self._supervisor(submission_id)
        if sup is None:
            return ""
        return self._ray.get(sup.logs.remote(), timeout=30)

    def stop_job(self, submission_id: str) -> bool:
        sup = self._supervisor(submission_id)
        if sup is None:
            return False
        return self._ray.get(sup.stop.remote(), timeout=30)

    def delete_job(self, submission_id: str) -> bool:
        info = self.get_job_info(submission_id)
        if info is None:
            return False
        if info.status not in JobStatus.TERMINAL:
            raise RuntimeError(
                f"job {submission_id!r} is {info.status}; stop it first"
            )
        sup = self._supervisor(submission_id)
        if sup is not None:
            self._ray.kill(sup)
        worker = self._ray.api.global_worker()
        worker.kv_del(_KV_NS, submission_id)
        return True

    def list_jobs(self) -> List[JobInfo]:
        worker = self._ray.api.global_worker()
        out = []
        for key in worker.kv_keys(_KV_NS):
            raw = worker.kv_get(_KV_NS, key)
            if raw is not None:
                out.append(JobInfo(**raw))
        return out

    def wait_until_finished(
        self, submission_id: str, timeout: float = 300, poll_s: float = 0.5
    ) -> str:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            status = self.get_job_status(submission_id)
            if status in JobStatus.TERMINAL:
                return status
            time.sleep(poll_s)
        raise TimeoutError(f"job {submission_id} still running after {timeout}s")


class _HttpJobSubmissionClient(JobSubmissionClient):
    """REST transport: talks to the dashboard's /api/jobs endpoints with
    stdlib urllib — usable from a machine that is NOT part of the cluster
    (reference: dashboard/modules/job/sdk.py:36)."""

    def __init__(self, address: str):
        self._base = address.rstrip("/")

    def _request(self, method: str, path: str, body: Optional[dict] = None):
        import json as _json
        import urllib.error
        import urllib.request

        data = _json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(
            self._base + path, data=data, method=method,
            headers={"Content-Type": "application/json"},
        )
        try:
            with urllib.request.urlopen(req, timeout=120) as resp:
                return _json.loads(resp.read().decode())
        except urllib.error.HTTPError as e:
            payload = e.read().decode()
            try:
                msg = _json.loads(payload).get("error", payload)
            except ValueError:
                msg = payload
            if e.code == 404:
                return None
            if e.code == 409:
                raise ValueError(msg) from None
            raise RuntimeError(f"HTTP {e.code}: {msg}") from None

    def submit_job(self, *, entrypoint: str, submission_id=None,
                   runtime_env=None, metadata=None) -> str:
        reply = self._request("POST", "/api/jobs", {
            "entrypoint": entrypoint,
            "submission_id": submission_id,
            "runtime_env": runtime_env,
            "metadata": metadata,
        })
        return reply["submission_id"]

    def get_job_info(self, submission_id: str) -> Optional[JobInfo]:
        reply = self._request("GET", f"/api/jobs/{submission_id}")
        if reply is None:
            return None
        return JobInfo(**{k: reply[k] for k in JobInfo.__dataclass_fields__})

    def get_job_logs(self, submission_id: str) -> str:
        reply = self._request("GET", f"/api/jobs/{submission_id}/logs")
        return "" if reply is None else reply.get("logs", "")

    def stop_job(self, submission_id: str) -> bool:
        reply = self._request("POST", f"/api/jobs/{submission_id}/stop")
        return bool(reply and reply.get("stopped"))

    def delete_job(self, submission_id: str) -> bool:
        reply = self._request("DELETE", f"/api/jobs/{submission_id}")
        return bool(reply and reply.get("deleted"))

    def list_jobs(self) -> List[JobInfo]:
        reply = self._request("GET", "/api/jobs") or []
        out = []
        for rec in reply:
            try:
                out.append(JobInfo(**{
                    k: rec[k] for k in JobInfo.__dataclass_fields__
                }))
            except (KeyError, TypeError):
                continue
        return out

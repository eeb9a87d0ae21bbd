"""The port's container runtime envs keep a worker's GPU lease: the twin of
tests/test_runtime_env_container.py's fake-podman tests.

The port's lease is ``CUDA_VISIBLE_DEVICES`` (set by the node agent's
``_apply_chip_isolation``), where the JAX package's is
``TPU_VISIBLE_CHIPS``.  ``podman run`` strips the inherited environment,
so ``container_argv`` must forward it: a worker leasing card 1 must see
card 1 only, and a worker leasing no card must see none, not every card
the container runtime exposes.

The fake podman here logs its argv and runs the contained command on the
host as podman would: from an environment holding only its ``--env``
values (and ``PATH``, ``HOME`` and ``TMPDIR`` from the host, which the
worker needs to start).
"""

import json
import os
import stat
import sys

import pytest

import ray_tpu_torch
from ray_tpu_torch.core import runtime_env as rte

FAKE_PODMAN = """#!{python}
import json, os, sys

args = sys.argv[1:]
with open({log!r}, "a") as f:
    f.write(json.dumps(args) + "\\n")
assert args[0] == "run"
env = {{k: os.environ[k] for k in ("PATH", "HOME", "TMPDIR")
       if k in os.environ}}
i = 1
while i < len(args):
    a = args[i]
    if a == "--env":
        k, v = args[i + 1].split("=", 1)
        env[k] = v
        i += 2
    elif a == "-v":
        i += 2
    elif a.startswith("-"):
        i += 1
    else:
        break  # the image
cmd = args[i + 1:]
if cmd[0] == "python":
    cmd[0] = {python!r}
os.execvpe(cmd[0], cmd, env)
"""

WORKER = [sys.executable, "-m", "ray_tpu_torch.core.worker_main"]


@pytest.fixture
def fake_podman(tmp_path, monkeypatch):
    log = tmp_path / "podman_calls.jsonl"
    script = tmp_path / "bin" / "podman"
    script.parent.mkdir()
    script.write_text(FAKE_PODMAN.format(python=sys.executable, log=str(log)))
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{script.parent}:{os.environ['PATH']}")
    return log


def _envs(argv):
    """The ``--env`` values of a container argv, as a dict."""
    return dict(argv[i + 1].split("=", 1)
                for i, a in enumerate(argv) if a == "--env")


@pytest.mark.parametrize("lease", ["1", "0,1", ""])
def test_container_argv_forwards_the_gpu_lease(fake_podman, lease):
    """A lease of card 1, of two cards and of no card each reach the
    container as they are; unrelated host env does not."""
    spec = rte.resolve_container_spec({"image": "img:tag"})
    argv = rte.container_argv(
        spec,
        {"CUDA_VISIBLE_DEVICES": lease, "RAY_TPU_TORCH_WORKER_ID": "w1",
         "TPU_VISIBLE_CHIPS": "", "HOME": "/root"},
        WORKER)
    assert f"CUDA_VISIBLE_DEVICES={lease}" in argv
    env = _envs(argv)
    assert env["CUDA_VISIBLE_DEVICES"] == lease
    assert env["RAY_TPU_TORCH_WORKER_ID"] == "w1"
    assert "HOME" not in env
    # every option, the GPU lease's included, comes before the image
    assert argv.index("img:tag") > argv.index(f"CUDA_VISIBLE_DEVICES={lease}")
    assert argv[-2:] == ["-m", "ray_tpu_torch.core.worker_main"]


def test_container_argv_without_a_lease_adds_none(fake_podman):
    """A worker env with no lease key (no node agent set one) gets none."""
    argv = rte.container_argv(
        rte.resolve_container_spec({"image": "img:tag"}),
        {"RAY_TPU_TORCH_WORKER_ID": "w1"}, WORKER)
    assert "CUDA_VISIBLE_DEVICES" not in _envs(argv)


def test_container_worker_keeps_its_gpu_lease(fake_podman):
    """Through the node agent: in a cluster declaring two cards, a
    ``num_gpus=1`` task in a container sees card 0, and a task leasing no
    card sees none; the podman argv carries both leases."""
    ray_tpu_torch.init(num_cpus=2, resources={"GPU": 2})
    try:
        env = {"container": {"image": "img:tag"}}

        @ray_tpu_torch.remote(num_gpus=1, runtime_env=env)
        def leased():
            return (os.environ.get("CUDA_VISIBLE_DEVICES"),
                    os.environ.get("RAY_TPU_TORCH_RT_CONTAINER", ""))

        @ray_tpu_torch.remote(num_gpus=0, runtime_env=env)
        def unleased():
            return os.environ.get("CUDA_VISIBLE_DEVICES")

        visible, container = ray_tpu_torch.get(leased.remote(), timeout=120)
        assert visible == "0"
        assert json.loads(container)["image"] == "img:tag"
        assert ray_tpu_torch.get(unleased.remote(), timeout=120) == ""
        runs = [_envs(c) for c in (json.loads(line) for line in
                                    open(fake_podman).read().splitlines())
                if "img:tag" in c]
        leases = sorted(r.get("CUDA_VISIBLE_DEVICES") for r in runs)
        assert "0" in leases and "" in leases, leases
    finally:
        ray_tpu_torch.shutdown()

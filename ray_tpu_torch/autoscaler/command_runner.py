"""Command runners: how the autoscaler reaches machines it launched.

Reference: ray ``python/ray/autoscaler/_private/command_runner.py`` —
``SSHCommandRunner`` (and its docker wrapper) runs file syncs + setup
commands + ``ray start`` on freshly provisioned nodes.  Same split here:

* ``CommandRunner`` — the interface (``run``, ``sync_up``).
* ``SSHCommandRunner`` — subprocess ``ssh``/``scp`` with the usual
  non-interactive options and a shared ControlMaster socket so the
  per-command handshake cost is paid once per node.
* ``LocalCommandRunner`` — runs on this machine; the testing analog (the
  reference exercises runner logic through its fake-multinode docker
  provider; a local shell is the dependency-free equivalent).

``ManagedVMProvider`` composes them into a provider for a *static fleet*
of reachable machines (the reference's ``local`` node provider): create
= pick a free host, sync the bootstrap dir, run setup + start commands;
terminate = run the stop command and release the host.
"""

from __future__ import annotations

import os
import subprocess
import tempfile
from typing import Dict, List, Optional, Sequence

from .config import NodeTypeConfig
from .provider import NODE_TYPE_LABEL, PROVIDER_ID_LABEL, NodeProvider


class CommandRunner:
    """One target machine."""

    def run(self, cmd: str, timeout: float = 120.0) -> str:
        """Run a shell command; returns stdout, raises CalledProcessError
        on non-zero exit."""
        raise NotImplementedError

    def sync_up(self, local_path: str, remote_path: str) -> None:
        """Copy a local file/directory onto the target."""
        raise NotImplementedError


class LocalCommandRunner(CommandRunner):
    def __init__(self, env: Optional[Dict[str, str]] = None):
        self._env = env

    def run(self, cmd: str, timeout: float = 120.0) -> str:
        env = dict(os.environ, **self._env) if self._env else None
        return subprocess.check_output(
            cmd, shell=True, text=True, timeout=timeout,
            stderr=subprocess.STDOUT, env=env,
        )

    def sync_up(self, local_path: str, remote_path: str) -> None:
        os.makedirs(os.path.dirname(remote_path) or ".", exist_ok=True)
        subprocess.check_call(["cp", "-r", local_path, remote_path])


class SSHCommandRunner(CommandRunner):
    """ssh/scp against one host.  Non-interactive (BatchMode), host keys
    auto-accepted (fresh VMs have fresh keys), connections multiplexed
    through a ControlMaster socket under /tmp so repeated setup commands
    don't re-handshake."""

    def __init__(self, host: str, user: Optional[str] = None,
                 key_path: Optional[str] = None, port: int = 22):
        self.host = host
        self.user = user
        self.key_path = key_path
        self.port = port
        self._control = os.path.join(
            tempfile.gettempdir(), f"rtpu-ssh-{user or 'x'}-{host}-{port}"
        )

    @property
    def _target(self) -> str:
        return f"{self.user}@{self.host}" if self.user else self.host

    def _base_opts(self) -> List[str]:
        opts = [
            "-o", "BatchMode=yes",
            "-o", "StrictHostKeyChecking=no",
            "-o", "UserKnownHostsFile=/dev/null",
            "-o", "LogLevel=ERROR",
            "-o", "ControlMaster=auto",
            "-o", f"ControlPath={self._control}",
            "-o", "ControlPersist=60s",
            "-p", str(self.port),
        ]
        if self.key_path:
            opts += ["-i", self.key_path]
        return opts

    def run(self, cmd: str, timeout: float = 120.0) -> str:
        return subprocess.check_output(
            ["ssh", *self._base_opts(), self._target, cmd],
            text=True, timeout=timeout, stderr=subprocess.STDOUT,
        )

    def sync_up(self, local_path: str, remote_path: str) -> None:
        opts = self._base_opts()
        # scp spells the port flag -P.
        opts[opts.index("-p") ] = "-P"
        subprocess.check_call(
            ["scp", "-r", *opts, local_path, f"{self._target}:{remote_path}"]
        )


class ManagedVMProvider(NodeProvider):
    """Static fleet of reachable machines (reference ``local`` provider +
    command-runner bootstrap).  ``hosts`` maps host name → CommandRunner;
    commands are shell templates with ``{address}``, ``{labels}``,
    ``{resources}`` placeholders."""

    def __init__(
        self,
        hosts: Dict[str, CommandRunner],
        cp_address: str,
        start_command: str,
        # [r] bracket trick: the pattern must not match the shell that
        # runs the pkill itself (whose cmdline contains the pattern) —
        # without it the stop command SIGTERMs its own shell, and with a
        # LocalCommandRunner it would kill the driver's cluster too.  The
        # port's processes run ``ray_tpu_torch.core.*``, which the JAX
        # package's ``[r]ay_tpu[.]core`` never matches.
        stop_command: str = "pkill -f '[r]ay_tpu_torch[.]core' || true",
        setup_commands: Sequence[str] = (),
        sync_dirs: Sequence[tuple] = (),
    ):
        self._runners = dict(hosts)
        self._free: List[str] = list(hosts)
        self._cp_address = cp_address
        self._start = start_command
        self._stop = stop_command
        self._setup = list(setup_commands)
        self._sync = list(sync_dirs)
        self._nodes: Dict[str, tuple] = {}  # provider_id -> (type, host)

    def create_node(self, node_type: NodeTypeConfig) -> str:
        import json
        import uuid

        if not self._free:
            raise RuntimeError("ManagedVMProvider: fleet exhausted")
        host = self._free.pop(0)
        runner = self._runners[host]
        provider_id = f"vm-{host}-{uuid.uuid4().hex[:6]}"
        labels = dict(node_type.labels)
        labels[NODE_TYPE_LABEL] = node_type.name
        labels[PROVIDER_ID_LABEL] = provider_id
        fmt = {
            "address": self._cp_address,
            "labels": json.dumps(labels),
            "resources": json.dumps(dict(node_type.resources)),
            "provider_id": provider_id,
        }
        try:
            for src, dst in self._sync:
                runner.sync_up(src, dst)
            for cmd in self._setup:
                runner.run(cmd.format(**fmt))
            runner.run(self._start.format(**fmt))
        except Exception:
            # A timed-out start may have actually launched the node —
            # stop best-effort before releasing the host, or the next
            # create_node double-provisions the machine.  Stop templates
            # get the SAME placeholder set as start/setup ({address},
            # {labels}, {resources}, {provider_id}) — formatting with
            # provider_id alone raised KeyError on richer templates and
            # silently skipped the cleanup.
            try:
                runner.run(self._stop.format(**fmt))
            except Exception:  # raylint: waive[RTL003] host unreachable; caller sees empty result
                pass
            self._free.insert(0, host)
            raise
        self._nodes[provider_id] = (node_type.name, host)
        return provider_id

    def terminate_node(self, provider_id: str) -> None:
        import json

        entry = self._nodes.pop(provider_id, None)
        if entry is None:
            return
        node_type, host = entry
        fmt = {
            "address": self._cp_address,
            "labels": json.dumps({NODE_TYPE_LABEL: node_type,
                                  PROVIDER_ID_LABEL: provider_id}),
            "resources": json.dumps({}),
            "provider_id": provider_id,
        }
        try:
            # The node-agent's argv carries its labels JSON, so a stop
            # command of ``pkill -f {provider_id}`` finds exactly this
            # node's processes.
            self._runners[host].run(self._stop.format(**fmt))
        finally:
            self._free.append(host)

    def non_terminated_nodes(self) -> Dict[str, str]:
        return {pid: t for pid, (t, _) in self._nodes.items()}

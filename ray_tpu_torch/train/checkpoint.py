"""Checkpoints: directory-based, persisted through a StorageContext.

Reference surface: ray ``python/ray/train/_checkpoint.py`` (Checkpoint),
``train/v2/_internal/execution/checkpoint/checkpoint_manager.py`` (top-K
retention), and ``train/_internal/storage.py:358`` (fsspec StorageContext).
``storage_path`` may be a local directory or a remote URI
(``memory://…`` = the cluster-KV-backed remote — see ``storage.py``); the
manager and the worker-side commit route every transfer through the
storage backend.  TPU note: sharded jax.Array checkpoints save via
``train.jax_ckpt`` (async per-leaf save) into the directory before report.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
from typing import Any, Dict, List, Optional


_ckpt_cache_root: Optional[str] = None


class Checkpoint:
    """A directory of checkpoint data."""

    def __init__(self, path: str):
        self.path = path

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(os.path.abspath(path))

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Checkpoint":
        d = tempfile.mkdtemp(prefix="rtpu_ckpt_")
        with open(os.path.join(d, "data.json"), "w") as f:
            json.dump(data, f)
        return cls(d)

    def to_directory(self) -> str:
        from .storage import get_storage, is_remote_uri

        if is_remote_uri(self.path):
            # Downloads land in a process-wide cache keyed by URI: repeated
            # restores of the same checkpoint (long tune/train loops) reuse
            # one copy instead of filling /tmp, returned paths stay valid
            # for the process lifetime regardless of Checkpoint object
            # lifetime, and the whole cache root is removed at exit.
            import atexit
            import hashlib

            global _ckpt_cache_root
            if _ckpt_cache_root is None:
                _ckpt_cache_root = tempfile.mkdtemp(prefix="rtpu_ckpt_cache_")
                atexit.register(shutil.rmtree, _ckpt_cache_root, True)
            cached = os.path.join(
                _ckpt_cache_root,
                hashlib.sha256(self.path.encode()).hexdigest()[:16],
            )
            if not os.path.isdir(cached):
                tmp = get_storage(self.path).download_dir(self.path)
                try:
                    os.replace(tmp, cached)
                except OSError:
                    # Concurrent restore won the rename; its copy is ours too.
                    if not os.path.isdir(cached):
                        raise
                    shutil.rmtree(tmp, True)
            return cached
        return self.path

    def to_dict(self) -> Dict[str, Any]:
        with open(os.path.join(self.to_directory(), "data.json")) as f:
            return json.load(f)

    def as_directory(self):
        return _CheckpointDirCtx(self.to_directory())

    def __reduce__(self):
        return (Checkpoint, (self.path,))

    def __repr__(self):
        return f"Checkpoint({self.path})"


class _CheckpointDirCtx:
    def __init__(self, path):
        self.path = path

    def __enter__(self):
        return self.path

    def __exit__(self, *exc):
        return False


def commit_to_storage(checkpoint: Checkpoint, run_dir: str) -> Checkpoint:
    """Worker-side synchronous persist: upload a local checkpoint dir into
    the run's durable storage *before* report() returns, so a crash
    immediately after report loses nothing (the reference's report
    semantics).  Names are time-ordered so `latest` is a listing scan."""
    from .storage import get_storage

    dest = get_storage(run_dir).upload_dir(
        checkpoint.path, f"checkpoint_{time.time_ns():020d}"
    )
    return Checkpoint(dest)


class CheckpointManager:
    """Controller-side view of the run's checkpoint directory: resolves the
    latest checkpoint (including ones committed by workers of a crashed
    attempt) and prunes to top-K."""

    def __init__(self, storage_path: str, run_name: str, num_to_keep=None):
        from .storage import get_storage, is_remote_uri, join_path

        self.run_dir = join_path(storage_path, run_name or "run")
        self._storage = get_storage(self.run_dir)
        if not is_remote_uri(self.run_dir):
            os.makedirs(self.run_dir, exist_ok=True)
        self.num_to_keep = num_to_keep
        self._extra: List[str] = []  # e.g. resume_from_checkpoint

    def register(self, path: str):
        self._extra.append(path)

    def latest(self) -> Optional[Checkpoint]:
        found = self._storage.list_checkpoints()
        if found:
            return Checkpoint(found[-1])
        if self._extra:
            return Checkpoint(self._extra[-1])
        return None

    def prune(self):
        if self.num_to_keep is None:
            return
        found = self._storage.list_checkpoints()
        for victim in found[: -self.num_to_keep]:
            self._storage.delete(victim)

"""Checkpoint storage abstraction — local and remote backends.

Reference: ray ``python/ray/train/_internal/storage.py:358`` — the fsspec
``StorageContext`` every Train/Tune checkpoint flows through, so runs can
persist to object stores instead of node-local disks.  Here the interface
is a small filesystem contract (upload/download/list/delete of checkpoint
directories) with two backends:

  - ``LocalStorage``: plain directories (the round-1 behavior);
  - ``KVStorage`` (``memory://…`` URIs): files stored in the cluster
    control plane's KV table.  This is the in-memory-remote fake for
    tests AND a real cross-node store: workers on any node commit to it,
    the controller resolves ``latest`` from it, and — with control-plane
    persistence on — checkpoints survive node loss the way an object-store
    bucket would.  Swapping in a real GCS/S3 backend is implementing the
    same five methods.

URIs: plain paths and ``file://`` → LocalStorage; ``memory://bucket/…`` →
KVStorage.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import List, Optional


class StorageContext:
    """Filesystem contract for checkpoint directories."""

    scheme = ""

    def upload_dir(self, local_dir: str, remote_rel: str) -> str:
        """Copy a local directory under the storage root; returns the
        checkpoint URI."""
        raise NotImplementedError

    def download_dir(self, uri: str) -> str:
        """Materialize a checkpoint URI as a local directory."""
        raise NotImplementedError

    def list_checkpoints(self) -> List[str]:
        """Sorted checkpoint URIs under the root."""
        raise NotImplementedError

    def delete(self, uri: str) -> None:
        raise NotImplementedError


class LocalStorage(StorageContext):
    scheme = "file"

    def __init__(self, root: str):
        self.root = root

    def upload_dir(self, local_dir: str, remote_rel: str) -> str:
        os.makedirs(self.root, exist_ok=True)
        dest = os.path.join(self.root, remote_rel)
        shutil.copytree(local_dir, dest)
        return dest

    def download_dir(self, uri: str) -> str:
        return uri  # already a local path

    def list_checkpoints(self) -> List[str]:
        try:
            names = sorted(
                n for n in os.listdir(self.root) if n.startswith("checkpoint_")
            )
        except FileNotFoundError:
            return []
        return [os.path.join(self.root, n) for n in names]

    def delete(self, uri: str) -> None:
        shutil.rmtree(uri, ignore_errors=True)


class KVStorage(StorageContext):
    """Remote checkpoint store over the cluster KV (namespace ``storage``).

    Layout: one KV key per file (``<root>/<ckpt>/<relpath>`` → bytes) plus
    a manifest key per checkpoint directory listing its files."""

    scheme = "memory"
    _NS = "storage"

    def __init__(self, root: str):
        # root like "memory://bucket/exp/run"
        self.root = root.rstrip("/")

    @staticmethod
    def _worker():
        from ray_tpu_torch.api import global_worker

        return global_worker()

    def upload_dir(self, local_dir: str, remote_rel: str) -> str:
        w = self._worker()
        uri = f"{self.root}/{remote_rel}"
        files = []
        for dirpath, _dirs, names in os.walk(local_dir):
            for name in names:
                full = os.path.join(dirpath, name)
                rel = os.path.relpath(full, local_dir)
                with open(full, "rb") as f:
                    w.kv_put(self._NS, f"{uri}/{rel}", f.read())
                files.append(rel)
        # The manifest write is LAST: a checkpoint is visible to
        # list_checkpoints only once complete, and listing derives from a
        # prefix scan (no read-modify-write index → concurrent commits from
        # multiple workers cannot lose each other).
        w.kv_put(self._NS, f"{uri}/.manifest", "\n".join(files).encode())
        return uri

    def download_dir(self, uri: str) -> str:
        w = self._worker()
        manifest = w.kv_get(self._NS, f"{uri}/.manifest")
        if manifest is None:
            raise FileNotFoundError(uri)
        local = tempfile.mkdtemp(prefix="rtpu_ckpt_dl_")
        for rel in manifest.decode().split("\n"):
            if not rel:
                continue
            data = w.kv_get(self._NS, f"{uri}/{rel}")
            dest = os.path.join(local, rel)
            os.makedirs(os.path.dirname(dest) or local, exist_ok=True)
            with open(dest, "wb") as f:
                f.write(data or b"")
        return local

    def list_checkpoints(self) -> List[str]:
        w = self._worker()
        keys = w.kv_keys(self._NS, prefix=f"{self.root}/checkpoint_")
        out = set()
        for key in keys:
            if key.endswith("/.manifest"):
                out.add(key[: -len("/.manifest")])
        return sorted(out)

    def delete(self, uri: str) -> None:
        w = self._worker()
        # Manifest first: the checkpoint disappears from listings before
        # its files go (the reverse of the upload ordering).
        manifest = w.kv_get(self._NS, f"{uri}/.manifest")
        w.kv_del(self._NS, f"{uri}/.manifest")
        if manifest is not None:
            for rel in manifest.decode().split("\n"):
                if rel:
                    w.kv_del(self._NS, f"{uri}/{rel}")


def get_storage(path: str) -> StorageContext:
    """Resolve a storage path/URI to its backend."""
    if path.startswith("memory://"):
        return KVStorage(path)
    if path.startswith("file://"):
        return LocalStorage(path[len("file://"):])
    return LocalStorage(path)


def join_path(base: str, *parts: str) -> str:
    if base.startswith("memory://"):
        return "/".join([base.rstrip("/")] + [p.strip("/") for p in parts])
    return os.path.join(base, *parts)


def is_remote_uri(path: Optional[str]) -> bool:
    return bool(path) and path.startswith("memory://")

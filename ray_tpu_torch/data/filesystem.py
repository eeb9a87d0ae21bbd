"""Pluggable filesystems for Data IO — local, in-cluster, and remote URIs.

Reference: ray ``python/ray/data/datasource/file_based_datasource.py`` +
``path_util.py`` — every datasource/datasink resolves paths through
pyarrow filesystems (fsspec-compatible), so ``gs://bucket/...`` and
``s3://...`` ride the same read/write code as local paths.  Here the
contract is a small scheme-keyed registry:

  - plain paths / ``file://`` → ``LocalFileSystem`` (os + glob);
  - ``memory://...`` → ``MemoryFileSystem`` over the cluster control
    plane's KV (namespace ``datafs``) — the in-cluster remote used by
    tests AND a real cross-node store: any worker can read blocks any
    other worker wrote, like an object-store bucket (the same backing
    the Train checkpoint layer's ``memory://`` storage uses);
  - other schemes (``gs://``, ``s3://``) → whatever the deployment
    registers via ``register_filesystem`` (zero-egress boxes can't
    reach real buckets; the seam is the point).

Readers that need a real OS path (tarfile, wave, cv2, pyarrow dataset
scans) call ``ensure_local`` — remote files materialize in a temp file,
local paths pass through untouched (the fsspec local-cache pattern).
Writers produce a local file then ``publish`` it to the destination URI.
"""

from __future__ import annotations

import fnmatch
import glob as _glob
import os
import shutil
import tempfile
from typing import Dict, List, Tuple

_SCHEME_SEP = "://"


def _scheme_of(path: str) -> str:
    i = path.find(_SCHEME_SEP)
    # Windows-style drive letters don't appear here; any single-token
    # prefix before :// is a scheme.
    return path[:i] if i > 0 else ""


class DataFileSystem:
    """Contract for a URI scheme.  All methods take FULL URIs."""

    def glob(self, pattern: str) -> List[str]:
        raise NotImplementedError

    def isdir(self, path: str) -> bool:
        raise NotImplementedError

    def makedirs(self, path: str) -> None:
        raise NotImplementedError

    def read_bytes(self, path: str) -> bytes:
        raise NotImplementedError

    def write_bytes(self, path: str, data: bytes) -> None:
        """Atomic whole-file write (the manifest-commit primitive)."""
        raise NotImplementedError

    def ensure_local(self, path: str) -> str:
        """A real OS path with this file's contents (identity for local)."""
        raise NotImplementedError

    def publish(self, local_file: str, dest: str) -> None:
        """Upload a finished local file to ``dest`` (no-op for local)."""
        raise NotImplementedError

    def join(self, base: str, *parts: str) -> str:
        return "/".join([base.rstrip("/")] + [p.strip("/") for p in parts])


class LocalFileSystem(DataFileSystem):
    @staticmethod
    def _strip(path: str) -> str:
        return path[len("file://"):] if path.startswith("file://") else path

    def glob(self, pattern: str) -> List[str]:
        return sorted(_glob.glob(self._strip(pattern)))

    def isdir(self, path: str) -> bool:
        return os.path.isdir(self._strip(path))

    def makedirs(self, path: str) -> None:
        os.makedirs(self._strip(path), exist_ok=True)

    def read_bytes(self, path: str) -> bytes:
        with open(self._strip(path), "rb") as f:
            return f.read()

    def write_bytes(self, path: str, data: bytes) -> None:
        p = self._strip(path)
        tmp = p + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, p)

    def ensure_local(self, path: str) -> str:
        return self._strip(path)

    def publish(self, local_file: str, dest: str) -> None:
        d = self._strip(dest)
        if os.path.abspath(local_file) != os.path.abspath(d):
            shutil.copyfile(local_file, d)

    def join(self, base: str, *parts: str) -> str:
        if base.startswith("file://"):
            return super().join(base, *parts)
        return os.path.join(base, *parts)


class MemoryFileSystem(DataFileSystem):
    """Cluster-KV-backed files (namespace ``datafs``), one key per file.

    Works from any driver or worker in the session — reads and writes go
    through the control plane, so a block written by one node is readable
    by every other (the test-and-CI stand-in for a bucket)."""

    _NS = "datafs"

    @staticmethod
    def _worker():
        from ray_tpu_torch.api import global_worker

        return global_worker()

    def _keys(self, prefix: str) -> List[str]:
        return self._worker().kv_keys(self._NS, prefix=prefix)

    def glob(self, pattern: str) -> List[str]:
        # Prefix scan up to the first wildcard, then match.
        cut = len(pattern)
        for ch in "*?[":
            i = pattern.find(ch)
            if i != -1:
                cut = min(cut, i)
        keys = self._keys(pattern[:cut])
        if cut == len(pattern):  # no wildcard: exact file or directory
            return sorted(
                k for k in keys
                if k == pattern or k.startswith(pattern.rstrip("/") + "/")
            )
        # Segment-wise fnmatch: raw fnmatch lets '*' cross '/', so
        # 'memory://dir/*' would also match files in nested
        # subdirectories — diverging from LocalFileSystem/glob semantics
        # and double-reading partitioned layouts (dir/part=0/f.parquet
        # matched by both the dir scan and the partition scan).
        parts = pattern.split("/")
        return sorted(
            k for k in keys
            if len(k.split("/")) == len(parts)
            and all(
                fnmatch.fnmatch(seg, pat)
                for seg, pat in zip(k.split("/"), parts)
            )
        )

    def isdir(self, path: str) -> bool:
        prefix = path.rstrip("/") + "/"
        return any(k.startswith(prefix) for k in self._keys(prefix))

    def makedirs(self, path: str) -> None:
        pass  # directories are implicit in key names

    def read_bytes(self, path: str) -> bytes:
        data = self._worker().kv_get(self._NS, path)
        if data is None:
            raise FileNotFoundError(path)
        return data

    def write_bytes(self, path: str, data: bytes) -> None:
        self._worker().kv_put(self._NS, path, bytes(data))

    # Per-process materialization cache: datafs blocks are write-once
    # (sinks never rewrite a part file), so one temp copy per path serves
    # every read task in this worker — without it, N row-group tasks over
    # one file would download N full copies, and pooled workers are
    # long-lived.  Entries unlink at interpreter exit.
    _local_cache: Dict[str, str] = {}

    def ensure_local(self, path: str) -> str:
        cached = self._local_cache.get(path)
        if cached is not None and os.path.exists(cached):
            return cached
        data = self.read_bytes(path)
        suffix = os.path.splitext(path)[1]
        fd, tmp = tempfile.mkstemp(prefix="rtpu_datafs_", suffix=suffix)
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        if not self._local_cache:
            import atexit

            atexit.register(MemoryFileSystem._purge_local_cache)
        self._local_cache[path] = tmp
        return tmp

    @staticmethod
    def _purge_local_cache():
        for tmp in MemoryFileSystem._local_cache.values():
            try:
                os.unlink(tmp)
            except OSError:
                pass
        MemoryFileSystem._local_cache.clear()

    def publish(self, local_file: str, dest: str) -> None:
        with open(local_file, "rb") as f:
            self.write_bytes(dest, f.read())


_REGISTRY: Dict[str, DataFileSystem] = {
    "": LocalFileSystem(),
    "file": LocalFileSystem(),
    "memory": MemoryFileSystem(),
}


def register_filesystem(scheme: str, fs: DataFileSystem) -> None:
    """Mount a filesystem for a URI scheme (``gs``, ``s3``, ...) —
    deployment hook, mirroring pyarrow's fsspec handler registration."""
    _REGISTRY[scheme] = fs


def resolve(path: str) -> Tuple[DataFileSystem, str]:
    scheme = _scheme_of(path)
    fs = _REGISTRY.get(scheme)
    if fs is None:
        raise ValueError(
            f"no filesystem registered for scheme {scheme!r} "
            f"(path {path!r}); call "
            "ray_tpu_torch.data.filesystem.register_filesystem("
            f"{scheme!r}, fs) to mount one"
        )
    return fs, path


def is_uri(path: str) -> bool:
    return bool(_scheme_of(path))


def ensure_local(path: str) -> str:
    fs, p = resolve(path)
    return fs.ensure_local(p)


def fs_join(base: str, *parts: str) -> str:
    fs, b = resolve(base)
    return fs.join(b, *parts)

"""Async per-leaf checkpointing for nested dicts of tensors.

The port's counterpart of ``ray_tpu/train/jax_ckpt.py``: the same three
entry points (``save_sharded``, ``async_save_sharded`` with its
``AsyncSave`` handle, ``restore_sharded``) over a nested dict (or list) of
torch tensors, such as an ``nn.Module``'s ``state_dict()`` or an
optimizer's.  Each leaf is written as its raw bytes, with its dtype name
and shape in the manifest (numpy has no bfloat16, so bf16 round-trips bit
for bit).  The device-to-host copy happens on the caller's thread, so
training may update the tensors as soon as the call returns; the disk
writes of ``async_save_sharded`` run on a background thread.
``restore_sharded(..., device=)`` places the leaves.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional

_MANIFEST = "pytree.json"


def _flatten_with_paths(tree):
    """``[(name, leaf)]`` in tree order, with the JAX checkpoint's leaf
    names (path keys joined by ``_``), and the tree's structure."""
    from torch.utils import _pytree as pytree

    leaves_with_paths, treedef = pytree.tree_flatten_with_path(tree)
    out = []
    for path, leaf in leaves_with_paths:
        name = "_".join(
            str(getattr(p, "key", getattr(p, "idx", p))) for p in path
        )
        out.append((name or "leaf", leaf))
    return out, treedef


def _to_host(tree):
    """Copy every tensor leaf to the host now: ``(manifest, [(name,
    bytes)])``.  Leaves that are no tensor (an optimizer's learning rate,
    its betas) are kept in the manifest as JSON values."""
    import torch

    from ..core.serialization import tensor_host_bytes

    named, treedef = _flatten_with_paths(tree)
    host, leaves = [], []
    for name, leaf in named:
        if not isinstance(leaf, torch.Tensor):
            leaves.append({"name": name, "value": leaf})
            continue
        copy = leaf.detach().to("cpu", copy=True)
        host.append((name, tensor_host_bytes(copy)))
        leaves.append({"name": name, "dtype": str(copy.dtype),
                       "shape": list(copy.shape)})
    return {"leaves": leaves, "treedef": str(treedef)}, host


def _write(directory: str, manifest: dict, host) -> None:
    os.makedirs(directory, exist_ok=True)
    for name, raw in host:
        raw.tofile(os.path.join(directory, f"{name}.bin"))
    with open(os.path.join(directory, _MANIFEST), "w") as f:
        json.dump(manifest, f)


def save_sharded(tree, directory: str) -> None:
    """Synchronous save: one raw-bytes file per leaf + manifest."""
    _write(directory, *_to_host(tree))


class AsyncSave:
    """Handle for an in-flight background save; ``wait()`` before
    committing the checkpoint directory.  ``host_copy_s`` is the caller's
    part (the device-to-host copy), ``write_s`` the background thread's
    (set when it finishes)."""

    def __init__(self, thread: threading.Thread, host_copy_s: float = 0.0):
        self._thread = thread
        self.error: Optional[BaseException] = None
        self.host_copy_s = host_copy_s
        self.write_s: Optional[float] = None

    def wait(self, timeout: Optional[float] = None) -> None:
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError("async checkpoint save still running")
        if self.error is not None:
            raise self.error


def async_save_sharded(tree, directory: str) -> AsyncSave:
    """Device→host transfer happens NOW (so training may update the
    tensors immediately after return); the file writes run on a thread."""
    t0 = time.perf_counter()
    manifest, host = _to_host(tree)
    handle_box = {}

    def write():
        t1 = time.perf_counter()
        try:
            _write(directory, manifest, host)
        except BaseException as e:  # noqa: BLE001 — surfaced via wait()
            handle_box["handle"].error = e
        handle_box["handle"].write_s = time.perf_counter() - t1

    thread = threading.Thread(target=write, daemon=True, name="ckpt-write")
    handle = AsyncSave(thread, host_copy_s=time.perf_counter() - t0)
    handle_box["handle"] = handle
    thread.start()
    return handle


def restore_sharded(tree_like, directory: str, device=None):
    """Restore into the structure of ``tree_like``; leaves land on
    ``device`` (each on its ``tree_like`` leaf's device when None)."""
    from torch.utils import _pytree as pytree

    from ..core.serialization import tensor_from_bytes

    with open(os.path.join(directory, _MANIFEST)) as f:
        saved = {leaf["name"]: leaf for leaf in json.load(f)["leaves"]}
    named, treedef = _flatten_with_paths(tree_like)
    restored = []
    for name, like in named:
        meta = saved[name]
        if "value" in meta:
            restored.append(meta["value"])
            continue
        with open(os.path.join(directory, f"{name}.bin"), "rb") as f:
            data = f.read()
        restored.append(tensor_from_bytes(
            data, meta["dtype"], meta["shape"],
            device=like.device if device is None else device,
        ))
    return pytree.tree_unflatten(restored, treedef)

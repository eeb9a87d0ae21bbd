"""Runtime environments — per-task/actor working_dir, py_modules, env_vars.

Role-equivalent of the reference's runtime-env subsystem
(``python/ray/_private/runtime_env/``: plugins for working_dir/py_modules/
env_vars, URI-cached packages).  TPU-native simplification: no per-node HTTP
agent process — packaging happens in the driver (content-addressed staging
into a shared cache directory) and application happens in the worker process
at startup.  The staged-package path rides the worker's env (the analog of
the reference shipping runtime-env URIs in the task spec and resolving them
through the agent), so it participates in the worker pool's env-key and
workers are cached per runtime env exactly like the reference's
per-(language, runtime-env-hash) worker pool (``raylet/worker_pool.h:281``).

Supported keys (the reference's most-used subset):
  - ``env_vars``: dict of str → str set in the worker process.
  - ``working_dir``: local directory, staged by content hash; worker chdirs
    into the staged copy and prepends it to ``sys.path``.
  - ``py_modules``: list of local dirs/files staged the same way and
    prepended to ``sys.path``.

``pip`` envs build a real virtualenv per requirements set, keyed by the
hash of the requirement list, cached and reused across tasks/actors/jobs
(the reference's most-used isolation mode after working_dir; ray
``_private/runtime_env/pip.py``).  Workers for a pip env run under the
venv's interpreter; ``--system-site-packages`` keeps the image's baked-in
stack (jax et al.) visible, exactly like the reference's virtualenv
inheritance.

``conda`` envs resolve an existing named env, an ``environment.yml``
path, or an inline spec dict to that env's interpreter (hash-cached like
pip; ray ``_private/runtime_env/conda.py``).  ``container``/``image_uri``
wrap the worker command in ``podman run``/``docker run`` with host
network/pid/ipc and the session + shm dirs mounted (ray
``_private/runtime_env/image_uri.py``); both are gated on the container
binary being present on PATH.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import shutil
import subprocess
import sys
import tempfile
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)

# Env vars used to ship the resolved env to the worker process.
WORKING_DIR_ENV = "RAY_TPU_TORCH_RT_WORKING_DIR"
PY_MODULES_ENV = "RAY_TPU_TORCH_RT_PY_MODULES"
VENV_PY_ENV = "RAY_TPU_TORCH_RT_VENV_PY"
CONTAINER_ENV = "RAY_TPU_TORCH_RT_CONTAINER"


def _cache_root() -> str:
    root = os.environ.get(
        "RAY_TPU_TORCH_LOG_DIR",
        os.path.join(tempfile.gettempdir(), "ray_tpu_torch"))
    return os.path.join(root, "runtime_env_cache")


def _hash_path(path: str) -> str:
    """Content hash of a file or directory tree (names + bytes)."""
    h = hashlib.sha1()
    if os.path.isfile(path):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
        return h.hexdigest()
    for dirpath, dirnames, filenames in os.walk(path):
        # Prune before descent (must mutate in place, pre-sort) and never
        # hash/stage caches — the reference excludes these too.
        dirnames[:] = sorted(
            d for d in dirnames if d not in ("__pycache__", ".git")
        )
        for name in sorted(filenames):
            full = os.path.join(dirpath, name)
            rel = os.path.relpath(full, path)
            h.update(rel.encode())
            try:
                with open(full, "rb") as f:
                    for chunk in iter(lambda: f.read(1 << 20), b""):
                        h.update(chunk)
            except OSError:
                continue
    return h.hexdigest()


def package_path(path: str) -> str:
    """Stage ``path`` into the content-addressed cache; returns staged path.

    Idempotent: same content → same cache entry (the analog of the
    reference's GCS-KV URI cache for working_dir/py_modules packages).
    """
    path = os.path.abspath(os.path.expanduser(path))
    if not os.path.exists(path):
        raise FileNotFoundError(f"runtime_env path does not exist: {path}")
    digest = _hash_path(path)
    base = os.path.basename(path.rstrip("/")) or "pkg"
    # Stage under a digest directory, keeping the original basename — imports
    # of a staged package need the module's own name on disk.
    staged = os.path.join(_cache_root(), digest[:16], base)
    if os.path.exists(staged):
        return staged
    tmp = f"{staged}.tmp.{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(os.path.dirname(tmp), exist_ok=True)
    if os.path.isdir(path):
        shutil.copytree(
            path, tmp,
            ignore=shutil.ignore_patterns("__pycache__", ".git"),
        )
    else:
        shutil.copy2(path, tmp)
    try:
        os.rename(tmp, staged)
    except OSError:
        # Lost a concurrent staging race; the winner's copy is equivalent.
        shutil.rmtree(tmp, ignore_errors=True)
    return staged


def _normalize_pip(spec) -> Dict[str, Any]:
    """``pip`` accepts a list of requirements or
    ``{"packages": [...], "pip_install_options": [...]}``."""
    if isinstance(spec, (list, tuple)):
        return {"packages": [str(p) for p in spec], "pip_install_options": []}
    if isinstance(spec, dict):
        return {
            "packages": [str(p) for p in spec.get("packages", [])],
            "pip_install_options": [
                str(o) for o in spec.get("pip_install_options", [])
            ],
        }
    raise TypeError("runtime_env['pip'] must be a list or a dict")


def build_pip_env(spec) -> str:
    """Build (or reuse) the virtualenv for a pip spec; returns the venv's
    python path.  Keyed by the hash of (sorted packages, options); builds
    are serialized per key with an flock so concurrent drivers/agents
    never interleave writes into one venv."""
    norm = _normalize_pip(spec)
    if not norm["packages"]:
        return sys.executable
    digest = hashlib.sha1(
        json.dumps(
            [sorted(norm["packages"]), norm["pip_install_options"]]
        ).encode()
    ).hexdigest()[:16]
    venv_dir = os.path.join(_cache_root(), "venvs", digest)
    py = os.path.join(venv_dir, "bin", "python")
    ready = os.path.join(venv_dir, ".ready")
    if os.path.exists(ready):
        return py
    import fcntl

    os.makedirs(os.path.dirname(venv_dir), exist_ok=True)
    with open(venv_dir + ".lock", "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        if os.path.exists(ready):
            return py
        shutil.rmtree(venv_dir, ignore_errors=True)
        # --system-site-packages: the image's baked-in stack stays visible;
        # the venv only ADDS the requested packages (reference semantics).
        subprocess.run(
            [sys.executable, "-m", "venv", "--system-site-packages", venv_dir],
            check=True, capture_output=True, timeout=300,
        )
        # When the driver itself runs inside a venv, --system-site-packages
        # inherits the BASE interpreter's site, not the driver venv's —
        # bridge the driver's actual site-packages with a .pth so the
        # image's stack (jax, cloudpickle, ...) stays importable.
        import site
        import sysconfig

        new_site = sysconfig.get_path(
            "purelib", vars={"base": venv_dir, "platbase": venv_dir}
        )
        parent_paths = [
            p for p in site.getsitepackages() if os.path.isdir(p)
        ]
        if parent_paths and os.path.isdir(new_site):
            with open(os.path.join(new_site, "_rtpu_parent_site.pth"), "w") as f:
                f.write("\n".join(parent_paths) + "\n")
        cmd = (
            [py, "-m", "pip", "install", "--disable-pip-version-check"]
            + norm["pip_install_options"]
            + norm["packages"]
        )
        proc = subprocess.run(
            cmd, capture_output=True, text=True, timeout=1800
        )
        if proc.returncode != 0:
            shutil.rmtree(venv_dir, ignore_errors=True)
            raise RuntimeError(
                f"pip runtime_env build failed: {proc.stderr[-2000:]}"
            )
        with open(ready, "w") as f:
            f.write(digest)
    return py


def _conda_binary() -> Optional[str]:
    for name in ("conda", "mamba", "micromamba"):
        path = shutil.which(name)
        if path:
            return path
    return None


def build_conda_env(spec) -> str:
    """Resolve a conda runtime env to its python interpreter.

    Reference: ``python/ray/_private/runtime_env/conda.py`` — three spec
    shapes: an existing env NAME, a path to an ``environment.yml``, or an
    inline dict (written to a yml).  Created envs are cached per content
    hash like pip venvs.  Gated: raises a clear error when no conda-like
    binary (conda/mamba/micromamba) is on PATH.
    """
    conda = _conda_binary()
    if conda is None:
        raise RuntimeError(
            "runtime_env['conda'] requires a conda/mamba/micromamba binary "
            "on PATH; none found on this host"
        )

    def env_python(prefix: str) -> str:
        return os.path.join(prefix, "bin", "python")

    if isinstance(spec, str) and not spec.endswith((".yml", ".yaml")):
        # Existing named env: ask conda where it lives.
        proc = subprocess.run(
            [conda, "env", "list", "--json"],
            capture_output=True, text=True, timeout=120,
        )
        if proc.returncode == 0:
            for prefix in json.loads(proc.stdout).get("envs", []):
                if os.path.basename(prefix) == spec:
                    return env_python(prefix)
        raise RuntimeError(f"conda env {spec!r} not found")

    if isinstance(spec, str):
        with open(spec, "rb") as f:
            content = f.read()
    else:
        # Inline dict -> minimal YAML (dependencies / channels lists).
        lines = []
        for key in ("name", "channels", "dependencies"):
            val = spec.get(key)
            if val is None:
                continue
            if isinstance(val, list):
                lines.append(f"{key}:")
                lines.extend(f"  - {v}" for v in val)
            else:
                lines.append(f"{key}: {val}")
        content = ("\n".join(lines) + "\n").encode()

    digest = hashlib.sha1(content).hexdigest()[:16]
    prefix = os.path.join(_cache_root(), "conda", digest)
    ready = os.path.join(prefix, ".ready")
    if os.path.exists(ready):
        return env_python(prefix)
    import fcntl

    os.makedirs(os.path.dirname(prefix), exist_ok=True)
    with open(prefix + ".lock", "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        if os.path.exists(ready):
            return env_python(prefix)
        shutil.rmtree(prefix, ignore_errors=True)
        yml = prefix + ".yml"
        with open(yml, "wb") as f:
            f.write(content)
        proc = subprocess.run(
            [conda, "env", "create", "-p", prefix, "-f", yml],
            capture_output=True, text=True, timeout=1800,
        )
        if proc.returncode != 0:
            shutil.rmtree(prefix, ignore_errors=True)
            raise RuntimeError(
                f"conda runtime_env build failed: {proc.stderr[-2000:]}"
            )
        with open(ready, "w") as f:
            f.write(digest)
    return env_python(prefix)


def _container_binary() -> Optional[str]:
    for name in ("podman", "docker"):
        path = shutil.which(name)
        if path:
            return path
    return None


def resolve_container_spec(spec) -> str:
    """Normalize a container runtime env to the JSON shipped to the agent.

    Reference: ``python/ray/_private/runtime_env/image_uri.py`` — the
    worker command is wrapped in ``podman run`` with host network/pid/ipc
    so the container shares the node's data plane (shm arena, TCP
    control plane).  Accepts ``"image:tag"`` or ``{"image": ...,
    "run_options": [...]}``.  A driver host without podman/docker only
    WARNS — containers run on worker nodes, whose agents re-resolve the
    runtime authoritatively (``container_argv``).
    """
    if isinstance(spec, str):
        spec = {"image": spec}
    image = spec.get("image")
    if not image or not isinstance(image, str):
        raise ValueError(
            "runtime_env['container'] needs an 'image' (or use "
            "runtime_env['image_uri'])"
        )
    unknown = set(spec) - {"image", "run_options"}
    if unknown:
        raise ValueError(
            f"unknown runtime_env['container'] keys: {sorted(unknown)}"
        )
    # Probe the DRIVER's PATH for an early heads-up — but ship only the
    # binary NAME: agents on other nodes re-resolve against their own
    # PATH in container_argv (a driver's /usr/bin/podman may be
    # /usr/local/bin/docker on an autoscaled worker host).  A missing
    # driver-side runtime is a WARNING, not an error: containers only
    # run on worker nodes, so a head node without podman/docker must not
    # false-fail a runtime_env that every worker host can satisfy — the
    # agent-side re-resolution stays the authoritative gate.
    binary = _container_binary()
    if binary is None:
        logger.warning(
            "runtime_env['container']: no podman or docker on this "
            "driver's PATH; deferring to each worker node's agent "
            "(a worker host without a container runtime will fail the "
            "lease there)"
        )
        binary = "podman"
    run_options = list(spec.get("run_options") or [])
    if not all(isinstance(o, str) for o in run_options):
        raise ValueError("container run_options must be a list of strings")
    return json.dumps(
        {
            "binary": os.path.basename(binary),
            "image": image,
            "run_options": run_options,
        }
    )


def container_argv(container_json: str, worker_env: Dict[str, str],
                   base_argv: List[str]) -> List[str]:
    """Agent side: wrap a worker command in its container runtime.

    Host network/pid/ipc keep the worker on the node's control plane and
    shm arena; the session dir, /dev/shm, and the framework source are
    mounted so the image needs python but not a baked-in ray_tpu_torch.
    RAY_TPU_TORCH_* identity vars are forwarded explicitly (podman run strips
    the inherited environment), and so is the worker's GPU lease,
    ``CUDA_VISIBLE_DEVICES``, even when it is empty: a lease of no card
    stays a lease of no card inside the container.
    """
    from .gpu_detect import VISIBLE_ENV

    spec = json.loads(container_json)
    # Re-resolve the runtime on THIS host (the spec carries the driver's
    # preferred name; this agent may have it elsewhere on PATH, or only
    # the other runtime).
    binary = (
        shutil.which(spec["binary"])
        or _container_binary()
    )
    if binary is None:
        raise RuntimeError(
            f"container runtime {spec['binary']!r} not found on this "
            "node's PATH (and no podman/docker fallback)"
        )
    log_dir = os.environ.get(
        "RAY_TPU_TORCH_LOG_DIR",
        os.path.join(tempfile.gettempdir(), "ray_tpu_torch"))
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    argv = [
        binary, "run", "--rm",
        "--network=host", "--pid=host", "--ipc=host",
        "-v", f"{log_dir}:{log_dir}",
        "-v", "/dev/shm:/dev/shm",
        "-v", f"{pkg_root}:{pkg_root}:ro",
    ]
    fwd = {
        k: v for k, v in worker_env.items()
        if k.startswith(("RAY_TPU", "PYTHON", "JAX_", "XLA_", "TPU"))
        or k == VISIBLE_ENV
    }
    fwd["PYTHONPATH"] = (
        pkg_root + os.pathsep + worker_env.get("PYTHONPATH", "")
    ).rstrip(os.pathsep)
    for k, v in sorted(fwd.items()):
        argv += ["--env", f"{k}={v}"]
    argv += spec["run_options"]
    argv.append(spec["image"])
    # Inside the image: plain `python` (the venv-interpreter override is a
    # host path and does not exist in the container).
    argv += ["python"] + base_argv[1:]
    return argv


def resolve_runtime_env(runtime_env: Optional[Dict[str, Any]]) -> Dict[str, str]:
    """Driver side: normalize a runtime_env dict into worker env vars.

    Returns the env-var dict that fully describes the environment (and hence
    keys the worker pool's idle cache).
    """
    if not runtime_env:
        return {}
    unknown = set(runtime_env) - {
        "env_vars", "working_dir", "py_modules", "pip", "uv", "conda",
        "container", "image_uri",
    }
    if unknown:
        raise ValueError(f"unknown runtime_env keys: {sorted(unknown)}")
    env: Dict[str, str] = dict(runtime_env.get("env_vars") or {})
    for k, v in env.items():
        if not isinstance(k, str) or not isinstance(v, str):
            raise TypeError("runtime_env['env_vars'] must be Dict[str, str]")
    wd = runtime_env.get("working_dir")
    if wd:
        env[WORKING_DIR_ENV] = package_path(wd)
    mods: List[str] = []
    for m in runtime_env.get("py_modules") or []:
        mods.append(package_path(m))
    if mods:
        env[PY_MODULES_ENV] = json.dumps(mods)
    # "uv" shares the venv path (the reference's uv plugin mirrors pip's
    # contract; the installer binary differs, which we don't ship).
    pip_spec = runtime_env.get("pip") or runtime_env.get("uv")
    if pip_spec:
        env[VENV_PY_ENV] = build_pip_env(pip_spec)
    conda_spec = runtime_env.get("conda")
    if conda_spec:
        if pip_spec:
            raise ValueError(
                "runtime_env cannot combine 'conda' with 'pip'/'uv' — the "
                "conda env owns the interpreter (put pip deps in the conda "
                "spec's dependencies)"
            )
        env[VENV_PY_ENV] = build_conda_env(conda_spec)
    container_spec = runtime_env.get("container")
    if runtime_env.get("image_uri"):
        if container_spec:
            raise ValueError(
                "runtime_env cannot combine 'container' with 'image_uri' "
                "(image_uri is shorthand for container={'image': ...})"
            )
        container_spec = {"image": runtime_env["image_uri"]}
    if container_spec:
        if pip_spec or conda_spec:
            raise ValueError(
                "runtime_env cannot combine 'container' with 'pip'/'uv'/"
                "'conda' — the image owns the interpreter (bake deps into "
                "the image)"
            )
        env[CONTAINER_ENV] = resolve_container_spec(container_spec)
    return env


def apply_runtime_env_in_worker() -> None:
    """Worker side: chdir into the staged working_dir, extend sys.path."""
    wd = os.environ.get(WORKING_DIR_ENV)
    if wd and os.path.isdir(wd):
        os.chdir(wd)
        if wd not in sys.path:
            sys.path.insert(0, wd)
    mods = os.environ.get(PY_MODULES_ENV)
    if mods:
        for m in json.loads(mods):
            # m is <cache>/<digest>/<module-name>; importing needs the parent.
            parent = os.path.dirname(m)
            if parent not in sys.path:
                sys.path.insert(0, parent)

"""Copy guard: the port's runtime is the JAX package's, name for name.

Every runtime module of ``ray_tpu_torch`` is its ``ray_tpu`` twin after two
name normalisations (``ray_tpu`` → ``ray_tpu_torch`` as a word, and the
``RAY_TPU_`` env and config prefix → ``RAY_TPU_TORCH_``), except the files
listed in ``DIVERGES``, each with the reason it differs and a digest of
its diff against the twin.  The digest pins the divergence: any further
change on either side (a fix made in the JAX twin and not carried over, an
edit to the port) changes the diff and fails until the new diff is
reviewed and its digest, which the failure prints, is written down.  A
listed file that no longer differs fails too, so the list stays exact; a
module of ``ray_tpu/{core,data,serve,util}`` with no twin must be listed
in ``WAITING`` with the ROADMAP item it waits for, and a port module with
no twin in ``PORT_ONLY``.
"""

import difflib
import hashlib
import os
import re

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(REPO, "ray_tpu")
PORT_PKG = os.path.join(REPO, "ray_tpu_torch")

# The runtime's files, relative to each package root.
RUNTIME_DIRS = ("core", "data", "serve", "util", "util/state")
RUNTIME_FILES = ("__init__.py", "_version.py", "api.py",
                 "collective/device_objects.py", "collective/p2p.py")

# rel: (why it differs, digest of its pinned diff)
DIVERGES = {
    "__init__.py": ("the port's package docstring; its public names, "
                    "`resolve_device` (torch) among them, resolve lazily, "
                    "and it has no `dag` yet", "bb3a882fcce3f148"),
    "collective/device_objects.py": ("torch tensors in place of jax.Arrays; "
                                     "no collective-group fetch (A4)",
                                     "2c51e21bee5b0b1b"),
    "core/accelerators.py": ("registers GPUAcceleratorManager",
                             "287f24ea863394d3"),
    "core/api_frontend.py": ("`.bind()` raises: dag waits for A1d",
                             "dda678c0e2a00cfc"),
    "core/core_worker.py": ("device-object wrap/unwrap over torch's pytree "
                            "and CUDA tensors; tensors are not cached as "
                            "given on put; the dag exec loop waits for A1d; "
                            "profiles go under the temp dir, not /tmp",
                            "febbabffda5babc7"),
    "core/node.py": ("head info under the temp dir, not /tmp, so checkouts "
                     "with their own TMPDIR never share a head",
                     "c95c58f74848fc87"),
    "core/node_agent.py": ("CUDA_VISIBLE_DEVICES isolation of GPU leases; "
                           "default log dir under the temp dir, not /tmp",
                           "d1bc0a920219a264"),
    "core/runtime_env.py": ("default log dir and env cache under the temp "
                            "dir, not /tmp", "72776c185afcefc9"),
    "data/execution.py": ("`num_gpus` lease in place of `num_tpus`",
                          "2923c0f2ba820550"),
    "data/streaming.py": ("`num_gpus` lease in place of `num_tpus`",
                          "0ad19844827d703e"),
    "core/serialization.py": ("torch.Tensor carriers (raw bytes, dtype "
                              "name, shape) in place of jax.Array → numpy",
                              "f73e056089061164"),
    "util/flight_recorder.py": ("synchronizes CUDA streams in place of "
                                "jax.block_until_ready; the collective "
                                "algorithms and tuner raise (A4)",
                                "ac97eb8242831d71"),
    "util/remediation.py": ("collective re-probe raises (A4)",
                            "f323f8d9131a4c35"),
}

# Modules of ray_tpu/{core,data,serve,util} that the port has not copied yet, by the
# ROADMAP item they wait for.
WAITING = {}

PORT_ONLY = {
    "core/gpu_detect.py": "NVIDIA GPU detection, beside tpu_detect.py",
}


def normalise(text):
    text = re.sub(r"\bray_tpu\b", "ray_tpu_torch", text)
    return text.replace("RAY_TPU_", "RAY_TPU_TORCH_")


def _modules(pkg):
    found = set()
    for d in RUNTIME_DIRS:
        for f in os.listdir(os.path.join(pkg, d)):
            if f.endswith(".py"):
                found.add(f"{d}/{f}")
    return found


TWINS = sorted((_modules(JAX_PKG) & _modules(PORT_PKG))
               | set(RUNTIME_FILES))


def _read(pkg, rel):
    with open(os.path.join(pkg, rel)) as f:
        return f.read()


def divergence(rel):
    """The port file's changes against its normalised twin: a unified diff
    without its file names and hunk positions, so an edit made alike on
    both sides leaves it as it was."""
    want = normalise(_read(JAX_PKG, rel)).splitlines(True)
    got = _read(PORT_PKG, rel).splitlines(True)
    lines = difflib.unified_diff(want, got, n=0)
    return "".join(l for l in lines
                   if not l.startswith(("---", "+++", "@@")))


def digest(diff):
    return hashlib.sha256(diff.encode()).hexdigest()[:16]


@pytest.mark.parametrize("rel", TWINS)
def test_twin_is_a_copy_or_listed(rel):
    diff = divergence(rel)
    if rel not in DIVERGES:
        assert not diff, f"{rel} diverges and is not listed:\n{diff[:4000]}"
        return
    assert diff, (
        f"{rel} no longer diverges from its twin: drop it from DIVERGES")
    _, pinned = DIVERGES[rel]
    assert digest(diff) == pinned, (
        f"{rel}'s divergence changed (digest {digest(diff)}, pinned "
        f"{pinned}); review the diff, then pin the new digest:\n"
        f"{diff[:8000]}")


def test_every_jax_runtime_module_has_a_twin_or_waits():
    missing = _modules(JAX_PKG) - _modules(PORT_PKG)
    assert missing == set(WAITING), sorted(missing ^ set(WAITING))
    assert all(re.fullmatch(r"A\d\w*", item) for item in WAITING.values())


def test_port_only_modules_are_listed():
    extra = _modules(PORT_PKG) - _modules(JAX_PKG)
    assert extra == set(PORT_ONLY), sorted(extra ^ set(PORT_ONLY))


def test_lists_name_real_files_with_reasons():
    for rel, (reason, pinned) in DIVERGES.items():
        assert rel in TWINS and reason.strip(), rel
        assert re.fullmatch(r"[0-9a-f]{16}", pinned), rel
    for rel in PORT_ONLY:
        assert os.path.exists(os.path.join(PORT_PKG, rel)), rel


def test_normalise_moves_names_and_prefixes_once():
    text = ('import ray_tpu\nfrom ray_tpu.core import x  # ray_tpu_torch\n'
            'os.environ["RAY_TPU_LOG_DIR"]; "/tmp/ray_tpu/head_info.json"')
    assert normalise(text) == (
        'import ray_tpu_torch\nfrom ray_tpu_torch.core import x  '
        '# ray_tpu_torch\nos.environ["RAY_TPU_TORCH_LOG_DIR"]; '
        '"/tmp/ray_tpu_torch/head_info.json"')

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
module of ``ray_tpu/{autoscaler,collective,core,dag,data,devtools,job,
scripts,serve,train,tune,util}`` with no twin
must be listed in ``WAITING`` with the ROADMAP item it waits for, or in
``COUNTERPARTS`` beside the port module that takes its place under another
name, and a port module with no twin in ``PORT_ONLY``.
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
RUNTIME_DIRS = ("autoscaler", "collective", "core", "dag", "data",
                "devtools", "job", "scripts", "serve", "train", "tune",
                "util", "util/state")
RUNTIME_FILES = ("__init__.py", "__main__.py", "_version.py", "api.py",
                 "collective/device_objects.py", "collective/p2p.py",
                 "dashboard.py", "dashboard_ui.py",
                 # RLlib's host-side modules, copied with the name moves.
                 "rllib/actor_manager.py", "rllib/connectors.py",
                 "rllib/offline.py", "rllib/replay.py")

# rel: (why it differs, digest of its pinned diff)
DIVERGES = {
    "autoscaler/command_runner.py": ("the default stop command matches the "
                                     "port's `ray_tpu_torch.core` processes, "
                                     "which the JAX package's "
                                     "`[r]ay_tpu[.]core` never matches",
                                     "f52b637396a69aac"),
    "autoscaler/provider.py": ("a fake node registers a card only where its "
                               "node type names GPU (the port's Node merges "
                               "the host's detected card); GCEGPUProvider "
                               "makes GPU VMs in place of GKETPUProvider's "
                               "TPU VMs", "5af630f49f5011ae"),
    "__init__.py": ("the port's package docstring; its public names, "
                    "`resolve_device` (torch) among them, and the `api` "
                    "module resolve lazily beside the lazy `dag`",
                    "44e1f43380665e53"),
    "collective/__init__.py": ("exports LocalGroup and DistGroup, the "
                               "groups' classes, and RemoteDeviceObjectError",
                               "64c469fc67764e8e"),
    "collective/algorithms.py": ("the algorithms over each group's exchange "
                                 "(`Comm`: per-rank tensor lists or "
                                 "send/recv) in place of shard_map bodies, "
                                 "same step schedules; quantization on "
                                 "tensors; torch dtype names",
                                 "2f0ddaf5862560ce"),
    "collective/bench_collective.py": ("stages over a LocalGroup on the card "
                                       "(or `--device`), and op_bandwidth "
                                       "for any group, in place of jitted "
                                       "shard_maps on a virtual CPU mesh",
                                       "6ea775b5c546e985"),
    "collective/collective.py": ("GroupManager makes LocalGroup or "
                                 "DistGroup; nccl is the default backend; "
                                 "collective_stats adds gloo's host-staged "
                                 "bytes; send carries torch tensors as they "
                                 "are", "6368329f7b3dc572"),
    "collective/device_objects.py": ("torch tensors in place of jax.Arrays; "
                                     "the collective-group fetch lands in a "
                                     "buffer on the group's device",
                                     "7f8853b33c864750"),
    "collective/experimental.py": ("a local group's ranks on `device` (the "
                                   "card unless named) in place of "
                                   "jax.devices()", "dcba212bdf9a837e"),
    "collective/local_group.py": ("LocalGroup: per-rank torch tensors and "
                                  "device copies in place of LocalXlaGroup's "
                                  "jitted shard_maps", "1feb5d65c49ffc91"),
    "collective/types.py": ("Backend is nccl/gloo/local; the shard_map "
                            "helpers are gone (their work is in the groups)",
                            "fe5cdb67fe8c8233"),
    "core/accelerators.py": ("registers GPUAcceleratorManager",
                             "287f24ea863394d3"),
    "core/core_worker.py": ("device-object wrap/unwrap over torch's pytree "
                            "and CUDA tensors; tensors are not cached as "
                            "given on put; profiles go under the temp dir, "
                            "not /tmp", "ff8d15eea3a6fff1"),
    "core/placement.py": ("chip counts ask for GPU bundles, SPREAD for "
                          "pipeline stages and Podracer roles; "
                          "accelerator_version raises (a GPU node carries "
                          "its model as a label, no TPU-<version> "
                          "resource)", "2738898380127b98"),
    "core/node.py": ("head info under the temp dir, not /tmp, so checkouts "
                     "with their own TMPDIR never share a head",
                     "c95c58f74848fc87"),
    "core/node_agent.py": ("CUDA_VISIBLE_DEVICES isolation of GPU leases; "
                           "default log dir under the temp dir, not /tmp",
                           "d1bc0a920219a264"),
    "core/runtime_env.py": ("default log dir and env cache under the temp "
                            "dir, not /tmp; a container worker keeps its "
                            "GPU lease (CUDA_VISIBLE_DEVICES forwarded, "
                            "empty included)", "c57f2284923b9d32"),
    "dag/collective_ops.py": ("the host path reduces torch tensors in "
                              "participant order on the card where one of "
                              "them is; numpy keeps numpy's path",
                              "6af13004eeb08010"),
    "dag/worker_loop.py": ("the group path takes LocalGroup's per-rank "
                           "list or a DistGroup rank's own tensor, and "
                           "returns the group's tensor",
                           "ae07afe435c228d1"),
    "job/sdk.py": ("job logs under the temp dir, not /tmp; the docstring "
                   "says the entrypoint sees no card",
                   "49164317b4a263a6"),
    "scripts/cli.py": ("the program is ray-tpu-torch; --resources' example "
                       "names GPU", "03f24f4149145d33"),
    "devtools/lint.py": ("the metric-name rule (RTL004) does not take the "
                         "package's own name `ray_tpu_torch` (a module path, "
                         "a log directory) for a metric; `ray_tpu_torch_*` "
                         "names are still checked; the docstring and a "
                         "section comment name no change-request history",
                         "b6504a6f3f463baf"),
    "data/execution.py": ("`num_gpus` lease in place of `num_tpus`",
                          "2923c0f2ba820550"),
    "data/streaming.py": ("`num_gpus` lease in place of `num_tpus`",
                          "0ad19844827d703e"),
    "core/serialization.py": ("torch.Tensor carriers (raw bytes, dtype "
                              "name, shape) in place of jax.Array → numpy",
                              "f73e056089061164"),
    "util/flight_recorder.py": ("synchronizes CUDA streams in place of "
                                "jax.block_until_ready",
                                "f1490ad47578784a"),
    "util/tracing.py": ("the in-process span recorder (`recording`, "
                        "`SpanRecord`, `Recorder`) that the port's serving "
                        "path records into", "12ae6c33064ab339"),
    "train/__init__.py": ("no JaxBackend and JaxTrainer (TorchBackend and "
                          "TorchTrainer take their role)", "b797446bd11bd7a7"),
    "train/backend.py": ("TorchBackend picks nccl or gloo by the workers' "
                         "card leases, as asked otherwise; no JaxBackend",
                         "e23b21cce8f59e6e"),
    "train/config.py": ("ScalingConfig leases GPUs (use_gpu, "
                        "gpus_per_worker) in place of TPU chips",
                        "4594720ffd68a5df"),
    "train/pipeline.py": ("chunks on tensors: forward without autograd, "
                          "backward by recomputing under autograd, "
                          "torch.optim.AdamW with optax.adamw's defaults; "
                          "per-chunk GPT-2 init from a torch.Generator; "
                          "q8 on tensors; DP over a LocalGroup; stages run "
                          "on their leased card (num_gpus) or the CPU; "
                          "reference_run takes a device",
                          "7d45bb850b925a99"),
    "train/session.py": ("TrainContext carries the torch.distributed "
                         "backend", "f9c7130b1df0ec7c"),
    "train/trainer.py": ("no JaxTrainer; the result's metrics name the "
                         "torch backend", "e6392ec2901bc0a5"),
    "train/worker_group.py": ("num_gpus leases in place of num_tpus; "
                              "init_torch_distributed takes the backend and "
                              "sets the leased card; no "
                              "init_jax_distributed", "d06c4d372043a3c3"),
}

# Modules of the JAX package's runtime directories that the port has not
# copied yet, by the ROADMAP item they wait for.
WAITING = {}

PORT_ONLY = {
    "core/gpu_detect.py": "NVIDIA GPU detection, beside tpu_detect.py",
    "collective/dist_group.py": "DistGroup over torch.distributed, the "
                                "counterpart of XlaGroup",
    "train/torch_ckpt.py": "tensor checkpoints, the counterpart of the JAX "
                           "checkpoint module",
}

# Port module -> the JAX module it takes the place of under another name.
COUNTERPARTS = {
    "collective/dist_group.py": "collective/xla_group.py",
    "train/torch_ckpt.py": "train/jax_ckpt.py",
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
    missing = (_modules(JAX_PKG) - _modules(PORT_PKG)
               - set(COUNTERPARTS.values()))
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
    for rel, twin in COUNTERPARTS.items():
        assert rel in PORT_ONLY, rel
        assert os.path.exists(os.path.join(JAX_PKG, twin)), twin


def test_normalise_moves_names_and_prefixes_once():
    text = ('import ray_tpu\nfrom ray_tpu.core import x  # ray_tpu_torch\n'
            'os.environ["RAY_TPU_LOG_DIR"]; "/tmp/ray_tpu/head_info.json"')
    assert normalise(text) == (
        'import ray_tpu_torch\nfrom ray_tpu_torch.core import x  '
        '# ray_tpu_torch\nos.environ["RAY_TPU_TORCH_LOG_DIR"]; '
        '"/tmp/ray_tpu_torch/head_info.json"')

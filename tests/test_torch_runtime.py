"""The port's runtime against the JAX package's, on the CPU.

The same small programs (task chains, ``num_returns``, ``wait``, actors,
named actors, ``kill``, a ``put`` on the shm tier, a placement group, crash
retries, arrays through ``put``/``get`` and task arguments) run through
``ray_tpu`` and through ``ray_tpu_torch``: one cluster per package for the
module, never both at once, the JAX one shut down before the port's starts.
Results must be equal, and exceptions equal by type name.  Arrays are numpy
on the JAX side (bfloat16 through ``ml_dtypes``) and CPU tensors on the
port's, from the same seeded values.

The port's cluster has ``resources={"GPU": 2}``, so the GPU lease tests run
here without a card: ``CUDA_VISIBLE_DEVICES`` is what a leased worker sees.
Further port-only checks: GPU detection on a fake probe tree, tensors as
out-of-band buffers, and a ``DeviceRef`` handed between two
``tensor_transport="device"`` actors by point-to-point RPC.
"""

import os

import ml_dtypes
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu_torch.collective.device_objects import (
    DeviceRef,
    RemoteDeviceObjectError,
    device_object_store,
)
from ray_tpu_torch.core import gpu_detect, serialization
from ray_tpu_torch.core.node_agent import NodeAgent

TIMEOUT = 60


def _jax_native(a, dtype):
    return a.astype(ml_dtypes.bfloat16 if dtype == "bfloat16" else dtype)


def _jax_numpy(x):
    assert isinstance(x, np.ndarray), type(x)
    return x.dtype.name, x.astype(np.float32)


def _port_native(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _port_numpy(x):
    assert isinstance(x, torch.Tensor) and x.device.type == "cpu", x
    return str(x.dtype).removeprefix("torch."), x.float().numpy()


# ------------------------------------------------------------ the programs
def prog_tasks(rt, native, to_np, tmp):
    @rt.remote
    def add(a, b):
        return a + b

    @rt.remote(num_returns=2)
    def divmod_(a, b):
        return a // b, a % b

    @rt.remote
    def sleep_then(x, s):
        import time

        time.sleep(s)
        return x

    one = add.remote(0, 1)
    chain = add.remote(add.remote(one, 1), add.remote(one, one))
    q, r = divmod_.remote(chain, 3)
    fast = sleep_then.remote("fast", 0.0)
    slow = sleep_then.remote("slow", 2.0)
    ready, pending = rt.wait([slow, fast], num_returns=1, timeout=TIMEOUT)
    return {"chain": rt.get(chain, timeout=TIMEOUT),
            "divmod": rt.get([q, r], timeout=TIMEOUT),
            "ready": rt.get(ready, timeout=TIMEOUT),
            "pending": len(pending)}


def prog_actors(rt, native, to_np, tmp):
    @rt.remote
    class Counter:
        def __init__(self, start):
            self.n = start

        def inc(self, by=1):
            self.n += by
            return self.n

    c = Counter.remote(10)
    ordered = rt.get([c.inc.remote() for _ in range(5)], timeout=TIMEOUT)
    named = Counter.options(name="parity_counter").remote(0)
    rt.get(named.inc.remote(5), timeout=TIMEOUT)
    via_name = rt.get(rt.get_actor("parity_counter").inc.remote(2),
                      timeout=TIMEOUT)
    rt.kill(c)
    try:
        rt.get(c.inc.remote(), timeout=TIMEOUT)
        after_kill = None
    except Exception as e:  # noqa: BLE001 — the type is the result
        after_kill = type(e).__name__
    rt.kill(named)
    return {"ordered": ordered, "via_name": via_name,
            "after_kill": after_kill}


def prog_put_shm(rt, native, to_np, tmp):
    arr = np.arange(30_000, dtype=np.float32) * 0.5  # 120 KB: past inline
    ref = rt.put(arr)

    @rt.remote
    def total(x):
        return float(x.sum())

    owned = rt.core.core_worker.global_worker().owned[ref.id]
    return {"inline": owned.inline_payload is not None,
            "got": rt.get(ref, timeout=TIMEOUT),
            "total": rt.get(total.remote(ref), timeout=TIMEOUT)}


def prog_placement_group(rt, native, to_np, tmp):
    pg = rt.placement_group([{"CPU": 1}, {"CPU": 1}], strategy="PACK")
    ready = pg.ready(timeout=TIMEOUT)

    @rt.remote(num_cpus=1)
    def tenfold(i):
        return i * 10

    outs = [
        rt.get(tenfold.options(
            scheduling_strategy=rt.placement_group_strategy(pg, i)
        ).remote(i), timeout=TIMEOUT)
        for i in range(2)
    ]
    rt.remove_placement_group(pg)
    return {"ready": ready, "outs": outs}


def prog_retries(rt, native, to_np, tmp):
    @rt.remote(max_retries=1)
    def crash_once(path):
        import os

        if not os.path.exists(path):
            open(path, "w").close()
            os._exit(1)
        return "recovered"

    @rt.remote(max_retries=0)
    def crash():
        import os

        os._exit(1)

    retried = rt.get(crash_once.remote(os.path.join(tmp, "crashed")),
                     timeout=TIMEOUT)
    try:
        rt.get(crash.remote(), timeout=TIMEOUT)
        no_retry = None
    except Exception as e:  # noqa: BLE001 — the type is the result
        no_retry = type(e).__name__
    return {"retried": retried, "no_retry": no_retry}


def prog_arrays(rt, native, to_np, tmp):
    """f32 and bf16 through put/get and as a task's argument and return;
    the 512 x 512 f32 array is 1 MiB, past the inline cap."""
    rng = np.random.default_rng(7)
    arrays = {"small": rng.standard_normal((64, 32)).astype(np.float32),
              "big": rng.standard_normal((512, 512)).astype(np.float32)}

    @rt.remote
    def twice(x):
        return x + x

    out = {}
    for dtype in ("float32", "bfloat16"):
        for name, a in arrays.items():
            x = native(a, dtype)
            out[f"{dtype}/{name}/get"] = to_np(rt.get(rt.put(x),
                                                      timeout=TIMEOUT))
            out[f"{dtype}/{name}/task"] = to_np(rt.get(twice.remote(x),
                                                       timeout=TIMEOUT))
    return out


PROGRAMS = {f.__name__[len("prog_"):]: f for f in (
    prog_tasks, prog_actors, prog_put_shm, prog_placement_group,
    prog_retries, prog_arrays)}

EXPECTED = {  # what both packages must give, beside giving the same
    "tasks": {"chain": 4, "divmod": [1, 1], "ready": ["fast"], "pending": 1},
    "actors": {"ordered": [11, 12, 13, 14, 15], "via_name": 7,
               "after_kill": "ActorDiedError"},
    "placement_group": {"ready": True, "outs": [0, 10]},
    "retries": {"retried": "recovered", "no_retry": "WorkerCrashedError"},
}


def _same(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
                and a.dtype == b.dtype and np.array_equal(a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


def _run_all(rt, native, to_np, tmp):
    out = {}
    for name, prog in PROGRAMS.items():
        d = os.path.join(tmp, name)
        os.makedirs(d)
        out[name] = prog(rt, native, to_np, d)
    return out


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    ray_tpu.init(num_cpus=4)
    try:
        return _run_all(ray_tpu, _jax_native, _jax_numpy,
                        str(tmp_path_factory.mktemp("jax")))
    finally:
        ray_tpu.shutdown()


@pytest.fixture(scope="module")
def port(jax_results):
    """The port's cluster, started only once the JAX one is down."""
    ray_tpu_torch.init(num_cpus=4, resources={"GPU": 2})
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


@pytest.fixture(scope="module")
def port_results(port, tmp_path_factory):
    return _run_all(port, _port_native, _port_numpy,
                    str(tmp_path_factory.mktemp("port")))


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_same_results_as_the_jax_package(name, jax_results, port_results):
    assert _same(port_results[name], jax_results[name]), (
        port_results[name], jax_results[name])
    if name in EXPECTED:
        assert _same(port_results[name], EXPECTED[name]), port_results[name]


def test_shm_tier_and_array_values(port_results):
    assert port_results["put_shm"]["inline"] is False
    assert port_results["put_shm"]["total"] == float(
        (np.arange(30_000, dtype=np.float32) * 0.5).sum())
    for key, (dtype, values) in port_results["arrays"].items():
        assert key.startswith(dtype), key
        assert values.shape in ((64, 32), (512, 512))


# -------------------------------------------------------- tensors in flight
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tensor_travels_as_one_out_of_band_buffer(dtype):
    t = torch.randn(1 << 18, generator=torch.Generator().manual_seed(3))
    t = t.to(dtype)
    header, views = serialization.serialize(t)
    assert [memoryview(v).nbytes for v in views] == [t.numel()
                                                      * t.element_size()]
    assert len(header) < 512
    out = serialization.deserialize(header, views)
    assert out.dtype == dtype and torch.equal(out, t)
    # The decoded tensor owns its bytes: it does not alias the buffer.
    src = np.frombuffer(views[0], dtype=np.uint8)
    assert out.data_ptr() != src.__array_interface__["data"][0]


def test_put_is_a_snapshot_and_get_returns_a_copy(port):
    t = torch.arange(40_000, dtype=torch.float32)  # 160 KB: the shm tier
    ref = port.put(t)
    t.add_(1)
    got = port.get(ref, timeout=TIMEOUT)
    assert got is not t
    assert torch.equal(got, torch.arange(40_000, dtype=torch.float32))


# ------------------------------------------------------------- GPU leases
def _visible_devices_task(rt):
    """A task that reports CUDA_VISIBLE_DEVICES once ``n`` tasks stand at
    the barrier in ``d`` at once (so their leases overlap), or after 20 s.
    Nested, so it travels by value to the workers."""

    def visible_devices_at_barrier(d, n):
        import os
        import time
        import uuid

        open(os.path.join(d, uuid.uuid4().hex), "w").close()
        deadline = time.time() + 20
        while len(os.listdir(d)) < n and time.time() < deadline:
            time.sleep(0.02)
        return os.environ.get("CUDA_VISIBLE_DEVICES"), len(os.listdir(d))

    return rt.remote(visible_devices_at_barrier)


@pytest.mark.parametrize("num_gpus,n_cards", [
    (1, 2),      # two whole cards
    (0.5, 1),    # two halves packed onto one card
])
def test_concurrent_gpu_leases_see_their_cards(port, tmp_path, num_gpus,
                                               n_cards):
    seen = _visible_devices_task(port).options(
        num_gpus=num_gpus, pipeline_depth=1)
    got = port.get([seen.remote(str(tmp_path), 2) for _ in range(2)],
                   timeout=TIMEOUT)
    assert all(n == 2 for _, n in got), got  # both ran at once
    ids = [v for v, _ in got]
    assert len(set(ids)) == n_cards and set(ids) <= {"0", "1"}, ids


def test_lease_without_gpus_sees_none(port, tmp_path):
    seen = _visible_devices_task(port).options(num_gpus=0)
    assert port.get(seen.remote(str(tmp_path), 1), timeout=TIMEOUT) == (
        "", 1)


def test_gpu_is_a_registered_resource(port):
    assert port.cluster_resources()["GPU"] == 2.0


@pytest.mark.parametrize("inherited,instances,want", [
    (None, {"GPU": [1]}, "1"),
    (None, {"GPU": [0, 1]}, "0,1"),
    (None, {}, ""),
    ("4,6", {"GPU": [1]}, "6"),
    ("4,6", {"TPU": [0]}, ""),
])
def test_chip_isolation_env(monkeypatch, inherited, instances, want):
    if inherited is None:
        monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    else:
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", inherited)
    env = {}
    NodeAgent._apply_chip_isolation(env, instances)
    assert env["CUDA_VISIBLE_DEVICES"] == want


# ------------------------------------------------------------ gpu_detect
H100 = "NVIDIA H100 80GB HBM3"


def _fake_tree(root, n_cards, proc=True):
    dev = root / "dev"
    dev.mkdir()
    for name in ["nvidiactl", "nvidia-uvm", "nvidia-uvm-tools"] + [
            f"nvidia{i}" for i in range(n_cards)]:
        (dev / name).touch()
    if proc:
        for i in range(n_cards):
            d = root / f"proc/driver/nvidia/gpus/0000:{i:02x}:00.0"
            d.mkdir(parents=True)
            (d / "information").write_text(
                f"Model: \t\t {H100}\nIRQ:   \t\t {40 + i}\n"
                "GPU UUID: \t GPU-0000\n")
    return str(root)


def _fake_smi(tmp_path, names):
    smi = tmp_path / "nvidia-smi"
    smi.write_text("#!/bin/sh\n" + "".join(f"echo '{n}'\n" for n in names))
    smi.chmod(0o755)
    return str(smi)


@pytest.mark.parametrize("inherited,want", [
    (None, [H100, H100]),
    ("1", [H100]),
    ("0,1", [H100, H100]),
    ("", []),
    ("1,7", [H100]),          # an index past the host's cards is dropped
])
def test_gpu_detect_reads_the_proc_tree(tmp_path, monkeypatch, inherited,
                                        want):
    if inherited is None:
        monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    else:
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", inherited)
    root = _fake_tree(tmp_path, 2)
    assert gpu_detect.models(root, smi=None) == want
    assert gpu_detect.accelerator_type(root, smi=None) == (
        H100 if want else "")


def test_gpu_detect_falls_back_to_nvidia_smi_then_device_nodes(
        tmp_path, monkeypatch):
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    root = _fake_tree(tmp_path, 2, proc=False)
    # A container can expose a node per host card; NVML lists what it has.
    assert gpu_detect.models(root, _fake_smi(tmp_path, [H100])) == [H100]
    assert gpu_detect.models(root, smi=None) == ["", ""]
    assert gpu_detect.models(root, str(tmp_path / "absent")) == ["", ""]
    assert gpu_detect.models(str(tmp_path / "empty"), smi=None) == []


def test_gpu_manager_labels_the_model(monkeypatch):
    from ray_tpu_torch.core.accelerators import get_accelerator_manager

    monkeypatch.setattr(gpu_detect, "models", lambda *a, **k: [H100])
    mgr = get_accelerator_manager("GPU")
    assert mgr.get_current_node_num_accelerators() == 1
    assert mgr.get_current_node_labels() == {"accelerator_type": H100}
    assert mgr.get_visible_accelerator_ids_env_var() == "CUDA_VISIBLE_DEVICES"
    assert mgr.validate_resource_request_quantity(0.5) == (True, None)


# ------------------------------------------------- the device-object store
def test_device_ref_moves_between_actors_by_p2p_rpc(port):
    @port.remote(tensor_transport="device", max_concurrency=2)
    class Producer:
        def make(self, seed):
            import torch

            g = torch.Generator().manual_seed(seed)
            return torch.randn(64, 128, generator=g).to(torch.bfloat16)

        def resident(self):
            from ray_tpu_torch.collective.device_objects import (
                device_object_store,
            )

            return len(device_object_store())

    @port.remote(tensor_transport="device", max_concurrency=2)
    class Consumer:
        def take(self, t):
            from ray_tpu_torch.collective.device_objects import (
                device_object_store,
            )

            store = device_object_store()
            return (t.float().tolist(), str(t.dtype), t.device.type,
                    store.last_transfer_path)

    producer, consumer = Producer.remote(), Consumer.remote()
    ref = port.get(producer.make.remote(11), timeout=TIMEOUT)
    assert isinstance(ref, DeviceRef)
    assert ref.shape == (64, 128) and ref.dtype == "torch.bfloat16"
    assert ref.owner_address
    values, dtype, device, path = port.get(consumer.take.remote(ref),
                                           timeout=TIMEOUT)
    want = torch.randn(64, 128, generator=torch.Generator().manual_seed(11))
    assert torch.equal(torch.tensor(values), want.to(torch.bfloat16).float())
    assert (dtype, device, path) == ("torch.bfloat16", "cpu", "p2p_rpc")

    store = device_object_store()  # the driver's: a borrower of the ref
    fetched = store.fetch(ref)
    assert store.last_transfer_path == "p2p_rpc"
    assert torch.equal(fetched.float(), want.to(torch.bfloat16).float())
    assert store.retain(ref) == 2
    assert store.free(ref) is False
    assert store.refcount(ref) == 1
    assert store.free(ref) is True
    assert store.refcount(ref) == 0
    assert port.get(producer.resident.remote(), timeout=TIMEOUT) == 0
    with pytest.raises(RemoteDeviceObjectError, match="no longer resident"):
        store.fetch(ref)
    for actor in (producer, consumer):
        port.kill(actor)


def test_ref_without_an_owner_raises(port):
    ref = DeviceRef(ray_tpu_torch.core.ids.ObjectID.from_random(), (2,),
                    "torch.float32")
    with pytest.raises(RemoteDeviceObjectError, match="no owner address"):
        device_object_store().fetch(ref)


def test_worker_main_does_not_import_torch():
    import subprocess
    import sys

    code = ("import sys; import ray_tpu_torch.core.worker_main; "
            "print('torch' in sys.modules)")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=60, cwd=repo)
    assert out.stdout.strip() == "False", out.stderr


def test_init_keeps_its_files_under_tmpdir(tmp_path):
    """A cluster's head info, session dir and logs follow TMPDIR, so two
    checkouts with their own TMPDIR on one machine never attach to each
    other's head (``init(address="auto")`` reads the head info)."""
    import json
    import subprocess
    import sys

    code = (
        "import json, ray_tpu_torch as rt\n"
        "from ray_tpu_torch.core import node\n"
        "rt.init(num_cpus=1)\n"
        "f = rt.remote(lambda: 1)\n"
        "assert rt.get(f.remote(), timeout=60) == 1\n"
        "print(json.dumps({'file': node._HEAD_INFO_FILE,\n"
        "                  'info': node.read_head_info()}))\n"
        "rt.shutdown()\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("RAY_TPU_TORCH_")}
    env.update(TMPDIR=str(tmp_path), PYTHONPATH=repo)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=90, cwd=repo, env=env)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    root = tmp_path / "ray_tpu_torch"
    assert got["file"] == str(root / "head_info.json")
    session = got["info"]["session_id"]
    assert json.loads((root / "head_info.json").read_text()) == got["info"]
    assert (root / f"session_{session}" / "node_agent.log").exists()
    # Nothing of this cluster under the fixed /tmp paths.
    assert not os.path.exists(f"/tmp/ray_tpu_torch/session_{session}")
    try:
        with open("/tmp/ray_tpu_torch/head_info.json") as f:
            assert session not in f.read()
    except FileNotFoundError:
        pass


def test_unported_layers_say_which_roadmap_item(port):
    fn = _visible_devices_task(port)
    with pytest.raises(NotImplementedError, match="A1d"):
        fn.bind("", 1)
    from ray_tpu_torch.util import remediation

    with pytest.raises(NotImplementedError, match="A4"):
        remediation.apply_local_directive(
            {"kind": remediation.ACTION_COLLECTIVE_REPROBE})


@pytest.mark.parametrize("algo,what", [
    ("flat_q8", "collective algorithms"),
    ("flat", "collective tuner"),
])
def test_recorded_collective_says_it_waits_for_a4(monkeypatch, algo, what):
    from ray_tpu_torch.core.config import GlobalConfig
    from ray_tpu_torch.util import flight_recorder

    class Group:
        world_size = 2

        def allreduce(self, x):
            self._last_decision = {"algo": algo, "nbytes": 4,
                                   "world_size": 2}
            return x

    monkeypatch.setattr(GlobalConfig, "enable_flight_recorder", True)
    group = flight_recorder.instrument_group(Group(), "test")
    with pytest.raises(NotImplementedError, match=f"{what}.*ROADMAP A4"):
        group.allreduce(torch.ones(1))

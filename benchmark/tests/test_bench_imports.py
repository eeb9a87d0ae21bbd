"""No module the benchmark loads is JAX or the JAX package, by whole
top-level name, and the reference imports nothing of the program."""

import ast
import subprocess
import sys

from benchmark import harness


def test_whole_word_check():
    assert harness.loaded_forbidden(["ray_tpu_torch.models.gpt2",
                                     "ray_tpu_torchvision", "torch"]) == []
    assert harness.loaded_forbidden(["ray_tpu.models", "jaxlib.xla",
                                     "flax", "tools.x", "bench"]) == [
        "bench", "flax", "jaxlib", "ray_tpu", "tools"]
    assert harness.loaded_forbidden(["jax_fake", "benchmark.run",
                                     "toolsx"]) == []


def test_a_run_loads_no_forbidden_module():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark import harness, reference, records, trace\n"
        "from benchmark.run import execute\n"
        "harness.runner('cb_serve')\n"
        "bench = harness.benchmark_file()\n"
        "for m in bench['end_to_end'] + bench['per_layer']:\n"
        "    harness.metric_reader(m['name'])\n"
        "import ray_tpu_torch.llm.disagg\n"
        "import ray_tpu_torch.llm.continuous_batching\n"
        "print(harness.loaded_forbidden())\n" % str(harness.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, cwd=str(harness.ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _imports(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add("." * node.level + (node.module or ""))
    return names


def test_the_reference_imports_nothing_of_the_program():
    for name in ("reference.py", "weights.py", "flops.py", "traffic.py"):
        for mod in _imports(harness.HERE / name):
            top = mod.lstrip(".").split(".")[0]
            assert top not in ("ray_tpu_torch", "ray_tpu", "jax", "jaxlib",
                               "flax"), (name, mod)


def test_the_benchmark_imports_no_jax_by_source():
    for path in harness.HERE.rglob("*.py"):
        if "tests" in path.parts:
            continue
        for mod in _imports(path):
            top = mod.lstrip(".").split(".")[0]
            assert top not in harness.FORBIDDEN_MODULES, (path, mod)

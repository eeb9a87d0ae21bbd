"""What every run of the benchmark shares: finding a cell's files, the
device check, the forbidden-module check, and the result line.

A cell (``BENCHMARK.json`` ``workloads`` entry) names a configuration and a
traffic mix.  Their files are found by name:

- ``benchmark/configs/<config>.json``: the model's published sizes;
- ``benchmark/traffic/<traffic>.json``: the mix's parameters, and the
  ``runner`` (``benchmark/runners/<runner>.py``) that runs it;
- ``benchmark/limits/<workload>.json``: the limit of each number that the
  comparison deciding ``correct`` reads in that cell;
- ``benchmark/metrics/<metric>.py``: one reader a metric.

So a new cell, mix, runner or metric is a new file and a new entry in
``BENCHMARK.json``; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
from pathlib import Path
from typing import Any, Callable, Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# Top-level module names that must not be loaded in the process that
# prints a result: JAX, and the JAX package and its tools, whose names are
# compared whole (``ray_tpu_torch`` is not ``ray_tpu``).
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "ray_tpu", "chip_smoke",
                     "bench", "tools")


class BenchError(RuntimeError):
    """A run that cannot print a result."""


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def benchmark_file(root: Path = ROOT) -> Dict[str, Any]:
    path = root / "BENCHMARK.json"
    if not path.exists():
        raise BenchError(f"no BENCHMARK.json at {root}")
    return load_json(path)


def resolve_cell(bench: Dict[str, Any], workload: str,
                 here: Path = HERE) -> Dict[str, Any]:
    """Everything a run of ``workload`` needs, read from its files."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise BenchError(f"unknown workload {workload!r}; cells: "
                         f"{sorted(cells)}")
    cell = dict(cells[workload])
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[cell["config"]]
    config = load_json(here.parent / entry["file"])
    traffic = load_json(here / "traffic" / f"{cell['traffic']}.json")
    limits_path = here / "limits" / f"{workload}.json"
    limits = load_json(limits_path)["limits"] if limits_path.exists() else {}

    def applies(metric):
        return "workloads" not in metric or workload in metric["workloads"]

    return {
        "name": workload,
        "chips": int(cell["chips"]),
        "config": config,
        "traffic": traffic,
        "limits": limits,
        "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
        "per_layer": [m for m in bench["per_layer"] if applies(m)],
    }


def load_module(path: Path, name: str):
    """A module of this benchmark loaded from its file (runner and metric
    names hold characters an import statement does not take)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise BenchError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def runner(kind: str, here: Path = HERE):
    path = here / "runners" / f"{kind}.py"
    if not path.exists():
        raise BenchError(f"no runner {path}")
    return load_module(path, f"benchmark_runner_{kind}")


def metric_reader(name: str, here: Path = HERE) -> Callable:
    path = here / "metrics" / f"{name}.py"
    if not path.exists():
        raise BenchError(f"no reader for metric {name!r} ({path})")
    return load_module(path, "benchmark_metric_" + name.replace(".", "_")
                       .replace("-", "_")).read


def read_metrics(specs: List[Dict[str, Any]], record,
                 here: Path = HERE) -> Dict[str, Dict[str, Any]]:
    """Each metric's reader over the run's record; a reader that finds
    nothing to read returns None, and the metric is left out."""
    out = {}
    for spec in specs:
        value = metric_reader(spec["name"], here)(record)
        if value is None:
            continue
        value = float(value)
        if not math.isfinite(value):
            raise BenchError(f"metric {spec['name']} read {value}")
        out[spec["name"]] = {"value": value, "unit": spec["unit"]}
    return out


def loaded_forbidden(modules=None) -> List[str]:
    """Top-level names of loaded modules that the benchmark may not load,
    compared whole."""
    names = {m.split(".", 1)[0] for m in (modules or list(sys.modules))}
    return sorted(n for n in names if n in FORBIDDEN_MODULES)


def require_cards(n: int) -> Dict[str, Any]:
    """The cards this run needs, or a ``BenchError``: no fallback to the
    CPU."""
    import torch

    if not torch.cuda.is_available():
        raise BenchError("torch.cuda.is_available() is false")
    have = torch.cuda.device_count()
    if have < n:
        raise BenchError(f"{have} cards, the cell asks for {n}")
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": n}


def judge(readings: Dict[str, float], limits: Dict[str, float]):
    """``correct`` and the compared numbers, each beside its limit.  A
    number with no limit, or a reading that is not finite, is not
    correct."""
    compared = {}
    ok = bool(readings)
    for name, value in readings.items():
        limit = limits.get(name)
        good = (limit is not None and value is not None
                and math.isfinite(value) and value <= limit)
        ok = ok and good
        compared[name] = {"value": value, "limit": limit}
    return ok, compared


def print_result(result: Dict[str, Any]) -> None:
    """The compared numbers as the last lines of standard error, then the
    result as the last line of standard output, ``compared`` its last
    key."""
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    line = {k: v for k, v in result.items() if k != "compared"}
    line["compared"] = result["compared"]
    print(json.dumps(line), flush=True)


def env_for_run() -> None:
    """Keep libraries that could load JAX (``transformers``) from doing
    so.  The port builds its kernels into ``build/`` of the checkout."""
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    os.environ.setdefault("USE_TF", "0")

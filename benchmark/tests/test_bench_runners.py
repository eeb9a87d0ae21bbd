"""Each runner at a tiny size on the CPU, through the entry that skips
the look for a card (``run.execute``); and a cell on the card where there
is one."""

import json
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.run import execute
from benchmark.tests import tiny

SEED = 2 ** 31 + 4242


def test_cb_serve_runs_and_is_correct():
    cell = tiny.serve_cell()
    res = execute(cell, SEED, 2.0, False, device="cpu")
    assert res["correct"], res["compared"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"serve_tokens_per_s", "setup_s"}
    assert all(m["value"] > 0 for m in res["metrics"].values())
    traced = execute(cell, SEED + 1, 4.0, True, device="cpu")
    assert traced["correct"]
    # No device on the CPU: the trace's readers find nothing and are left
    # out; the spans' and counters' readers read the traced part.
    assert {"prefill.ms_p50", "cb.occupancy", "decode.step_ms", "serve.mfu",
            "router.ttft_p95_ms", "router.tpot_p95_ms"} == set(
                traced["metrics"])
    assert traced["device"]["busy_s"] == 0.0
    assert traced["device"]["window_s"] == pytest.approx(1.0, abs=0.05)


def test_a_cell_on_the_card(card):
    bench = harness.benchmark_file()
    name = bench["workloads"][0]["name"]
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", name, "--seed",
         str(SEED), "--seconds", "5", "--trace", "0"],
        capture_output=True, text=True, timeout=1200, cwd=str(harness.ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"

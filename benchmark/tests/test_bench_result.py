"""The last line's schema, the compared numbers on standard error, and
the exit without a card."""

import json
import math
import os
import subprocess
import sys

from benchmark import harness


def test_judge():
    ok, compared = harness.judge({"a": 0.1, "b": 0.2}, {"a": 0.5, "b": 0.5})
    assert ok and compared == {"a": {"value": 0.1, "limit": 0.5},
                               "b": {"value": 0.2, "limit": 0.5}}
    assert not harness.judge({"a": 0.6}, {"a": 0.5})[0]
    assert not harness.judge({"a": math.inf}, {"a": 0.5})[0]
    assert not harness.judge({"a": 0.1}, {})[0]
    assert not harness.judge({}, {"a": 0.5})[0]


def test_result_line_schema(capsys):
    result = {"correct": True, "attempted": 3, "failed": 0,
              "compared": {"max_logit_gap": {"value": 0.1, "limit": 0.5}},
              "metrics": {"setup_s": {"value": 1.5, "unit": "s"}},
              "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                         "count": 1, "memory_peak_bytes": 10}}
    harness.print_result(result)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "compared"]
    assert {"platform", "kind", "count",
            "memory_peak_bytes"} <= set(line["device"])
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert err.strip().splitlines()[-1] == "compared max_logit_gap 0.1 limit 0.5"


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "gpt2-large.serve-decode", "--seed", str(2 ** 31 + 5),
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=240, cwd=str(harness.ROOT),
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_unknown_workload_is_refused():
    import pytest

    with pytest.raises(harness.BenchError):
        harness.resolve_cell(harness.benchmark_file(), "no.such-cell")

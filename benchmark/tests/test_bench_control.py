"""The control: the reference put in the program's place and computed in
the next precision down (float8 e4m3 inputs to every projection) has to
come out as not correct, judged by the harness's own comparison
(``harness.judge``).  At the cells' own sizes it is read on the card
(``benchmark/calibrate.py``, PERF.md); here its arithmetic and a whole
run at a tiny size on the CPU, and on a card the serving cells'."""

import json
import subprocess
import sys

import torch

from benchmark import harness, reference, weights
from benchmark.run import execute
from benchmark.tests import tiny

SEED = 2 ** 31 + 31337


def test_fp8_control_departs_from_the_reference():
    dims = weights.model_dims(tiny.serve_cell()["config"])
    w = weights.gpt2_weights(SEED, dims, torch.device("cpu"))
    tokens = torch.randint(0, 258, (2, 48),
                           generator=torch.Generator().manual_seed(1))
    f32 = reference.GPT2Reference(w, dims["n_head"]).logits(tokens)
    again = reference.GPT2Reference(w, dims["n_head"]).logits(tokens)
    fp8 = reference.GPT2Reference(w, dims["n_head"], "fp8").logits(tokens)
    assert torch.equal(f32, again)
    rel = (fp8 - f32).norm() / f32.norm()
    assert 1e-3 < float(rel) < 0.5
    gaps = reference.served_gaps(
        reference.GPT2Reference(w, dims["n_head"]), tokens[0].tolist(), 16,
        pick=reference.GPT2Reference(w, dims["n_head"], "fp8"))
    assert gaps.shape == (32,) and float(gaps.min()) >= 0.0


def test_control_run_is_judged_not_correct():
    """A whole tiny run with the control read beside the program on the
    same requests: the program's gaps pass the limit, the control's,
    through the same judge, do not.  At GPT-2's vocabulary (on four
    seeds: program 0.0021-0.0072, control 0.038-0.055; with 500 ids the
    control's first choices tie the reference's) and a limit between."""
    cell = tiny.serve_cell(limit=0.02, vocab=50257)
    res = execute(cell, SEED, 2.0, False, device="cpu", control=True)
    assert res["correct"], res["compared"]
    assert res["control"]["correct"] is False, res["control"]
    gap = res["control"]["compared"]["max_logit_gap"]
    assert gap["limit"] == 0.02 and gap["value"] > gap["limit"]


def test_serving_control_fails_on_the_card(card):
    bench = harness.benchmark_file()
    for w in bench["workloads"]:
        cell = harness.resolve_cell(bench, w["name"])
        if cell["traffic"]["runner"] != "cb_serve":
            continue
        out = subprocess.run(
            [sys.executable, "benchmark/calibrate.py", "--workload",
             w["name"], "--seconds", "15", "--seeds",
             ",".join(str(SEED + i) for i in range(3))],
            capture_output=True, text=True, timeout=1800,
            cwd=str(harness.ROOT))
        assert out.returncode == 0, out.stderr[-3000:]
        rows = [json.loads(x) for x in out.stdout.strip().splitlines()[:-1]]
        assert len(rows) == 3
        for row in rows:
            assert row["correct"] and row["control_correct"] is False, row

"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The run loads the cell's files (see
``harness``), makes its inputs and weights from the seed, warms up,
measures for ``--seconds``, judges what the timed path produced against
the plain reference, and prints one JSON line: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and ``compared`` (each number judged, beside its limit).
It exits non-zero with no result when the cards the cell asks for are
not there, or when JAX or the JAX package was loaded.

``benchmark/sweep.py`` finds a serving mix's rate and
``benchmark/calibrate.py`` reads the numbers a cell's limits are set from;
neither is part of a cell's run.
"""

from __future__ import annotations

import time

PROCESS_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402


def execute(cell, seed: int, seconds: float, traced: bool,
            device: str = "cuda", control: bool = False,
            process_start: float = PROCESS_START) -> dict:
    """One run of ``cell`` (as ``harness.resolve_cell`` gives it) on
    ``device``, without the look for cards: the result line's content;
    with ``control``, beside it under ``control`` the control's readings
    judged by the same limits, as though it had served the requests."""
    run = harness.runner(cell["traffic"]["runner"])
    out = run.run(cell, seed, seconds, traced, device=device,
                  control=control)
    record = out["record"]
    record["setup_s"] = out["window_open_wall"] - process_start
    specs = cell["per_layer"] if traced else cell["end_to_end"]
    t0 = time.perf_counter()
    metrics = harness.read_metrics(specs, record)
    timings = dict(record.get("timings", {}),
                   read_metrics_s=time.perf_counter() - t0)
    print("timings " + json.dumps(timings), file=sys.stderr, flush=True)
    correct, compared = harness.judge(out["readings"], cell["limits"])
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics,
              "device": {"memory_peak_bytes": out["memory_peak_bytes"],
                         **out.get("device_extra", {})},
              "compared": compared}
    if traced and "breakdown" in out:
        result["breakdown"] = out["breakdown"]
    if control:
        ok, judged = harness.judge(out["control"] or {}, cell["limits"])
        result["control"] = {"correct": ok, "compared": judged}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    harness.env_for_run()
    try:
        cell = harness.resolve_cell(harness.benchmark_file(), args.workload)
        device = harness.require_cards(cell["chips"])
        result = execute(cell, args.seed, args.seconds, bool(args.trace))
    except harness.BenchError as e:
        print(f"benchmark: {e}", file=sys.stderr, flush=True)
        return 2
    bad = harness.loaded_forbidden()
    if bad:
        print(f"benchmark: forbidden modules loaded: {bad}", file=sys.stderr,
              flush=True)
        return 3
    result["device"] = {**device, **result["device"]}
    harness.print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())

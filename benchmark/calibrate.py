"""Read the numbers that set a cell's limits: the program's readings over
many seeds and the lower-precision control's, in one process.

    python3 benchmark/calibrate.py --workload <name> --seconds <s> \
        --seeds 11,12,13

Each seed is a whole run of the cell (weights, set-up, a window of
``--seconds`` at the cell's own load, the comparison), with the control
read beside it on the same requests and judged by the same limits
(``run.execute``); one JSON line a seed, then the largest program reading
and the smallest control reading of each number.  A limit lies between
the two (``benchmark/limits/<cell>.json``).  Not part of a cell's run.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402
from benchmark.run import execute  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    harness.env_for_run()
    cell = harness.resolve_cell(harness.benchmark_file(), args.workload)
    harness.require_cards(cell["chips"])
    program, control = {}, {}
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        res = execute(cell, seed, args.seconds, False, control=True,
                      process_start=t0)
        got = {k: v["value"] for k, v in res["compared"].items()}
        low = {k: v["value"] for k, v in res["control"]["compared"].items()}
        for k, v in got.items():
            program[k] = max(program.get(k, 0.0), v if v is not None
                             else float("inf"))
        for k, v in low.items():
            control[k] = min(control.get(k, float("inf")), v if v is not None
                             else float("inf"))
        print(json.dumps({"seed": seed, "correct": res["correct"],
                          "program": got,
                          "control_correct": res["control"]["correct"],
                          "control": low, "attempted": res["attempted"],
                          "failed": res["failed"],
                          "seconds": time.time() - t0}), flush=True)
    print(json.dumps({"program_max": program, "control_min": control}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

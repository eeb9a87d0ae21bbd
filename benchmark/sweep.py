"""Find the highest rate a serving cell's system sustains: one set-up, then
one window a rate, each waited out before the next.

    python3 benchmark/sweep.py --workload <name> --seed <n> --seconds <s> \
        --rates 4,6,8

Prints one JSON line a rate: the offered and served tokens a second, the
time to first token (median, 95th percentile, and median over the
window's first and last thirds), the per-token 95th percentile, the
requests still waiting for a first token and the engine's queue at the
window's close, and the requests due in the window that had not finished
a minute after it.  Below the knee the first token comes as soon in the
window's last third as in its first and every request finishes; above it
the wait grows through the window.  A cell is offered about four fifths
of the knee.  Not part of a cell's run.
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

from benchmark import harness, records, traffic  # noqa: E402


def _median(xs):
    return records.percentile(xs, 50) if xs else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    harness.env_for_run()
    import torch

    cell = harness.resolve_cell(harness.benchmark_file(), args.workload)
    if args.device == "cuda":
        harness.require_cards(cell["chips"])
    runner = harness.runner(cell["traffic"]["runner"])
    server = runner.Server(cell, args.seed, torch.device(args.device))
    specs = [{"name": n, "unit": ""} for n in
             ("serve_tokens_per_s", "router.ttft_p95_ms",
              "router.tpot_p95_ms")]
    for rate in (float(r) for r in args.rates.split(",")):
        requests = traffic.serving_requests(cell["traffic"], args.seed,
                                            args.seconds, rate)
        rec = server.window(requests, args.seconds, False)
        reqs = rec["requests"]
        end = rec["wait_end_ns"]
        ttft = [((r["first_ns"] or end) - r["due_ns"]) / 1e6 for r in reqs]
        w0, w1 = rec["window_ns"]
        thirds = [[t for r, t in zip(reqs, ttft)
                   if w0 + k * (w1 - w0) / 3 <= r["due_ns"]
                   < w0 + (k + 1) * (w1 - w0) / 3] for k in (0, 2)]
        row = {"rate_per_s": rate, "requests": len(reqs),
               "ttft_first_third_ms": _median(thirds[0]),
               "ttft_last_third_ms": _median(thirds[1]),
               "waiting_at_close": sum(1 for r in reqs if r["first_ns"] is None
                                       or r["first_ns"] >= w1),
               "offered_tokens_per_s": sum(r["max_tokens"] for r in reqs)
               / args.seconds,
               "ttft_p50_ms": _median(ttft),
               "queue_at_close": rec["stats1"]["queue_depth"],
               "occupancy_at_close": rec["stats1"]["occupancy"],
               "unfinished": sum(1 for r in reqs if r["failed"])}
        row.update({k: v["value"] for k, v in
                    harness.read_metrics(specs, rec).items()})
        print(json.dumps(row), flush=True)
        deadline = time.monotonic() + 120.0
        while (server.decode.engine.has_unfinished()
               and time.monotonic() < deadline):
            time.sleep(0.5)
    server.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

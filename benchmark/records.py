"""Reading a run's record: what the metric readers share."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np


def window_tokens(record) -> Dict[str, Any]:
    """Tokens delivered inside the window: all, those from decode steps
    (each request's first comes from its prefill), and the cache positions
    those decode steps attended to."""
    w0, w1 = record["window_ns"]
    total = decode = positions = 0
    for r in record["requests"]:
        j = 0
        for t, c in r["times"]:
            for _ in range(c):
                if w0 <= t < w1:
                    total += 1
                    if j > 0:
                        decode += 1
                        positions += r["prompt_tokens"] + j
                j += 1
    return {"tokens": total, "decode_tokens": decode,
            "decode_positions": positions}


def percentile(xs, q: float) -> float:
    return float(np.percentile(np.asarray(xs, dtype=np.float64), q))


def serve_flops(record) -> float:
    """Model FLOPs of the work done inside the window: the prefills that
    ended in it, and the decode tokens delivered in it."""
    from benchmark import flops

    d = record["dims"]
    w0, w1 = record["window_ns"]
    prefills = [a["tokens"] for n, s, e, a in record["spans"]
                if n == "prefill" and w0 <= e < w1]
    tok = window_tokens(record)
    return flops.serve_flops(
        d["n_layer"], d["n_head"], d["d_model"], d["vocab"],
        prompt_tokens=sum(prefills), prefills=len(prefills),
        decode_tokens=tok["decode_tokens"],
        prefill_pairs=sum(n * (n + 1) // 2 for n in prefills),
        decode_positions=tok["decode_positions"])


def is_serve(record) -> bool:
    return record.get("kind") == "serve"


"""The one generator of every mix: what a ``traffic/<mix>.json`` asks
for, made from a seed.

Serving mixes draw their sizes and arrival times once, from the mix's own
``shape_seed``; the run's ``--seed`` deals the sizes to the arrivals in
another order and draws the prompts' contents.  So every seed offers the
same work at the same moments, and the seed changes which request comes
when and what it says.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List

import numpy as np

SEED_MASK = (1 << 63) - 1
PRINTABLE = np.arange(32, 127, dtype=np.uint8)  # one byte-tokenizer id each


def rng(seed: int, *salt: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & SEED_MASK, *salt])


def draw_lengths(spec: Dict[str, Any], n: int, gen: np.random.Generator
                 ) -> np.ndarray:
    """``n`` lengths: ``lognormal`` (``median``, ``sigma``) or ``uniform``,
    rounded and clipped to [``min``, ``max``]."""
    lo, hi = int(spec["min"]), int(spec["max"])
    if spec["dist"] == "lognormal":
        x = gen.lognormal(math.log(spec["median"]), spec["sigma"], n)
    elif spec["dist"] == "uniform":
        x = gen.uniform(lo, hi + 1, n)
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return np.clip(np.floor(x), lo, hi).astype(np.int64)


def request_count(mix: Dict[str, Any], seconds: float) -> int:
    """Requests drawn for a window: the mean count, with room so that the
    window's end, not the list's, ends the arrivals."""
    mean = mix["rate_per_s"] * seconds
    return int(math.ceil(mean + 6 * math.sqrt(mean) + 8))


def serving_requests(mix: Dict[str, Any], seed: int, seconds: float,
                     rate_per_s: float = None) -> List[Dict[str, Any]]:
    """Open-loop requests: each with its due time (seconds after the
    window opens), its prompt (printable bytes; with the tokenizer's BOS,
    ``prompt_tokens`` ids) and its output length.  Poisson arrivals: the
    gaps are exponential at ``rate_per_s`` (or the rate given)."""
    rate = rate_per_s or mix["rate_per_s"]
    n = request_count(dict(mix, rate_per_s=rate), seconds)
    shape = rng(mix["shape_seed"], 1)
    prompt = draw_lengths(mix["prompt_tokens"], n, shape)
    output = draw_lengths(mix["output_tokens"], n, shape)
    due = np.cumsum(shape.exponential(1.0 / rate, n))
    order = rng(seed, 2)
    prompt, output = prompt[order.permutation(n)], output[order.permutation(n)]
    content = rng(seed, 3)
    out = []
    for i in range(n):
        text = content.choice(PRINTABLE, int(prompt[i]) - 1).tobytes()
        out.append({"index": i, "due_s": float(due[i]),
                    "prompt": text.decode("ascii"),
                    "prompt_tokens": int(prompt[i]),
                    "max_tokens": int(output[i])})
    return out


def warmup_requests(mix: Dict[str, Any], seed: int) -> List[Dict[str, Any]]:
    """Requests that warm the serving path before the window: the
    shortest and longest prompts of the mix, and a few between, each
    with a short output."""
    lo, hi = mix["prompt_tokens"]["min"], mix["prompt_tokens"]["max"]
    content = rng(seed, 4)
    out = []
    for n in np.linspace(lo, hi, 4).astype(int):
        text = content.choice(PRINTABLE, int(n) - 1).tobytes()
        out.append({"prompt": text.decode("ascii"), "prompt_tokens": int(n),
                    "max_tokens": 4})
    return out


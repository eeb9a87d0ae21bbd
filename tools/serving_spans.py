"""The serving path's own spans over a benchmark cell.

One run of a serving cell of ``benchmark/`` (as ``benchmark/run.py``
makes it), with ``ray_tpu_torch.util.tracing``'s recorder on from the
window's opening to the end of its wait, and what the spans say, laid
over the card's kernels in a traced run:

    python3 tools/serving_spans.py --workload gpt2-large.serve-decode \\
        --seed 3700000005 --seconds 51 --trace 1        # needs a card
    python3 tools/serving_spans.py --tiny --seed 1 --seconds 3 --trace 1

``--record 0`` runs the same without the recorder, to measure what it
costs.  Prints one ``RESULT`` line and writes everything it read to
``<out>/<workload>.<seed>.t<trace>.r<record>.json``:

- ``prefill.launch_ms_p50``, ``prefill.sync_ms_p50``, ``kv.submit_ms_p50``:
  medians of the ``llm.prefill.launch``, ``llm.prefill.sync`` and
  ``llm.kv_submit`` spans that begin in the part read (``window_ns``, the
  traced part in a traced run);
- ``cb.queue_wait_ms_p90``: p90 of the ``cb.queue_wait`` spans that begin
  in the whole window (``opened_ns`` to ``closed_ns``);
- ``cb.host_ms``: the mean, over ``cb.step`` spans that begin in the part
  read, of the step less its ``cb.sync``;
- ``device.idle.loop_host`` (traced): % of the part read in which no
  kernel runs while the decode loop is in a ``cb.step``, out of its
  ``cb.sync``;
- the idle gaps, each named by the loop's innermost span and the clients'
  innermost span over its middle (at a gap's first instant the loop is
  still returning from ``cb.sync``), or by the benchmark's own label
  where no span covers it;
- the shares of ``flash_fwd`` kernels inside their prefill's launch to
  sync and of ``decode_attention`` kernels inside a ``cb.step``;
- each answered request's TTFT, cut at the spans of its trace;
- ``llm.prefill``'s ``inflight``, the launch's share off the CPU, and the
  prefix copy's GB/s;
- the share of prefills that replayed a captured graph (``llm.prefill``'s
  ``bucket`` above 0) and the prefills by bucket.
"""

import time

PROCESS_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

from benchmark import harness, trace  # noqa: E402

LOOP = "llm-cb-decode"  # the decode loop's thread
SEGMENTS = ("due_sent", "sent_request", "prefill", "kv_submit",
            "queue_wait", "rest")


def _ms(s) -> float:
    return (s.end_ns - s.start_ns) / 1e6


def _durations(spans, name: str, lo: int, hi: int):
    return [_ms(s) for s in spans if s.name == name and lo <= s.start_ns < hi]


def _median(xs):
    return statistics.median(xs) if xs else None


def _pct(xs, q: float):
    return float(np.percentile(np.asarray(xs, float), q)) if xs else None


def _named(spans, name: str):
    return sorted((s for s in spans if s.name == name),
                  key=lambda s: s.start_ns)


def _clip(spans, lo: int, hi: int):
    return [(max(s.start_ns, lo), min(s.end_ns, hi)) for s in spans
            if s.end_ns > lo and s.start_ns < hi]


def _minus(a, b):
    """Sorted disjoint intervals ``a`` less sorted disjoint ``b``."""
    out, j = [], 0
    for s, e in a:
        cur = s
        while j < len(b) and b[j][1] <= cur:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            if b[k][0] > cur:
                out.append((cur, b[k][0]))
            cur = max(cur, b[k][1])
            k += 1
        if cur < e:
            out.append((cur, e))
    return out


def _overlap(a, b) -> int:
    """Length of the intersection of two sorted disjoint interval lists."""
    i = j = tot = 0
    while i < len(a) and j < len(b):
        tot += max(0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return tot


def _idle(tr, lo: int, hi: int):
    """The stretches of [lo, hi) in which no kernel runs."""
    s, e = trace.union(np.clip(tr.start, lo, hi), np.clip(tr.end, lo, hi))
    return _minus([(lo, hi)], list(zip(s.tolist(), e.tolist())))


def _traced(record) -> bool:
    tr = record.get("trace")
    return tr is not None and len(tr) > 0


def span_metrics(record, spans):
    """The six span metrics, each None where it finds nothing to read."""
    w0, w1 = record["window_ns"]
    m = {"prefill.launch_ms_p50": _median(
             _durations(spans, "llm.prefill.launch", w0, w1)),
         "prefill.sync_ms_p50": _median(
             _durations(spans, "llm.prefill.sync", w0, w1)),
         "kv.submit_ms_p50": _median(
             _durations(spans, "llm.kv_submit", w0, w1)),
         "cb.queue_wait_ms_p90": _pct(_durations(
             spans, "cb.queue_wait", record["opened_ns"],
             record["closed_ns"]), 90)}
    steps, syncs = _named(spans, "cb.step"), _named(spans, "cb.sync")
    sync_starts = np.array([s.start_ns for s in syncs], np.int64)
    host = []
    for st in steps:
        if not w0 <= st.start_ns < w1:
            continue
        i = int(np.searchsorted(sync_starts, st.start_ns))
        inside = 0
        while i < len(syncs) and syncs[i].start_ns < st.end_ns:
            inside += syncs[i].end_ns - syncs[i].start_ns
            i += 1
        host.append((st.end_ns - st.start_ns - inside) / 1e6)
    m["cb.host_ms"] = statistics.fmean(host) if host else None
    m["device.idle.loop_host"] = None
    if _traced(record) and steps:
        loop_host = _minus(_clip(steps, w0, w1), _clip(syncs, w0, w1))
        m["device.idle.loop_host"] = (
            100.0 * _overlap(loop_host, _idle(record["trace"], w0, w1))
            / (w1 - w0))
    return m


def _innermost(spans, ts):
    """The name of the shortest of ``spans`` covering each time in
    ``ts``, or None."""
    if not spans:
        return [None] * len(ts)
    names = [s.name for s in spans]
    st = np.array([s.start_ns for s in spans], np.int64)
    en = np.array([s.end_ns for s in spans], np.int64)
    dur = (en - st).astype(float)
    ts = np.asarray(ts, np.int64)
    out = []
    for i in range(0, len(ts), 512):
        cover = (st <= ts[i:i + 512, None]) & (en > ts[i:i + 512, None])
        j = np.where(cover, dur, np.inf).argmin(axis=1)
        hit = cover[np.arange(len(j)), j]
        out += [names[k] if h else None
                for k, h in zip(j.tolist(), hit.tolist())]
    return out


def gap_labels(record, spans, ts, fallback):
    """Each time named as ``<loop span>/<client span>``, by the innermost
    span of the decode loop and of the clients over it (``cb.queue_wait``,
    recorded by the loop, is the request's), else by the innermost of
    ``fallback``, the benchmark's own spans, as ``trace.host_label``
    names it."""
    w0, w1 = record["window_ns"]
    near = [s for s in spans if s.end_ns > w0 and s.start_ns < w1]
    loop = [s for s in near if s.thread == LOOP and s.name != "cb.queue_wait"]
    clients = [s for s in near
               if s.thread != LOOP or s.name == "cb.queue_wait"]
    labels = ["/".join(x for x in pair if x)
              for pair in zip(_innermost(loop, ts), _innermost(clients, ts))]
    return [lab or trace.host_label(fallback, int(t))
            for lab, t in zip(labels, ts)]


def idle_gaps(record, spans, fallback, n: int = 10):
    """The longest idle gaps of the part read, and the idle seconds by
    label."""
    w0, w1 = record["window_ns"]
    idle = _idle(record["trace"], w0, w1)
    labels = gap_labels(record, spans, [(a + b) // 2 for a, b in idle],
                        fallback)
    by = {}
    for lab, (a, b) in zip(labels, idle):
        by[lab] = by.get(lab, 0.0) + (b - a) / 1e9
    order = sorted(range(len(idle)), key=lambda i: idle[i][0] - idle[i][1])
    return {"top": [[labels[i], (idle[i][1] - idle[i][0]) / 1e9,
                     (idle[i][0] - w0) / 1e9] for i in order[:n]],
            "seconds_by_label": dict(sorted(by.items(),
                                            key=lambda kv: -kv[1])),
            "idle_pct": 100.0 * sum(b - a for a, b in idle) / (w1 - w0)}


def shared_clock(record, spans):
    """The shares of the part read's ``flash_fwd`` kernels that lie inside
    their prefill's launch-to-sync, and of its ``decode_attention``
    kernels inside a ``cb.step``."""
    w0, w1 = record["window_ns"]
    tr = record["trace"]
    pairs = {}
    for s in spans:
        if s.name in ("llm.prefill.launch", "llm.prefill.sync"):
            pairs.setdefault(s.parent_id, {})[s.name] = s
    wins = [(d["llm.prefill.launch"].start_ns, d["llm.prefill.sync"].end_ns)
            for d in pairs.values() if len(d) == 2]
    fl = tr.named("flash_fwd").within(w0, w1)
    inside = sum(any(lo <= a and b <= hi for lo, hi in wins)
                 for a, b in zip(fl.start.tolist(), fl.end.tolist()))
    steps = _named(spans, "cb.step")
    da = tr.named("decode_attention").within(w0, w1)
    st = np.array([s.start_ns for s in steps], np.int64)
    en = np.array([s.end_ns for s in steps], np.int64)
    k = np.searchsorted(st, da.start, side="right") - 1
    good = (k >= 0) & (da.end <= en[np.clip(k, 0, None)]) if len(st) else (
        np.zeros(len(da), bool))
    return {"flash_fwd_in_prefill": inside / len(fl) if len(fl) else None,
            "flash_fwd_kernels": len(fl),
            "decode_attention_in_step": (float(good.mean()) if len(da)
                                         else None),
            "decode_attention_kernels": len(da)}


def ttft_decomposition(record, spans):
    """Each answered request's TTFT (due to first delta at its client), cut
    at its trace's spans, matched to its ``llm.request`` by prompt length
    and order: due -> sent (the harness), sent -> ``llm.request``,
    ``llm.prefill``, ``llm.kv_submit``, the ``cb.queue_wait`` after the
    handoff, and the rest (covered by none of those three)."""
    reqs = sorted((r for r in record["requests"] if r["first_ns"]),
                  key=lambda r: r["sent_ns"])
    roots = _named(spans, "llm.request")
    by_trace = {}
    for s in spans:
        by_trace.setdefault(s.trace_id, {})[s.name] = s
    used, rows = set(), []
    for r in reqs:
        root = next((s for s in roots if id(s) not in used
                     and s.attrs["prompt_tokens"] == r["prompt_tokens"]
                     and s.start_ns >= r["sent_ns"]), None)
        if root is None:
            continue
        used.add(id(root))
        mine = by_trace[root.trace_id]
        p, k, q = (mine.get(n) for n in ("llm.prefill", "llm.kv_submit",
                                         "cb.queue_wait"))
        if not (p and k and q):
            continue
        ttft = r["first_ns"] - r["due_ns"]
        row = {"due_sent": r["sent_ns"] - r["due_ns"],
               "sent_request": root.start_ns - r["sent_ns"],
               "prefill": p.end_ns - p.start_ns,
               "kv_submit": k.end_ns - k.start_ns,
               "queue_wait": q.end_ns - max(q.start_ns, k.end_ns),
               "ttft": ttft}
        row["rest"] = ttft - row["prefill"] - row["kv_submit"] - row[
            "queue_wait"]
        rows.append(row)
    if not rows:
        return None
    total = sum(row["ttft"] for row in rows)
    res = {"requests": len(rows), "of": len(reqs)}
    for key in SEGMENTS + ("ttft",):
        xs = [row[key] / 1e6 for row in rows]
        res[key + "_ms"] = {"p50": _pct(xs, 50), "p90": _pct(xs, 90)}
    res["share_of_all"] = {key: sum(row[key] for row in rows) / total
                           for key in SEGMENTS}
    p95 = _pct([row["ttft"] for row in rows], 95)
    near = min(rows, key=lambda row: abs(row["ttft"] - p95))
    res["p95_request_ms"] = {key: v / 1e6 for key, v in near.items()}
    res["p95_rest_share"] = near["rest"] / near["ttft"]
    return res


def details(record, spans):
    """What the six metrics leave out: prefills in flight, the graph
    share of the prefills and their buckets, the launch's share off the
    CPU, the prefix copy's size and rate, and the seconds each span name
    covers in the part read."""
    w0, w1 = record["window_ns"]
    out = {"spans": len(spans)}

    def begun(name):
        return [s for s in spans if s.name == name and w0 <= s.start_ns < w1]

    prefills = begun("llm.prefill")
    inflight = [s.attrs["inflight"] for s in prefills]
    out["inflight_median"] = _median(inflight)
    out["inflight_max"] = max(inflight) if inflight else None
    # The bucket a prefill replayed, 0 where it ran eagerly; a program
    # whose spans carry no bucket leaves both out.
    buckets = [s.attrs["bucket"] for s in prefills if "bucket" in s.attrs]
    if buckets:
        out["prefill_graph_share"] = sum(b > 0 for b in buckets) / len(
            buckets)
        out["prefill_buckets"] = {str(b): buckets.count(b)
                                  for b in sorted(set(buckets))}
    launch = begun("llm.prefill.launch")
    if launch:
        wall = sum(s.end_ns - s.start_ns for s in launch)
        out["launch_off_cpu_share"] = 1 - sum(
            s.attrs["cpu_ns"] for s in launch) / wall
    copies = begun("llm.prefix_copy")
    if copies:
        out["prefix_copy_GBps"] = (
            sum(s.attrs["bytes"] for s in copies)
            / (sum(s.end_ns - s.start_ns for s in copies) / 1e9) / 1e9)
        out["prefix_copy_ms_p50"] = _median([_ms(s) for s in copies])
        out["prefix_copy_MB_p50"] = _median(
            [s.attrs["bytes"] / 1e6 for s in copies])
    covered = {}
    for name in sorted({s.name for s in spans}):
        covered[name] = sum(b - a for a, b in _clip(
            [s for s in spans if s.name == name], w0, w1)) / 1e9
    out["seconds_in_part_read"] = covered
    return out


def read_spans(record, spans, fallback):
    """Everything this tool reads from a run's record and its spans."""
    out = {"span_metrics": span_metrics(record, spans),
           "details": details(record, spans),
           "ttft": ttft_decomposition(record, spans)}
    if _traced(record) and spans:
        out["idle_gaps"] = idle_gaps(record, spans, fallback)
        out["shared_clock"] = shared_clock(record, spans)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0, choices=(0, 1))
    ap.add_argument("--record", type=int, default=1, choices=(0, 1))
    ap.add_argument("--tiny", action="store_true",
                    help="a tiny serving cell on the CPU")
    ap.add_argument("--dumps", type=float, default=0.0,
                    help="dump every thread's stack every so many seconds")
    ap.add_argument("--out", default=str(ROOT / "build" / "serving_spans"))
    a = ap.parse_args(argv)
    harness.env_for_run()
    if a.dumps:
        import faulthandler
        faulthandler.dump_traceback_later(a.dumps, repeat=True)
    if a.tiny:
        from benchmark.tests import tiny
        cell, device = tiny.serve_cell(), "cpu"
    elif a.workload:
        cell = harness.resolve_cell(harness.benchmark_file(), a.workload)
        harness.require_cards(cell["chips"])
        device = "cuda"
    else:
        ap.error("give --workload or --tiny")
    mod = harness.runner(cell["traffic"]["runner"])
    got = {}
    if a.record:
        from ray_tpu_torch.util import tracing
        window = mod.Server.window

        def recorded(self, requests, seconds, traced):
            with tracing.recording() as rec:
                record = window(self, requests, seconds, traced)
            got["spans"], got["dropped"] = rec.spans(), rec.dropped
            return record

        mod.Server.window = recorded
    out = mod.run(cell, a.seed, a.seconds, bool(a.trace), device=device)
    record = out["record"]
    record["setup_s"] = out["window_open_wall"] - PROCESS_START
    specs = cell["end_to_end"] + (cell["per_layer"] if a.trace else [])
    res = {"workload": cell["name"], "seed": a.seed, "trace": a.trace,
           "record": a.record,
           "metrics": {k: v["value"] for k, v in harness.read_metrics(
               specs, record).items()},
           "correct": harness.judge(out["readings"], cell["limits"])[0],
           "attempted": out["attempted"], "failed": out["failed"],
           "breakdown": out.get("breakdown")}
    if a.record:
        t0 = time.perf_counter()
        res["dropped"] = got["dropped"]
        res.update(read_spans(record, got["spans"], mod.host_spans(record)))
        res["read_s"] = time.perf_counter() - t0
    os.makedirs(a.out, exist_ok=True)
    path = os.path.join(a.out, f"{cell['name']}.{a.seed}.t{a.trace}"
                               f".r{a.record}.json")
    with open(path, "w") as f:
        json.dump(res, f, indent=1)
    short = {k: res[k] for k in ("workload", "seed", "trace", "record",
                                 "correct", "failed", "metrics")}
    if a.record:
        short.update(span_metrics=res["span_metrics"], dropped=res["dropped"])
    print("RESULT " + json.dumps(short), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

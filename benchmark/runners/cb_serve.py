"""Serving through the continuous-batching engine: a ``DisaggRouter`` over a
local ``PrefillReplica`` and a ``BatchedDecodeReplica`` on one card, under
open-loop arrivals.

Set-up makes the weights from the seed and hands them to both replicas,
captures every decode bucket, and sends a few requests through the whole
path.  The window then offers the mix's requests at their due times, each
from a client thread of its own that streams it through
``DisaggRouter.stream`` (the prefill runs on that thread, the decode on the
engine's).  Every request is timed from the moment it was due.  Once the
window closes the requests due in it are waited for, a sample drawn from
the seed is judged against the plain reference, and the numbers are read.
"""

from __future__ import annotations

import gc
import threading
import time
from typing import Any, Dict, List

import torch

from benchmark import reference, trace, traffic, weights

WAIT_S = 60.0  # how long past the window the requests due in it may take


class Spans:
    """The benchmark's spans, appended from many threads."""

    def __init__(self):
        self.items: List[tuple] = []
        self._lock = threading.Lock()

    def add(self, name: str, start_ns: int, end_ns: int, **attrs) -> None:
        with self._lock:
            self.items.append((name, start_ns, end_ns, attrs))


def _classes():
    """The benchmark's thin wrappers around the port's replicas."""
    from ray_tpu_torch.llm.continuous_batching import (
        BatchedDecodeReplica, ContinuousBatchingEngine,
    )
    from ray_tpu_torch.llm.disagg import PrefillReplica
    from ray_tpu_torch.llm.tokenizer import ByteTokenizer

    class IdTokenizer(ByteTokenizer):
        """The byte tokenizer, but a streamed delta carries its token ids
        ("id,id,"), so the client sees every token, including ids past the
        byte range that random weights pick."""

        def decode(self, ids):
            return "".join(f"{int(i)}," for i in ids)

    class TimedPrefill(PrefillReplica):
        """``PrefillReplica`` whose ``prefill`` the benchmark times."""

        def __init__(self, ecfg, device, spans: Spans):
            super().__init__(ecfg, device=device)
            self.spans = spans

        def prefill(self, prompt, params=None):
            t0 = time.time_ns()
            meta = super().prefill(prompt, params)
            self.spans.add("prefill", t0, time.time_ns(),
                           tokens=meta["prompt_len"])
            return meta

    class IdDecode(BatchedDecodeReplica):
        """``BatchedDecodeReplica`` over an engine that streams token ids,
        every bucket captured before it starts."""

        def __init__(self, ecfg, device):
            self.engine = ContinuousBatchingEngine(
                ecfg, None, tokenizer=IdTokenizer(), device=device)
            self.engine.compile_buckets()
            self.engine.start()

    return TimedPrefill, IdDecode


def _model_config(dims: Dict[str, int]):
    from ray_tpu_torch.models import GPT2Config

    return GPT2Config(vocab_size=dims["vocab"], max_seq=dims["n_ctx"],
                      n_layer=dims["n_layer"], n_head=dims["n_head"],
                      d_model=dims["d_model"], dtype="bfloat16",
                      attention="flash")


def _client(router, req: Dict[str, Any], out: Dict[str, Any]) -> None:
    """Stream one request; record when each delta reached the client and
    the token ids it carried."""
    from ray_tpu_torch.llm.engine import SamplingParams

    params = SamplingParams(max_tokens=req["max_tokens"], temperature=0.0,
                            stop_token=-1)
    times, ids = out["times"], out["ids"]
    try:
        for delta in router.stream(req["prompt"], params,
                                   timeout_s=WAIT_S + 600.0):
            now = time.time_ns()
            got = [int(x) for x in delta.split(",") if x]
            times.append((now, len(got)))
            ids.extend(got)
    except Exception as e:  # noqa: BLE001 — a failed request is counted
        out["error"] = repr(e)
    out["end_ns"] = time.time_ns()


def _sleep_until(t_ns: int) -> None:
    wait = (t_ns - time.time_ns()) / 1e9
    if wait > 0:
        time.sleep(wait)


def _offer(router, requests: List[Dict[str, Any]], w0_ns: int,
           w1_ns: int, spans: Spans, actions=()) -> List[Dict[str, Any]]:
    """Start each request due inside [w0, w1) on its own thread at its due
    time (open loop), and make the timed ``actions`` (time, call) in
    between; return the requests' records and threads."""
    records, threads = [], []
    actions = sorted(actions, key=lambda a: a[0])
    for req in requests:
        due = w0_ns + int(req["due_s"] * 1e9)
        if due >= w1_ns:
            break
        while actions and actions[0][0] <= due:
            at, call = actions.pop(0)
            _sleep_until(at)
            call()
        _sleep_until(due)
        rec = {"due_ns": due, "sent_ns": time.time_ns(),
               "prompt_tokens": req["prompt_tokens"],
               "max_tokens": req["max_tokens"], "times": [], "ids": [],
               "prompt": req["prompt"]}
        t = threading.Thread(target=_client, args=(router, req, rec),
                             daemon=True)
        t.start()
        records.append(rec)
        threads.append(t)
    for at, call in actions:
        _sleep_until(at)
        call()
    spans.add("window", w0_ns, w1_ns)
    return records, threads


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Server:
    """The system under test, set up for a cell: the weights from the seed
    handed to a prefill and a decode replica behind one router, every
    decode bucket captured, the path warmed by a few requests."""

    def __init__(self, cell: Dict[str, Any], seed: int, dev: torch.device):
        from ray_tpu_torch.llm.disagg import DisaggRouter
        from ray_tpu_torch.llm.engine import EngineConfig
        from ray_tpu_torch.models.params import ParamTree

        TimedPrefill, IdDecode = _classes()
        self.dev = dev
        self.mix = cell["traffic"]
        self.dims = weights.model_dims(cell["config"])
        self.spans = Spans()
        params = ParamTree(weights.as_port_tree(
            weights.gpt2_weights(seed, self.dims, dev)))
        engine = self.mix["engine"]
        ecfg = EngineConfig(model=_model_config(self.dims),
                            max_batch_size=engine["max_batch_size"],
                            max_seq_len=engine["max_seq_len"], seed=0,
                            param_loader=lambda: params)
        self.prefill = TimedPrefill(ecfg, dev, self.spans)
        self.decode = IdDecode(ecfg, dev)
        self.router = DisaggRouter([self.prefill], [self.decode])
        for req in traffic.warmup_requests(self.mix, seed):
            _client(self.router, req, {"times": [], "ids": []})
        _sync(dev)

    def window(self, requests: List[Dict[str, Any]], seconds: float,
               traced: bool) -> Dict[str, Any]:
        """Offer ``requests`` over a window of ``seconds``, wait for those
        due in it, and return the run's record.  Traced, the profiler
        covers the mix's ``trace_seconds`` from ``trace_from`` of the way
        into the window, and the record's window is that part: every
        per-layer reading but the router's is taken over it."""
        edges: List[tuple] = []
        stats0 = self.decode.stats()
        w0 = time.time_ns()
        w1 = w0 + int(seconds * 1e9)
        sub = None
        if traced:
            sub = trace.SubWindow(
                w0 + int(self.mix["trace_from"] * seconds * 1e9),
                self.mix["trace_seconds"],
                lambda t: edges.append((t, self.decode.stats())))
        records, threads = _offer(self.router, requests, w0, w1, self.spans,
                                  sub.actions() if sub else ())
        _sleep_until(w1)
        stats1 = self.decode.stats()
        tr = sub.read() if sub is not None else None
        deadline = time.monotonic() + WAIT_S
        for t in threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        wait_end = time.time_ns()
        late = {id(r) for r, t in zip(records, threads) if t.is_alive()}
        for r in records:
            r["failed"] = (bool(r.get("error")) or id(r) in late
                           or not r["times"])
            r["first_ns"] = r["times"][0][0] if r["times"] else None
            r["last_ns"] = r["times"][-1][0] if r["times"] else None
            r["tokens"] = len(r["ids"])
        opened, closed = w0, w1
        if tr is not None:
            (w0, stats0), (w1, stats1) = edges
        return {"kind": "serve", "dims": self.dims, "window_ns": (w0, w1),
                "opened_ns": opened, "closed_ns": closed,
                "wait_end_ns": wait_end, "seconds": (w1 - w0) / 1e9,
                "requests": records, "stats0": stats0, "stats1": stats1,
                "spans": list(self.spans.items), "trace": tr}

    def close(self) -> None:
        """Stop the decode loop and free the program's state."""
        self.decode.close()
        del self.router, self.prefill, self.decode
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()


def run(cell: Dict[str, Any], seed: int, seconds: float, traced: bool,
        device: str = "cuda", control: bool = False) -> Dict[str, Any]:
    dev = torch.device(device)
    server = Server(cell, seed, dev)
    requests = traffic.serving_requests(cell["traffic"], seed, seconds)
    record = server.window(requests, seconds, traced)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    server.close()
    t0 = time.perf_counter()
    readings, control_readings = judge_sample(
        record, seed, server.dims, dev, cell["traffic"], control)
    record["timings"] = {
        "wait_s": (record["wait_end_ns"] - record["closed_ns"]) / 1e9,
        "reference_s": time.perf_counter() - t0,
        **(record["trace"].seconds if record["trace"] else {})}
    records = record["requests"]
    out = {"record": record, "readings": readings,
           "control": control_readings,
           "attempted": len(records),
           "failed": sum(1 for r in records if r["failed"]),
           "memory_peak_bytes": int(peak),
           "window_open_wall": record["opened_ns"] / 1e9}
    tr = record["trace"]
    if tr is not None:
        t0 = time.perf_counter()
        w0, w1 = record["window_ns"]
        out["device_extra"] = {"busy_s": trace.busy_ns(tr, w0, w1) / 1e9,
                               "window_s": (w1 - w0) / 1e9}
        out["breakdown"] = {
            "device_ops": trace.top_ops(tr, w0, w1),
            "idle_gaps": trace.idle_gaps(tr, host_spans(record), w0, w1)}
        record["timings"]["breakdown_s"] = time.perf_counter() - t0
        record["timings"]["kernels"] = len(tr)
    return out


def host_spans(record) -> List[tuple]:
    """What the host was doing, most specific first: a prefill on some
    client thread, a request in flight (the engine stepping), the window
    with no request in flight."""
    prefills = [("prefill", s, e) for n, s, e, _ in record["spans"]
                if n == "prefill"]
    flight = [("decode loop, request in flight", r["due_ns"],
               r["last_ns"] or r["due_ns"]) for r in record["requests"]]
    w0, w1 = record["window_ns"]
    return prefills + flight + [("no request in flight", w0, w1)]


def sample(record, seed: int, k: int) -> List[Dict[str, Any]]:
    """``k`` finished requests drawn from the seed, the longest among
    them."""
    done = [r for r in record["requests"]
            if not r["failed"] and r["tokens"] == r["max_tokens"]]
    if not done:
        return []
    longest = max(range(len(done)), key=lambda i: done[i]["tokens"])
    rest = [i for i in range(len(done)) if i != longest]
    pick = traffic.rng(seed, 6).permutation(rest)[:max(0, k - 1)]
    return [done[longest]] + [done[i] for i in sorted(pick)]


def judge_sample(record, seed: int, dims, dev, mix, control: bool):
    """The widest gap by which a served token's reference logit lies below
    the reference's best, over the sampled requests; with ``control``,
    the same for the tokens the fp8 reference would pick."""
    chosen = sample(record, seed, mix["check_requests"])
    if not chosen:
        return {"max_logit_gap": None}, None
    w = weights.gpt2_weights(seed, dims, dev)
    ref = reference.GPT2Reference(w, dims["n_head"])
    low = (reference.GPT2Reference(w, dims["n_head"], precision="fp8")
           if control else None)
    del w
    gap, control_gap = 0.0, 0.0
    from ray_tpu_torch.llm.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    for r in chosen:
        ids = tok.encode(r["prompt"]) + r["ids"]
        n = r["prompt_tokens"]
        gap = max(gap, float(reference.served_gaps(ref, ids, n).max()))
        if low is not None:
            control_gap = max(control_gap, float(
                reference.served_gaps(ref, ids, n, pick=low).max()))
    readings = {"max_logit_gap": gap}
    record["checked"] = {"requests": len(chosen),
                         "tokens": sum(r["tokens"] for r in chosen)}
    del ref, low
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return readings, ({"max_logit_gap": control_gap} if control else None)

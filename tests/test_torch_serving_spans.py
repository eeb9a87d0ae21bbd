"""The in-process span recorder (``util/tracing.py``) and the serving
path's spans, on the CPU: a tiny GPT-2 behind a ``DisaggRouter`` over a
local ``PrefillReplica`` and ``BatchedDecodeReplica``, its requests
streamed from client threads as a server's are."""

import importlib.util
import json
import math
import pathlib
import subprocess
import sys
import threading
import time

import pytest

from ray_tpu_torch import models as tm
from ray_tpu_torch.llm import (
    BatchedDecodeReplica,
    DisaggRouter,
    EngineConfig,
    PrefillReplica,
    SamplingParams,
)
from ray_tpu_torch.llm.tokenizer import ByteTokenizer
from ray_tpu_torch.util import tracing

PROMPTS = ["the first request", "a second, longer request than that",
           "three"]
TOKENS = [len(ByteTokenizer().encode(p)) for p in PROMPTS]
STEP_CHILDREN = {"cb.boundary", "cb.resize", "cb.launch", "cb.sync",
                 "cb.deliver"}


@pytest.fixture(scope="module")
def router():
    cfg = EngineConfig(
        model=tm.GPT2Config.tiny(vocab_size=384, max_seq=64,
                                 dtype="float32"),
        max_batch_size=4, max_seq_len=64, seed=0)
    decode = BatchedDecodeReplica(cfg, device="cpu")
    try:
        yield DisaggRouter([PrefillReplica(cfg, device="cpu")], [decode])
    finally:
        decode.close()


def _serve(router, prompts):
    """Stream each prompt from a thread of its own; return, per prompt, the
    time its first delta reached the client and the deltas."""
    out = [{"deltas": []} for _ in prompts]

    def client(prompt, rec):
        params = SamplingParams(max_tokens=6, temperature=0.0, stop_token=-1)
        for delta in router.stream(prompt, params, timeout_s=120):
            rec.setdefault("first_ns", time.time_ns())
            rec["deltas"].append(delta)

    threads = [threading.Thread(target=client, args=(p, r))
               for p, r in zip(prompts, out)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert all(r["deltas"] for r in out)
    return out


def _inside(inner, outer):
    return outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns


def test_a_requests_spans_share_its_trace_and_nest(router):
    before = time.time_ns()
    with tracing.recording() as rec:
        out = _serve(router, PROMPTS)
    after = time.time_ns()
    spans = rec.spans()
    assert rec.dropped == 0
    assert all(before <= s.start_ns <= s.end_ns <= after for s in spans)

    by_name = {}
    for s in spans:
        by_name.setdefault(s.name, []).append(s)
    roots = by_name["llm.request"]
    assert len(roots) == len(PROMPTS)
    assert len({r.trace_id for r in roots}) == len(PROMPTS)
    assert all(r.parent_id is None for r in roots)
    assert sorted(r.attrs["prompt_tokens"] for r in roots) == sorted(TOKENS)
    for name in ("llm.prefill", "llm.kv_submit", "cb.queue_wait"):
        assert sorted(s.trace_id for s in by_name[name]) == sorted(
            r.trace_id for r in roots), name
    for root in roots:
        mine = [s for s in spans if s.trace_id == root.trace_id]
        assert all(_inside(s, root) for s in mine)
        prefill, = (s for s in mine if s.name == "llm.prefill")
        assert prefill.attrs["tokens"] == root.attrs["prompt_tokens"]
        assert 1 <= prefill.attrs["inflight"] <= len(PROMPTS)
        assert prefill.attrs["bucket"] == 0  # eager: no graph on the CPU
        launch, = (s for s in mine if s.name == "llm.prefill.launch")
        sync, = (s for s in mine if s.name == "llm.prefill.sync")
        for child in (launch, sync):
            assert child.parent_id == prefill.span_id
            assert _inside(child, prefill)
        assert launch.end_ns <= sync.start_ns
        assert 0 < launch.attrs["cpu_ns"]
        submit, = (s for s in mine if s.name == "llm.kv_submit")
        copy, = (s for s in mine if s.name == "llm.prefix_copy")
        assert copy.parent_id == submit.span_id and _inside(copy, submit)
        assert copy.attrs["bytes"] > 0
        wait, = (s for s in mine if s.name == "cb.queue_wait")
        assert wait.thread == "llm-cb-decode"
        assert submit.start_ns <= wait.start_ns <= submit.end_ns
        # The wait outlives the handoff, so it is the handoff's sibling.
        assert wait.parent_id == submit.parent_id == root.span_id
        # Its client (the prompts differ in length) saw the first delta
        # after the wait ended.
        client = out[TOKENS.index(root.attrs["prompt_tokens"])]
        assert wait.end_ns <= client["first_ns"]

    loop = [s for s in spans if s.thread == "llm-cb-decode"
            and s.name != "cb.queue_wait"]
    steps = [s for s in loop if s.name == "cb.step"]
    # A step may only retire (no row left to decode): then it launches
    # nothing.
    assert any(s.attrs["active"] >= 1 for s in steps)
    assert max(s.attrs["bucket"] for s in steps) >= 2
    assert {"cb.boundary", "cb.launch", "cb.sync", "cb.deliver",
            "cb.splice", "cb.resize"} <= {s.name for s in loop}
    for step in steps:
        inner = [s for s in loop if s is not step and _inside(s, step)]
        assert {s.name for s in inner} <= STEP_CHILDREN | {"cb.splice"}
        # Direct children: those inside no other child.
        kids = sorted((s for s in inner
                       if not any(o is not s and _inside(s, o)
                                  for o in inner)),
                      key=lambda s: s.start_ns)
        want = {"cb.boundary"} | ({"cb.launch", "cb.sync", "cb.deliver"}
                                  if step.attrs["active"] else set())
        assert {s.name for s in kids} >= want
        for a, b in zip(kids, kids[1:]):
            assert a.end_ns <= b.start_ns
    for s in loop:
        if s.name in STEP_CHILDREN:
            assert any(_inside(s, step) for step in steps), s
        if s.name == "cb.splice":
            assert any(_inside(s, b) for b in loop if b.name == "cb.boundary")
            assert s.attrs["bytes"] > 0
    assert all(not any(_inside(s, step) or _inside(step, s) for step in steps)
               for s in loop if s.name == "cb.idle")


def test_recording_off_records_nothing(router, monkeypatch):
    with tracing.recording() as rec:
        pass
    # The decode loop's idle wait (at most 0.05 s) may have begun while an
    # earlier recorder was on.
    time.sleep(0.2)
    drawn, added = [], []
    real = tracing._rand_id
    monkeypatch.setattr(tracing, "_rand_id",
                        lambda *a: drawn.append(1) or real(*a))
    monkeypatch.setattr(tracing.Recorder, "add",
                        lambda *a, **k: added.append(a))
    _serve(router, PROMPTS[:2])
    assert tracing.active_recorder is None
    assert rec.spans() == [] and rec.dropped == 0
    assert added == [] and drawn == []  # no span made, no id drawn


def test_past_capacity_spans_are_dropped_not_stored():
    with tracing.recording(capacity=5) as rec:
        with pytest.raises(RuntimeError, match="already on"):
            with tracing.recording():
                pass
        for i in range(8):
            with tracing.start_span(f"s{i}"):
                pass
    assert [s.name for s in rec.spans()] == [f"s{i}" for i in range(5)]
    assert rec.dropped == 3
    rec.add("late", 0, 1)  # a site that read the recorder before it ended
    assert len(rec.spans()) == 5 and rec.dropped == 3


def test_concurrent_adds_are_each_stored_or_counted():
    threads, each, cap = 16, 2000, 10_000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    # A recorder of its own: an installed one also takes the spans of
    # other threads of the process (a decode loop left idling).
    rec = tracing.Recorder(cap)

    def add():
        for i in range(each):
            rec.add("s", i, i + 1)

    pool = [threading.Thread(target=add) for _ in range(threads)]
    try:
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in pool)
    assert len(rec.spans()) == cap
    assert rec.dropped == threads * each - cap


def test_start_span_without_a_cluster_worker_lands_in_the_recorder():
    from ray_tpu_torch.core.core_worker import try_global_worker

    assert try_global_worker() is None
    before = time.time_ns()
    with tracing.recording() as rec:
        with tracing.start_span("outer", {"n": 1}) as outer:
            with tracing.start_span("inner"):
                pass
            tracing.record_span("measured", outer.start, time.time(),
                                {"k": 2})
        root = tracing.detached_span("detached")
        tracing.finish_span(root)
        t0 = time.monotonic()
        mono = rec.wall_ns(t0)
    after = time.time_ns()
    got = {s.name: s for s in rec.spans()}
    assert set(got) == {"outer", "inner", "measured", "detached"}
    assert got["outer"].attrs == {"n": 1} and got["outer"].parent_id is None
    assert got["inner"].trace_id == outer.trace_id
    assert got["inner"].parent_id == outer.span_id
    assert got["measured"].parent_id == outer.span_id
    assert got["measured"].attrs == {"k": 2}
    assert got["detached"].trace_id != outer.trace_id
    assert all(s.thread == threading.current_thread().name
               for s in got.values())
    assert all(before <= s.start_ns <= s.end_ns <= after
               for s in got.values())
    assert _inside(got["inner"], got["outer"])
    assert before <= mono <= after
    # A span's float stamps, in ns.
    assert got["outer"].start_ns == round(outer.start * 1e9)
    assert got["outer"].end_ns == round(outer.end * 1e9)


# ``tools/serving_spans.py``: what it reads from a run's record.

ROOT = pathlib.Path(__file__).resolve().parent.parent
MS = 1_000_000


def _tool():
    spec = importlib.util.spec_from_file_location(
        "serving_spans_tool", ROOT / "tools" / "serving_spans.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _span(name, a, b, thread="c1", trace=None, span=None, parent=None,
          **attrs):
    return tracing.SpanRecord(name, a * MS, b * MS, thread, trace, span,
                              parent, attrs or None)


def _hand_built():
    """Two requests over a read part of [0, 100) ms, and a trace of five
    kernels, worked out by hand below."""
    from benchmark.trace import Trace

    L = "llm-cb-decode"
    spans = [
        _span("llm.request", 0, 90, trace="t1", span="r1", prompt_tokens=10),
        _span("llm.prefill", 5, 35, trace="t1", span="p1", parent="r1",
              tokens=10, inflight=1, bucket=64),
        _span("llm.prefill.launch", 5, 25, trace="t1", parent="p1",
              cpu_ns=5 * MS),
        _span("llm.prefill.sync", 25, 35, trace="t1", parent="p1"),
        _span("llm.kv_submit", 36, 46, trace="t1", span="k1", parent="r1"),
        _span("llm.prefix_copy", 38, 44, trace="t1", parent="k1",
              bytes=12_000_000),
        _span("cb.queue_wait", 45, 50, L, trace="t1", parent="r1", rid=0),
        _span("llm.request", 48, 85, "c2", trace="t2", span="r2",
              prompt_tokens=20),
        _span("llm.prefill", 50, 64, "c2", trace="t2", span="p2",
              parent="r2", tokens=20, inflight=2, bucket=0),
        _span("llm.prefill.launch", 50, 60, "c2", trace="t2", parent="p2",
              cpu_ns=5 * MS),
        _span("llm.prefill.sync", 60, 64, "c2", trace="t2", parent="p2"),
        _span("llm.kv_submit", 65, 79, "c2", trace="t2", span="k2",
              parent="r2"),
        _span("cb.queue_wait", -40, -30, L, rid=1),  # in the window only
        _span("cb.queue_wait", 160, 170, L, rid=2),  # after the window
        _span("cb.step", 10, 30, L, bucket=1, active=1),
        _span("cb.sync", 20, 28, L),
        _span("cb.step", 50, 70, L, bucket=2, active=2),
        _span("cb.launch", 50, 52, L),
        _span("cb.sync", 55, 60, L),
        _span("cb.step", 110, 120, L, bucket=2, active=2),  # after the part
        _span("cb.sync", 112, 118, L),
    ]
    kernels = [(0, 6, 24), (1, 21, 27), (1, 51, 53), (2, 80, 85),
               (0, 90, 95)]
    tr = Trace(["flash_fwd_kernel", "decode_attention_split", "gemm"],
               [k for k, _, _ in kernels], [a * MS for _, a, _ in kernels],
               [b * MS for _, _, b in kernels])
    record = {"window_ns": (0, 100 * MS), "opened_ns": -50 * MS,
              "closed_ns": 150 * MS, "trace": tr,
              "requests": [{"due_ns": -2 * MS, "sent_ns": -1 * MS,
                            "first_ns": 52 * MS, "prompt_tokens": 10}]}
    return record, spans, [("request in flight", 0, 200 * MS)]


def test_tool_reads_a_hand_built_record():
    tool = _tool()
    record, spans, fallback = _hand_built()
    got = tool.read_spans(record, spans, fallback)
    assert got["span_metrics"] == {
        "prefill.launch_ms_p50": 15.0,   # 20, 10
        "prefill.sync_ms_p50": 7.0,      # 10, 4
        "kv.submit_ms_p50": 12.0,        # 10, 14
        "cb.queue_wait_ms_p90": 9.5,     # 5, 10 (not the one after)
        "cb.host_ms": 13.5,              # 20 - 8, 20 - 5
        # Loop host [10,20) [28,30) [50,55) [60,70) against idle [0,6)
        # [27,51) [53,80) [85,90) [95,100): 2 + 1 + 2 + 10 of 100 ms.
        "device.idle.loop_host": 15.0,
    }
    gaps = got["idle_gaps"]
    assert gaps["top"] == [
        ["cb.step/llm.kv_submit", 0.027, 0.053],
        ["llm.prefix_copy", 0.024, 0.027],
        ["llm.request", 0.006, 0.0],
        ["llm.request", 0.005, 0.085],
        ["request in flight", 0.005, 0.095],  # no span of the program
    ]
    assert gaps["seconds_by_label"]["llm.request"] == pytest.approx(0.011)
    assert gaps["idle_pct"] == pytest.approx(67.0)
    assert got["shared_clock"] == {
        "flash_fwd_in_prefill": 0.5, "flash_fwd_kernels": 2,
        "decode_attention_in_step": 1.0, "decode_attention_kernels": 2}
    ttft = got["ttft"]
    assert ttft["requests"] == ttft["of"] == 1
    assert ttft["p95_request_ms"] == {
        "due_sent": 1.0, "sent_request": 1.0, "prefill": 30.0,
        "kv_submit": 10.0, "queue_wait": 4.0, "ttft": 54.0, "rest": 10.0}
    assert ttft["p95_rest_share"] == pytest.approx(10 / 54)
    d = got["details"]
    assert (d["inflight_median"], d["inflight_max"]) == (1.5, 2)
    assert d["launch_off_cpu_share"] == pytest.approx(2 / 3)
    assert d["prefix_copy_GBps"] == pytest.approx(2.0)
    assert d["prefill_graph_share"] == 0.5  # one replay, one eager
    assert d["prefill_buckets"] == {"0": 1, "64": 1}


def test_tool_reads_nothing_without_program_spans():
    tool = _tool()
    record, _, fallback = _hand_built()
    got = tool.read_spans(record, [], fallback)
    assert set(got["span_metrics"]) == {
        "prefill.launch_ms_p50", "prefill.sync_ms_p50", "kv.submit_ms_p50",
        "cb.queue_wait_ms_p90", "cb.host_ms", "device.idle.loop_host"}
    assert all(v is None for v in got["span_metrics"].values())
    assert got["ttft"] is None and "idle_gaps" not in got


def test_tool_on_a_tiny_traced_cpu_run(tmp_path):
    # The traced part is 1 s from 1.5 s into the window, later where the
    # profiler starts slowly: 6 s of arrivals keep requests coming in it.
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "serving_spans.py"), "--tiny",
         "--seed", "2147483001", "--seconds", "6", "--trace", "1",
         "--out", str(tmp_path)],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line, = (x for x in proc.stdout.splitlines() if x.startswith("RESULT "))
    res = json.loads(line[len("RESULT "):])
    assert res["correct"] and res["failed"] == 0 and res["dropped"] == 0
    m = res["span_metrics"]
    # No kernel on the CPU: the device share finds nothing to read.
    assert m.pop("device.idle.loop_host") is None
    assert len(m) == 5 and all(math.isfinite(v) and v >= 0
                               for v in m.values())
    full = json.loads((tmp_path / "tiny.serve.2147483001.t1.r1.json")
                      .read_text())
    assert full["ttft"]["requests"] >= 1
    assert full["details"]["spans"] > 0
    assert full["details"]["prefill_graph_share"] == 0.0  # the CPU's eager

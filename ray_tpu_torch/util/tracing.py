"""Distributed tracing: span propagation across task and actor calls, and
an in-process span recorder.

Reference: ray ``python/ray/util/tracing/tracing_helper.py:34,165`` — an
OpenTelemetry context is injected into every task spec at submission and
extracted on the executing worker, so one trace follows a request through
arbitrary task/actor hops.  Native redesign (no opentelemetry dependency,
which this image does not ship): spans are (trace_id, span_id, parent_id,
name, start, end, attrs) tuples carried in a contextvar, injected into
``TaskSpec.trace_ctx``, and recorded through the existing task-event
buffer's profile channel — so traces land in the same control-plane store
the timeline and state API already read, and export as Chrome-trace rows.

Usage:
    with tracing.start_span("preprocess") as span:
        ...                       # user code; nested submits inherit
    spans = tracing.get_trace(span.trace_id)   # driver-side query

**The in-process recorder.**  ``recording()`` turns on a process-local
recorder for a block; off (the default) an instrumented site costs one
read of ``active_recorder``.  On, every span of the process lands in a
bounded in-memory buffer, with or without a cluster worker: those of
``start_span``, ``record_span`` and ``finish_span``, and the serving
path's own.  Each is a ``SpanRecord``: name, ``start_ns``/``end_ns`` on
``time.time_ns()`` (the clock ``torch.profiler``'s device timestamps are
put on, so spans and kernels share one time line), the recording
thread's name, trace/span/parent ids where the site has them, and a few
integer attributes.  A site that reads ``time.time_ns()`` itself records
with ``Recorder.add``; ``Span`` keeps float seconds, converted once on
the way in.  Past ``capacity`` spans are counted in ``dropped``, not
stored::

    with tracing.recording(capacity=1 << 20) as rec:
        ...                                   # serve requests
    for s in rec.spans():
        print(s.name, s.thread, (s.end_ns - s.start_ns) / 1e6, s.attrs)
    assert rec.dropped == 0

The serving path's spans (``llm/disagg.py``, ``llm/continuous_batching.py``):

- ``llm.request``: ``DisaggRouter.stream``, call to the generator's end;
  the root of the request's trace (``prompt_tokens``).
- ``llm.prefill``: ``PrefillEngine.prefill`` (``tokens``; ``inflight``:
  prefills running on the engine when it began, itself included;
  ``bucket``: the prompt-length bucket whose CUDA graph it replayed, 0
  where it ran eagerly); inside it ``llm.prefill.launch``, the engine's
  lock taken and the work enqueued: inputs copied in, the graph replayed
  or the eager kernels launched, the pages cloned out (``cpu_ns``: the
  thread's CPU time over the span), and ``llm.prefill.sync``, the wait
  for the logits on the host.
- ``llm.kv_submit``: ``BatchedDecodeReplica.add_from_kv``, the KV fetched
  and enqueued; inside it ``llm.prefix_copy``, the prefix cache's host
  copy (``bytes``).
- ``cb.queue_wait``: enqueue to the slot's commit at admission, recorded
  by the decode loop in the request's trace (``rid``).
- The decode loop's thread (``llm-cb-decode``): ``cb.step`` a step
  (``bucket``, ``active``), holding ``cb.boundary`` (``admitted``,
  ``retired``; each admission's ``cb.splice`` inside, ``bytes``),
  ``cb.resize`` (``from``, ``to``), ``cb.launch`` (inputs copied, graph
  replayed), ``cb.sync`` (the wait for the step's tokens)
  and ``cb.deliver`` (deltas pushed, step telemetry); ``cb.idle`` is a
  wait with no work.

``tools/serving_spans.py`` runs a benchmark cell with the recorder on
and reads these spans against the card's kernels.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import os
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

# (trace_id, span_id) of the currently active span in THIS process/task.
_current: contextvars.ContextVar[Optional[Tuple[str, str]]] = (
    contextvars.ContextVar("rtpu_trace_ctx", default=None)
)


def _rand_id(nbytes: int = 8) -> str:
    return os.urandom(nbytes).hex()


@dataclasses.dataclass
class Span:
    trace_id: str
    span_id: str
    parent_id: Optional[str]
    name: str
    start: float = 0.0
    end: float = 0.0
    attributes: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def set_attribute(self, key: str, value: Any) -> None:
        self.attributes[key] = value


class SpanRecord(NamedTuple):
    """One span as the in-process recorder keeps it."""

    name: str
    start_ns: int
    end_ns: int
    thread: str
    trace_id: Optional[str]
    span_id: Optional[str]
    parent_id: Optional[str]
    attrs: Optional[Dict[str, Any]]


class Recorder:
    """A bounded in-memory buffer of ``SpanRecord``s (see ``recording``).
    ``add`` holds the buffer's lock for one append only."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.dropped = 0
        self._spans: List[SpanRecord] = []
        self._closed = False
        self._lock = threading.Lock()
        # time.monotonic() -> time.time_ns(), for sites that already read
        # the monotonic clock: the wall clock's reading against the
        # midpoint of two monotonic ones.
        m0 = time.monotonic_ns()
        wall = time.time_ns()
        self._mono_offset_ns = wall - (m0 + time.monotonic_ns()) // 2

    def wall_ns(self, monotonic_s: float) -> int:
        """A ``time.monotonic()`` reading on ``time.time_ns()``'s clock."""
        return round(monotonic_s * 1e9) + self._mono_offset_ns

    def add(self, name: str, start_ns: int, end_ns: int,
            attrs: Optional[Dict[str, Any]] = None,
            context: Optional[Tuple[str, str]] = None,
            span_id: Optional[str] = None) -> None:
        """Record a span measured on ``time.time_ns()``; ``context`` is its
        (trace_id, parent_span_id), e.g. ``current_context()``."""
        trace_id, parent_id = context or (None, None)
        rec = SpanRecord(name, start_ns, end_ns,
                         threading.current_thread().name, trace_id, span_id,
                         parent_id, attrs)
        with self._lock:
            if self._closed:  # a site that read the recorder before it ended
                return
            if len(self._spans) < self.capacity:
                self._spans.append(rec)
            else:
                self.dropped += 1

    def close(self) -> None:
        """Take no more spans."""
        with self._lock:
            self._closed = True

    def spans(self) -> List[SpanRecord]:
        with self._lock:
            return list(self._spans)


# The recorder while ``recording()`` is on, else None.  Sites read it as
# ``tracing.active_recorder`` (an attribute of this module, never a name
# imported from it) and do nothing more when it is None.
active_recorder: Optional[Recorder] = None


@contextlib.contextmanager
def recording(capacity: int = 1 << 20):
    """Record this process's spans for the block; yields the ``Recorder``.
    One recorder at a time."""
    global active_recorder
    if active_recorder is not None:
        raise RuntimeError("a span recorder is already on in this process")
    rec = active_recorder = Recorder(capacity)
    try:
        yield rec
    finally:
        active_recorder = None
        rec.close()


def current_context() -> Optional[Tuple[str, str]]:
    """(trace_id, span_id) to inject into outgoing task specs."""
    return _current.get()


def set_context(ctx: Optional[Tuple[str, str]]):
    """Install an extracted trace context (executor side)."""
    return _current.set(ctx)


def _record(span: Span) -> None:
    rec = active_recorder
    if rec is not None:
        rec.add(span.name, round(span.start * 1e9), round(span.end * 1e9),
                span.attributes or None, (span.trace_id, span.parent_id),
                span.span_id)
    from ray_tpu_torch.core.core_worker import try_global_worker

    w = try_global_worker()
    if w is None or w.task_events is None:
        return
    # Ride the profile-event channel: same buffer, flush loop, and
    # control-plane store as the task timeline (shared shed + drop
    # accounting live in add_profile_row).
    w.task_events.add_profile_row(
        span.name,
        span.start,
        span.end,
        {
            "span": True,
            "trace_id": span.trace_id,
            "span_id": span.span_id,
            "parent_id": span.parent_id,
            **span.attributes,
        },
    )


@contextlib.contextmanager
def start_span(name: str, attributes: Optional[Dict[str, Any]] = None):
    """Open a span; children (including spans opened inside tasks this
    block submits) parent to it."""
    parent = _current.get()
    span = Span(
        trace_id=parent[0] if parent else _rand_id(16),
        span_id=_rand_id(),
        parent_id=parent[1] if parent else None,
        name=name,
        start=time.time(),
        attributes=dict(attributes or {}),
    )
    token = _current.set((span.trace_id, span.span_id))
    try:
        yield span
    finally:
        span.end = time.time()
        _current.reset(token)
        _record(span)


def detached_span(name: str,
                  attributes: Optional[Dict[str, Any]] = None) -> Span:
    """Open a span WITHOUT installing it as the current context.

    For long-lived scopes that cross ``yield`` boundaries (the streaming
    data scheduler's generator pump): a ``start_span`` block entered
    inside a generator would leak its contextvar into the consumer's
    context between yields.  Scope individual operations to the span
    with ``span_context``; close it with ``finish_span``."""
    parent = _current.get()
    return Span(
        trace_id=parent[0] if parent else _rand_id(16),
        span_id=_rand_id(),
        parent_id=parent[1] if parent else None,
        name=name,
        start=time.time(),
        attributes=dict(attributes or {}),
    )


def finish_span(span: Span) -> None:
    """Close and record a ``detached_span``."""
    if not span.end:
        span.end = time.time()
    _record(span)


@contextlib.contextmanager
def span_context(span: Optional[Span]):
    """Install ``span`` as the current context for the block (submits in
    the block parent to it).  ``None`` is a no-op, so callers can hold an
    optional root without branching."""
    if span is None:
        yield
        return
    token = _current.set((span.trace_id, span.span_id))
    try:
        yield
    finally:
        _current.reset(token)


def record_span(name: str, start: float, end: float,
                attributes: Optional[Dict[str, Any]] = None,
                context: Optional[Tuple[str, str]] = None) -> Optional[Span]:
    """Record an already-measured interval as a completed span.

    ``context``: an explicit (trace_id, parent_span_id) — e.g. one
    extracted from a cross-process message — defaulting to the caller's
    current context.  Returns None (records nothing) when neither
    exists, so instrumentation sites can call this unconditionally."""
    ctx = context if context is not None else _current.get()
    if ctx is None:
        return None
    span = Span(
        trace_id=ctx[0],
        span_id=_rand_id(),
        parent_id=ctx[1],
        name=name,
        start=start,
        end=end,
        attributes=dict(attributes or {}),
    )
    _record(span)
    return span


@contextlib.contextmanager
def task_execution_span(spec) -> Any:
    """Executor-side: extract the submitted trace context (if any) and wrap
    the task body in a span (the tracing_helper wrap of task execution)."""
    ctx = getattr(spec, "trace_ctx", None)
    if ctx is None:
        yield None
        return
    token = set_context(tuple(ctx))
    try:
        with start_span(
            f"task:{spec.name}", {"task_id": spec.task_id.hex()}
        ) as span:
            yield span
    finally:
        _current.reset(token)


class Trace(list):
    """``get_trace`` result: a plain list of span rows (backwards
    compatible) carrying truncation metadata — when the task-event
    profile channel shed spans anywhere in the cluster, the trace may
    have holes and must not be read as complete."""

    truncated: bool = False
    dropped_spans: int = 0


def get_trace(trace_id: str, timeout: float = 30.0,
              min_spans: int = 0) -> Trace:
    """Fetch all recorded spans of a trace from the control plane.

    Remote workers flush their span buffers on a short period; with
    ``min_spans`` the query polls until that many spans arrived (or
    ``timeout`` elapses) instead of racing the flush.  The returned
    ``Trace`` is marked ``truncated`` when span rows were shed from any
    worker's task-event buffer (or the control-plane store cap) since
    the cluster started — the trace may be missing spans."""
    from ray_tpu_torch.core.core_worker import global_worker

    w = global_worker()
    deadline = time.monotonic() + timeout
    while True:
        # Push local spans out before asking.
        w._run_sync(w.task_events.flush())
        reply = w._run_sync(
            w.cp.call("list_task_events", {}, timeout=timeout)
        )
        spans = Trace()
        for ev in reply.get("profile_events", ()):
            extra = ev.get("extra") or {}
            if extra.get("span") and extra.get("trace_id") == trace_id:
                spans.append(ev)
        spans.dropped_spans = int(reply.get("num_span_drops", 0))
        spans.truncated = spans.dropped_spans > 0
        if len(spans) >= min_spans or time.monotonic() > deadline:
            return spans
        time.sleep(0.2)

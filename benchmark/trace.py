"""The traced run: the profiler's kernels on the host's clock, and what is
read from them.

CUDA activity only.  The profiler puts device timestamps on the host's
wall clock in nanoseconds (``time.time_ns()``), so the benchmark's own
spans, taken on that clock, name what the host was doing in each idle
gap.  It drops a kernel whose converted timestamps slip past the edge of
its window, so every reading keeps ``MARGIN_S`` inside the profiler's
window at each end (``chip_smoke.py:kernel_trace``'s margin): a serving
window does not stop, so the card is busy there and that part is not
read (``SubWindow``).
"""

from __future__ import annotations

import time
from typing import Dict, List, Sequence, Tuple

import numpy as np

MARGIN_S = 0.25

Span = Tuple[str, int, int]  # name, start ns, end ns (host wall clock)


class Trace:
    """The device's operations of a traced window, as arrays: each
    kernel's name (an index into ``names``), start and end in ns."""

    def __init__(self, names=(), idx=(), start=(), end=()):
        self.names: List[str] = list(names)
        self.idx = np.asarray(idx, dtype=np.int64)
        self.start = np.asarray(start, dtype=np.int64)
        self.end = np.asarray(end, dtype=np.int64)
        self.start_ns = 0  # the part of the window that is read
        self.end_ns = 0
        self.seconds: Dict[str, float] = {}  # what reading the trace took

    def __len__(self) -> int:
        return len(self.idx)

    def subset(self, mask) -> "Trace":
        out = Trace(self.names, self.idx[mask], self.start[mask],
                    self.end[mask])
        out.start_ns, out.end_ns = self.start_ns, self.end_ns
        return out

    def named(self, *keys: str) -> "Trace":
        """The kernels whose name holds one of ``keys``."""
        hit = np.array([any(k in n for k in keys) for n in self.names]
                       + [False], dtype=bool)
        return self.subset(hit[self.idx])

    def within(self, lo: int, hi: int) -> "Trace":
        """The kernels that start inside [lo, hi)."""
        return self.subset((self.start >= lo) & (self.start < hi))

    def total_s(self) -> float:
        return float((self.end - self.start).sum()) / 1e9


def _profile():
    import torch
    from torch.profiler import ProfilerActivity, profile

    # A CPU rehearsal traces the host only, and finds no device operation.
    activity = (ProfilerActivity.CUDA if torch.cuda.is_available()
                else ProfilerActivity.CPU)
    return profile(activities=[activity])


def device_events(prof) -> Trace:
    """The device's operations in a stopped profile."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    names: Dict[str, int] = {}
    idx, start, dur = [], [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda:
            continue
        idx.append(names.setdefault(e.name(), len(names)))
        start.append(e.start_ns())
        dur.append(e.duration_ns())
    start = np.asarray(start, dtype=np.int64)
    order = np.argsort(start, kind="stable")
    return Trace(names, np.asarray(idx, dtype=np.int64)[order], start[order],
                 start[order] + np.asarray(dur, dtype=np.int64)[order])


class SubWindow:
    """The profiler over ``seconds`` of a running window from ``at_ns``,
    with MARGIN_S more at each end that is not read; ``on_edge(t_ns)``
    runs at each read edge (to take counters there).  ``actions()`` are
    (time, call) pairs for the thread that runs the window to make at
    those times (the profiler is started and stopped from the thread
    that first used it); ``read()`` reads the events afterwards."""

    def __init__(self, at_ns: int, seconds: float, on_edge):
        self.trace = Trace()
        self._at, self._ns, self._on_edge = at_ns, int(seconds * 1e9), on_edge
        self._prof = None

    def actions(self) -> List[tuple]:
        margin = int(MARGIN_S * 1e9)
        return [(self._at - margin, self._open), (self._at, self._first),
                (self._at + self._ns, self._last),
                (self._at + self._ns + margin, self._close)]

    def _open(self) -> None:
        self._prof = _profile()
        self._prof.start()

    def _first(self) -> None:
        self.trace.start_ns = time.time_ns()
        self._on_edge(self.trace.start_ns)

    def _last(self) -> None:
        wait = (self.trace.start_ns + self._ns - time.time_ns()) / 1e9
        if wait > 0:  # the profiler's start ran late
            time.sleep(wait)
        self.trace.end_ns = time.time_ns()
        self._on_edge(self.trace.end_ns)

    def _close(self) -> None:
        t0 = time.perf_counter()
        self._prof.stop()
        self.trace.seconds["profiler_stop"] = time.perf_counter() - t0

    def read(self) -> Trace:
        """The kernels of the stopped profiler."""
        t0 = time.perf_counter()
        read = device_events(self._prof)
        tr = self.trace
        tr.names, tr.idx, tr.start, tr.end = (read.names, read.idx,
                                              read.start, read.end)
        tr.seconds["read_events"] = time.perf_counter() - t0
        return tr


def union(start: np.ndarray, end: np.ndarray):
    """Merged, sorted intervals of [start, end) pairs: (starts, ends)."""
    if len(start) == 0:
        return start, end
    order = np.argsort(start, kind="stable")
    s, e = start[order], end[order]
    reach = np.maximum.accumulate(e)
    new = np.ones(len(s), dtype=bool)
    new[1:] = s[1:] > reach[:-1]
    first = np.flatnonzero(new)
    last = np.append(first[1:] - 1, len(s) - 1)
    return s[first], reach[last]


def busy_ns(tr: Trace, lo: int, hi: int) -> int:
    """Nanoseconds of [lo, hi) in which some kernel ran."""
    s, e = union(np.clip(tr.start, lo, hi), np.clip(tr.end, lo, hi))
    return int((e - s).sum())


def top_ops(tr: Trace, lo: int, hi: int, n: int = 10) -> List[list]:
    """The device operations that took the most time inside [lo, hi):
    [name, seconds]."""
    dur = np.clip(tr.end, lo, hi) - np.clip(tr.start, lo, hi)
    total = np.bincount(tr.idx, weights=dur, minlength=len(tr.names))
    order = np.argsort(total)[::-1][:n]
    return [[tr.names[i][:120], float(total[i]) / 1e9] for i in order
            if total[i] > 0]


def host_label(spans: Sequence[Span], t: int) -> str:
    """What the host was doing at ``t``: the first of the benchmark's
    spans, in the order given (the most specific first), that covers
    it."""
    for name, s, e in spans:
        if s <= t < e:
            return name
    return "outside any span"


def idle_gaps(tr: Trace, spans: Sequence[Span], lo: int, hi: int,
              n: int = 10) -> List[list]:
    """The longest stretches of [lo, hi) with no kernel running, each
    named by what the host was doing when it began: [name, seconds]."""
    s, e = union(np.clip(tr.start, lo, hi), np.clip(tr.end, lo, hi))
    gap_start = np.concatenate([[lo], e])
    gap_end = np.concatenate([s, [hi]])
    length = gap_end - gap_start
    order = np.argsort(length)[::-1][:n]
    return [[host_label(spans, int(gap_start[i])), float(length[i]) / 1e9]
            for i in order if length[i] > 0]

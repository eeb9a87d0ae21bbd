"""device.idle.serve: the share of the traced part of the window in which
no kernel runs on the card (one minus the union of the kernels'
intervals), from the profiler's trace."""

from benchmark import records, trace


def read(record):
    tr = record.get("trace")
    if not records.is_serve(record) or tr is None or not len(tr):
        return None
    w0, w1 = record["window_ns"]
    return 100.0 * (1.0 - trace.busy_ns(tr, w0, w1) / (w1 - w0))

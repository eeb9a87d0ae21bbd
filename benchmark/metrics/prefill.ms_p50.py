"""prefill.ms_p50: the median of the benchmark's spans around each
``PrefillReplica.prefill`` that began inside the window."""

from benchmark import records


def read(record):
    if not records.is_serve(record):
        return None
    w0, w1 = record["window_ns"]
    ms = [(e - s) / 1e6 for n, s, e, _ in record["spans"]
          if n == "prefill" and w0 <= s < w1]
    return records.percentile(ms, 50) if ms else None

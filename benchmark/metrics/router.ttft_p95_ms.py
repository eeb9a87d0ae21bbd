"""router.ttft_p95_ms: the 95th percentile, over every request due in the
window, of the time from when it was due to its first token at the
client.  A request with no first token by the end of the wait counts the
whole wait.  Read over the whole window, also in the traced run."""

from benchmark import records


def read(record):
    if not records.is_serve(record):
        return None
    due = record["requests"]
    if not due:
        return None
    end = record["wait_end_ns"]
    return records.percentile(
        [((r["first_ns"] or end) - r["due_ns"]) / 1e6 for r in due], 95)

"""router.tpot_p95_ms: the 95th percentile, over requests due in the
window whose last token reached the client before it closed, of (last
token - first token) / (tokens - 1).  Read over the whole window, also
in the traced run, whose traced part may end no request."""

from benchmark import records


def read(record):
    if not records.is_serve(record):
        return None
    tpot = [(r["last_ns"] - r["first_ns"]) / 1e6 / (r["tokens"] - 1)
            for r in record["requests"]
            if not r["failed"] and r["tokens"] >= 2
            and r["last_ns"] < record["closed_ns"]]
    return records.percentile(tpot, 95) if tpot else None

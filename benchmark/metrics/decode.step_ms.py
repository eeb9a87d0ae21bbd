"""decode.step_ms: the engine's own time a decode step over the window:
the sum over the bucket programs of ``decode_s`` over the sum of their
``steps``, each a difference of ``stats()["programs"]`` across the
window."""

from benchmark import records


def read(record):
    if not records.is_serve(record):
        return None
    p0, p1 = record["stats0"]["programs"], record["stats1"]["programs"]
    steps = sum(p["steps"] - p0.get(b, {}).get("steps", 0)
                for b, p in p1.items())
    secs = sum(p["decode_s"] - p0.get(b, {}).get("decode_s", 0.0)
               for b, p in p1.items())
    return secs / steps * 1e3 if steps > 0 else None

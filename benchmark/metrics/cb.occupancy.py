"""cb.occupancy: mean live slots a decode step: the tokens decode steps
delivered inside the window (each request's first token comes from its
prefill) over the engine's decode steps in the window
(``ContinuousBatchingEngine.stats()["steps"]``)."""

from benchmark import records


def read(record):
    if not records.is_serve(record):
        return None
    steps = record["stats1"]["steps"] - record["stats0"]["steps"]
    if steps <= 0:
        return None
    return records.window_tokens(record)["decode_tokens"] / steps

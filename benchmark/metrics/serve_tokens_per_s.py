"""serve_tokens_per_s: output tokens that reached clients inside the
window, over the window."""

from benchmark import records


def read(record):
    if not records.is_serve(record):
        return None
    return records.window_tokens(record)["tokens"] / record["seconds"]

"""serve.mfu: model FLOPs of the work done inside the window (the
prefills that ended in it, the decode tokens delivered in it, attention
over their live positions included) over the window, as a share of the
card's bf16 peak."""

from benchmark import flops, records


def read(record):
    if not records.is_serve(record):
        return None
    return (100.0 * records.serve_flops(record) / record["seconds"]
            / flops.PEAK_BF16_FLOPS)

"""flash_fwd.roofline.serve: the flash forward's share of its roofline in
the prefills of the traced part of the window: the sum of the launches'
bounds (max of FLOPs over the bf16 peak and bytes over HBM bandwidth,
from each prefill's shape [1, n, H, D], causal, one launch a layer) over
the ``flash_fwd`` kernels' device time there.  A prefill that straddles
an edge of that part counts the share of its span inside it."""

from benchmark import flops, records


def read(record):
    tr = record.get("trace")
    if not records.is_serve(record) or tr is None:
        return None
    w0, w1 = record["window_ns"]
    kernels = tr.named("flash_fwd").within(w0, w1)
    if not len(kernels):
        return None
    d = record["dims"]
    head_dim = d["d_model"] // d["n_head"]
    bound = 0.0
    for name, s, e, a in record["spans"]:
        inside = min(e, w1) - max(s, w0)
        if name == "prefill" and inside > 0:
            bound += inside / max(e - s, 1) * d["n_layer"] * flops.bound_s(
                flops.flash_fwd_cost(1, a["tokens"], d["n_head"], head_dim))
    return 100.0 * bound / kernels.total_s()

"""decode_attn.roofline.serve: the decode kernel's share of its roofline
in the traced part of the window: the bytes of the live K/V positions,
plus q and out, of every decode step whose tokens reached the clients
there, over HBM bandwidth, against the ``decode_attention`` kernels'
device time there."""

from benchmark import flops, records


def read(record):
    tr = record.get("trace")
    if not records.is_serve(record) or tr is None:
        return None
    w0, w1 = record["window_ns"]
    kernels = tr.named("decode_attention").within(w0, w1)
    if not len(kernels):
        return None
    d = record["dims"]
    tok = records.window_tokens(record)
    nbytes = flops.decode_attention_bytes(
        tok["decode_positions"], tok["decode_tokens"], d["n_layer"],
        d["n_head"], d["d_model"] // d["n_head"])
    return (100.0 * nbytes / flops.PEAK_HBM_BYTES_PER_S
            / kernels.total_s())

"""Operations and bytes of the work a cell does, reckoned from its shapes,
and the card's peaks they are held against.

Each input byte is read once and each output byte written once; the
FLOPs are the least the computation needs (causal attention counts its
live pairs only).
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate and HBM3 bandwidth.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12
BF16_BYTES = 2


def matmul_weights(n_layer: int, d_model: int, vocab: int) -> dict:
    """GPT-2's matmul weights: a block's qkv (3E²), out (E²) and MLP (8E²)
    projections, and the unembedding tied to the token table (V·E)."""
    return {"blocks": n_layer * 12 * d_model * d_model,
            "unembed": vocab * d_model}


def flash_fwd_cost(b: int, s: int, h: int, d: int, causal: bool = True,
                   item: int = BF16_BYTES) -> dict:
    """The flash forward: QK^T and PV over the live pairs; q, k, v read and
    out written once, and the f32 log-sum-exp written."""
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 4 * b * h * d * pairs
    nbytes = 4 * b * s * h * d * item + b * h * s * 4
    return {"flops": flops, "bytes": nbytes}


def bound_s(cost: dict) -> float:
    """The least time the card could take: the larger of FLOPs over the
    bf16 peak and bytes over the HBM bandwidth."""
    return max(cost["flops"] / PEAK_BF16_FLOPS,
               cost["bytes"] / PEAK_HBM_BYTES_PER_S)


def decode_live_positions(prompt_len: int, n_out: int) -> int:
    """Cache positions the decode steps of one request attend to.  The
    prefill gives the first of ``n_out`` tokens; decode step j (1-based)
    takes the token at position prompt_len + j - 1 and attends to the
    prompt_len + j positions [0, prompt_len + j - 1]."""
    m = max(0, n_out - 1)
    return m * prompt_len + m * (m + 1) // 2


def decode_attention_bytes(live_positions: int, rows: int, n_layer: int,
                           n_head: int, head_dim: int,
                           item: int = BF16_BYTES) -> int:
    """The decode kernel's bytes over a set of launches: the K and V rows
    of every live position read once, q read and out written once a row
    (``rows`` = decode tokens), in every layer."""
    kv = 2 * live_positions * n_head * head_dim * item
    q_out = 2 * rows * n_head * head_dim * item
    return n_layer * (kv + q_out)


def serve_flops(n_layer: int, n_head: int, d_model: int, vocab: int,
                prompt_tokens: int, prefills: int, decode_tokens: int,
                prefill_pairs: int, decode_positions: int) -> float:
    """Model FLOPs of serving: 2 a block weight a prompt token, the
    unembedding once a prefill (its last position's logits only); 2 a
    weight, unembedding included, a decode token; attention 4·D a live
    (query, key) pair, head and layer."""
    w = matmul_weights(n_layer, d_model, vocab)
    head_dim = d_model // n_head
    attn = 4 * head_dim * n_head * n_layer
    return (2.0 * w["blocks"] * prompt_tokens
            + 2.0 * w["unembed"] * prefills
            + 2.0 * (w["blocks"] + w["unembed"]) * decode_tokens
            + attn * (prefill_pairs + decode_positions))

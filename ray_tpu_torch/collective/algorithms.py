"""Collective algorithm library — the lowering targets of the selection
layer (``tuner.py``).

Port of ``ray_tpu/collective/algorithms.py``.  The JAX algorithms are pure
functions inside a ``shard_map`` body, exchanging chunks with ``ppermute``
over a named mesh axis.  Here each one runs over the exchange primitive of
the group that calls it (``Comm`` below): a list of per-rank tensors that
all live in this process (``LocalGroup``: every rank), or one tensor per
process with send/recv between processes (``DistGroup``: its own rank).
Every algorithm follows the JAX step schedule chunk for chunk, so it
reassociates the sum exactly as the JAX one does:

  ``flat``       one collective of the group — latency-optimal for small
                 messages.
  ``ring``       chunked ``ppermute`` pipeline: 2(n-1) steps moving
                 ``size/n`` bytes each — bandwidth-optimal for large
                 messages.
  ``tree``       recursive halving-doubling: 2·log2(n) steps — fewer
                 rounds than ring for latency-bound mid sizes; requires a
                 power-of-two world.
  ``two_level``  hierarchical decomposition for multi-slice topologies:
                 reduce-scatter over the intra-slice axis, exchange only
                 ``size/n_ici`` bytes over the inter-slice axis, all-gather
                 back over the intra-slice axis.
  ``*_q8``       EQuARX-style block-quantized variants (arxiv
                 2506.17615): int8 blocks with per-block fp32 scales cut
                 wire bytes ~4x on bandwidth-bound gradient exchange with
                 a bounded per-block error.  Opt-in only — SUM is exact
                 when quantization is off.

All non-flat algorithms are SUM-only; other reduce ops keep the flat
lowering.  Numerical note: ring/tree/two_level reassociate the sum, so
float results can differ from flat psum by normal rounding — integer-
valued payloads reduce exactly.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, List, Protocol, Sequence, Tuple

import numpy as np

from .types import ReduceOp

if TYPE_CHECKING:
    import torch

# Per-block quantization width (elements).  128-1024 trades scale
# overhead (4 bytes per block) against outlier blast radius; EQuARX uses
# comparable block shapes.
DEFAULT_QUANT_BLOCK = 256

# Algorithm names (the tuner's candidate vocabulary).
FLAT = "flat"
RING = "ring"
TREE = "tree"
TWO_LEVEL = "two_level"
FLAT_Q8 = "flat_q8"
TWO_LEVEL_Q8 = "two_level_q8"

_QUANT_DTYPES = ("float32", "bfloat16", "float16")


def dtype_name(dtype) -> str:
    """``"float32"`` for ``torch.float32``, ``np.float32`` or the string."""
    return str(dtype).removeprefix("torch.")


def is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def quantizable_dtype(dtype) -> bool:
    return dtype_name(dtype) in _QUANT_DTYPES


def allreduce_candidates(world_size: int, topology,
                         quantized: bool = False) -> Tuple[str, ...]:
    """Eligible allreduce algorithms for (world, topology, quantized) —
    deterministic order; the first entry is the safe default."""
    if world_size <= 1:
        return (FLAT,)
    if quantized:
        # Quantization targets the bandwidth-bound exchange: the DCN hop
        # of a two-level decomposition when the topology has one, else
        # the gather-based one-shot.
        if topology is not None and topology.is_two_level:
            return (TWO_LEVEL_Q8, FLAT_Q8)
        return (FLAT_Q8,)
    cands = [FLAT, RING]
    if is_pow2(world_size):
        cands.append(TREE)
    if topology is not None and topology.is_two_level:
        cands.append(TWO_LEVEL)
    return tuple(cands)


def allgather_candidates(world_size: int, topology) -> Tuple[str, ...]:
    if world_size <= 1:
        return (FLAT,)
    return (FLAT, RING)


def reducescatter_candidates(world_size: int, topology) -> Tuple[str, ...]:
    if world_size <= 1:
        return (FLAT,)
    return (FLAT, RING)


def candidates_for(op: str, world_size: int, topology,
                   quantized: bool = False) -> Tuple[str, ...]:
    if op == "allreduce":
        return allreduce_candidates(world_size, topology, quantized)
    if op == "allgather":
        return allgather_candidates(world_size, topology)
    if op == "reducescatter":
        return reducescatter_candidates(world_size, topology)
    return (FLAT,)


def resolve_quantized(op: ReduceOp, dtype, quantized) -> bool:
    """Resolve a per-call ``quantized`` flag (None = process default)
    and validate eligibility.  The blanket process opt-in silently skips
    ineligible payloads (int, non-SUM); an EXPLICIT ``quantized=True``
    on an ineligible call raises.  Shared by both group backends."""
    if quantized is None:
        from ..core.config import GlobalConfig

        quantized = GlobalConfig.collective_quantized_allreduce
        if quantized and not (
            op == ReduceOp.SUM and quantizable_dtype(dtype)
        ):
            return False
    if quantized:
        if op != ReduceOp.SUM:
            raise ValueError(
                f"quantized allreduce supports SUM only (got {op})"
            )
        if not quantizable_dtype(dtype):
            raise ValueError(
                f"quantized allreduce needs a float payload, got {dtype}"
            )
    return bool(quantized)


# ---------------------------------------------------------- the exchange
class Comm(Protocol):
    """What a group gives the algorithms: the ranks whose tensors it holds
    (every rank in ``LocalGroup``, its own in ``DistGroup``) and, over a
    named axis, their positions, the axis size, the ring exchange and the
    flat collectives.  Axes: ``"world"`` (every rank), ``"ici"`` (the
    ranks of one slice) and ``"dcn"`` (one position across slices), with
    rank = dcn index x ici size + ici index.  Every method takes and
    returns one tensor per held rank, in order."""

    def index(self, axis: str) -> List[int]: ...

    def size(self, axis: str) -> int: ...

    def ppermute(self, xs: Sequence["torch.Tensor"], axis: str,
                 perm: Sequence[Tuple[int, int]]) -> List["torch.Tensor"]:
        """Each held rank at axis position ``src`` sends its tensor to
        position ``dst`` for every ``(src, dst)`` in ``perm``; returns what
        each held rank received."""

    def psum(self, xs, axis: str) -> List["torch.Tensor"]: ...

    def psum_scatter(self, xs, axis: str) -> List["torch.Tensor"]:
        """Position i keeps part i (dim 0) of the sum over the axis."""

    def all_gather(self, xs, axis: str,
                   tiled: bool = False) -> List["torch.Tensor"]:
        """Every position's tensor, stacked on a new dim 0 (or
        concatenated along dim 0 when ``tiled``)."""


def sum_ranks(parts: Sequence["torch.Tensor"]) -> "torch.Tensor":
    """Sum in rank order, one add at a time: the order of XLA's flat
    ``psum`` (``tensor.sum(0)`` reassociates)."""
    total = parts[0].clone()
    for p in parts[1:]:
        total += p.to(total.device)
    return total


# ------------------------------------------------------------ shape plumbing
def _pad_flat(x, multiple):
    """Flatten ``x`` and zero-pad to a multiple; returns (flat, orig_size)."""
    import torch

    flat = x.reshape(-1)
    pad = (-flat.numel()) % multiple
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat, x.numel()


def _unpad(flat, size, shape):
    return flat[:size].reshape(shape)


# --------------------------------------------------------------- ring family
def ring_allreduce(comm: Comm, xs, axis: str = "world"):
    """Bandwidth-optimal ring: n-1 reduce-scatter steps + n-1 all-gather
    steps, each moving one 1/n chunk over ``ppermute``."""
    import torch

    n = comm.size(axis)
    if n <= 1:
        return list(xs)
    padded = [_pad_flat(x, n) for x in xs]
    chunks = [flat.reshape(n, -1) for flat, _ in padded]
    rs = comm.index(axis)
    perm = [(i, (i + 1) % n) for i in range(n)]
    send = [c[r % n] for c, r in zip(chunks, rs)]
    for s in range(n - 1):
        recv = comm.ppermute(send, axis, perm)
        send = [rv + c[(r - s - 1) % n]
                for rv, c, r in zip(recv, chunks, rs)]
    # ``send`` now holds the fully reduced chunk (r+1) mod n.
    outs = [torch.zeros_like(c) for c in chunks]
    for out, sd, r in zip(outs, send, rs):
        out[(r + 1) % n] = sd
    buf = send
    for s in range(n - 1):
        buf = comm.ppermute(buf, axis, perm)
        for out, b, r in zip(outs, buf, rs):
            out[(r - s) % n] = b
    return [_unpad(out.reshape(-1), size, x.shape)
            for out, (_, size), x in zip(outs, padded, xs)]


def ring_reducescatter(comm: Comm, xs, axis: str = "world"):
    """Rank r keeps chunk r (axis-0 split) of the elementwise sum — the
    reduce-scatter half of the ring.  ``x.shape[0]`` must divide by n."""
    n = comm.size(axis)
    if n <= 1:
        return list(xs)
    chunks = [x.reshape(n, x.shape[0] // n, *x.shape[1:]) for x in xs]
    rs = comm.index(axis)
    perm = [(i, (i + 1) % n) for i in range(n)]
    send = [c[r % n] for c, r in zip(chunks, rs)]
    for s in range(n - 1):
        recv = comm.ppermute(send, axis, perm)
        send = [rv + c[(r - s - 1) % n]
                for rv, c, r in zip(recv, chunks, rs)]
    # After n-1 steps rank r holds reduced chunk (r+1)%n; one final shift
    # aligns chunk r with rank r (matching psum_scatter's layout).
    return comm.ppermute(send, axis, perm)


def ring_allgather(comm: Comm, xs, axis: str = "world"):
    """All ranks end with the (n, *shape) stack of every rank's tensor,
    built by circulating tensors n-1 hops around the ring."""
    n = comm.size(axis)
    if n <= 1:
        return [x[None] for x in xs]
    rs = comm.index(axis)
    perm = [(i, (i + 1) % n) for i in range(n)]
    outs = [x.new_zeros((n, *x.shape)) for x in xs]
    for out, x, r in zip(outs, xs, rs):
        out[r] = x
    buf = list(xs)
    for s in range(n - 1):
        buf = comm.ppermute(buf, axis, perm)
        for out, b, r in zip(outs, buf, rs):
            out[(r - s - 1) % n] = b
    return outs


# ---------------------------------------------------------------- tree family
def tree_allreduce(comm: Comm, xs, axis: str = "world"):
    """Recursive halving-doubling (a butterfly over rank-XOR partners):
    log2(n) halving-reduce steps then log2(n) doubling-gather steps.
    Requires power-of-two ``n``."""
    import torch

    n = comm.size(axis)
    if n <= 1:
        return list(xs)
    if not is_pow2(n):
        raise ValueError(f"tree allreduce needs a power-of-two world, got {n}")
    padded = [_pad_flat(x, n) for x in xs]
    rs = comm.index(axis)
    bufs = [flat for flat, _ in padded]
    d = n // 2
    while d >= 1:
        perm = [(i, i ^ d) for i in range(n)]
        half = bufs[0].shape[0] // 2
        # Bit clear -> this rank owns the LOW half after the step: it
        # sends the high half and reduces into the low.  Bit set: mirror.
        send = [b[:half] if r & d else b[half:] for b, r in zip(bufs, rs)]
        keep = [b[half:] if r & d else b[:half] for b, r in zip(bufs, rs)]
        recv = comm.ppermute(send, axis, perm)
        bufs = [k + rv for k, rv in zip(keep, recv)]
        d //= 2
    # bufs hold the reduced 1/n chunk starting at r*chunk; gather back.
    d = 1
    while d < n:
        perm = [(i, i ^ d) for i in range(n)]
        recv = comm.ppermute(bufs, axis, perm)
        # Bit clear: my chunk precedes the partner's.
        bufs = [torch.cat([rv, b]) if r & d else torch.cat([b, rv])
                for b, rv, r in zip(bufs, recv, rs)]
        d *= 2
    return [_unpad(b, size, x.shape)
            for b, (_, size), x in zip(bufs, padded, xs)]


# --------------------------------------------------------- two-level family
def two_level_allreduce(comm: Comm, xs, n_ici: int,
                        quantized: bool = False,
                        block_size: int = DEFAULT_QUANT_BLOCK):
    """Hierarchical allreduce for multi-slice topologies: reduce-scatter
    over ICI, allreduce the 1/n_ici chunk over DCN (optionally block-
    quantized — the DCN hop is the bandwidth bottleneck), all-gather
    over ICI."""
    padded = [_pad_flat(x, n_ici) for x in xs]
    chunks = comm.psum_scatter([flat for flat, _ in padded], "ici")
    if quantized:
        chunks = quantized_allreduce(comm, chunks, "dcn",
                                     block_size=block_size)
    else:
        chunks = comm.psum(chunks, "dcn")
    full = comm.all_gather(chunks, "ici", tiled=True)
    return [_unpad(f, size, x.shape)
            for f, (_, size), x in zip(full, padded, xs)]


# ------------------------------------------------------------- quantization
def _safe_scales(amax):
    """Per-block scale ``amax/127`` with all-zero blocks mapped to scale 1
    (their quantized payload is exactly zero either way — no div-by-zero,
    no NaN)."""
    import torch

    scale = amax / 127.0
    return torch.where(amax > 0, scale, torch.ones_like(scale))


def quantize_blocks(x, block_size: int = DEFAULT_QUANT_BLOCK):
    """Block-quantize a tensor: int8 payload + per-block fp32 scales.
    Returns ``(q, scales, orig_size)``; blocks are ``block_size`` flat
    elements, zero-padded at the tail."""
    import torch

    flat, size = _pad_flat(x, block_size)
    blocks = flat.reshape(-1, block_size).float()
    amax = blocks.abs().amax(dim=1)
    scales = _safe_scales(amax)
    q = torch.clamp(torch.round(blocks / scales[:, None]), -127, 127).to(
        torch.int8
    )
    return q, scales, size


def dequantize_blocks(q, scales, size, shape, dtype):
    deq = q.float() * scales[:, None]
    return _unpad(deq.reshape(-1), size, shape).to(dtype)


def quantized_allreduce(comm: Comm, xs, axis: str = "world",
                        block_size: int = DEFAULT_QUANT_BLOCK):
    """One-shot block-quantized allreduce: quantize locally, all-gather
    the int8 payload + scales (~4x fewer wire bytes than fp32), then
    dequantize-and-sum in fp32.  Per-element error is bounded by
    ``sum_r amax_block_r / 254`` (round-to-nearest of each rank's
    contribution; see docs/collective.md)."""
    parts = [quantize_blocks(x, block_size) for x in xs]
    qg = comm.all_gather([q for q, _, _ in parts], axis)  # (n, nblocks, B)
    sg = comm.all_gather([s for _, s, _ in parts], axis)  # (n, nblocks)
    out = []
    for q_all, s_all, (_, _, size), x in zip(qg, sg, parts, xs):
        deq = q_all.float() * s_all[:, :, None]
        total = sum_ranks(list(deq))
        out.append(_unpad(total.reshape(-1), size, x.shape).to(x.dtype))
    return out


def quantized_wire_bytes(nbytes: int, dtype, block_size: int =
                         DEFAULT_QUANT_BLOCK) -> int:
    """Bytes actually exchanged per rank for a quantized payload of
    ``nbytes`` logical bytes: int8 payload + one fp32 scale per block."""
    name = dtype_name(dtype)
    itemsize = max(1, np.dtype(name).itemsize if name !=
                   "bfloat16" else 2)
    elems = nbytes // itemsize
    nblocks = -(-elems // block_size)
    return elems + 4 * nblocks


# ------------------------------------------------- host-side (numpy) variant
# The pipeline trainer quantizes inter-stage gradient pushes on the host
# (the payload is already a host view at that point); same block format.
def quantize_blocks_np(arr: np.ndarray,
                       block_size: int = DEFAULT_QUANT_BLOCK):
    flat = np.asarray(arr, np.float32).reshape(-1)
    size = flat.size
    pad = (-size) % block_size
    if pad:
        flat = np.concatenate([flat, np.zeros(pad, np.float32)])
    blocks = flat.reshape(-1, block_size)
    amax = np.abs(blocks).max(axis=1)
    scales = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.round(blocks / scales[:, None]), -127, 127).astype(np.int8)
    return q, scales, size


def dequantize_blocks_np(q: np.ndarray, scales: np.ndarray, size: int,
                         shape, dtype) -> np.ndarray:
    deq = q.astype(np.float32) * scales[:, None]
    return deq.reshape(-1)[:size].reshape(shape).astype(dtype)


def flat_reduce(parts: Sequence["torch.Tensor"],
                op: ReduceOp) -> "torch.Tensor":
    """The flat reduction of per-rank tensors, in rank order: XLA's
    ``psum``/``pmax``/``pmin``/``pmean`` and the gathered product."""
    import torch

    if op == ReduceOp.SUM:
        return sum_ranks(parts)
    if op == ReduceOp.MEAN:
        return sum_ranks(parts) / len(parts)
    combine = {ReduceOp.MAX: torch.maximum, ReduceOp.MIN: torch.minimum,
               ReduceOp.PRODUCT: torch.mul}[op]
    total = parts[0].clone()
    for p in parts[1:]:
        total = combine(total, p.to(total.device))
    return total

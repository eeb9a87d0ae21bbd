"""Cross-slice MPMD pipeline parallelism: stage actors + 1F1B microbatch
streaming.

Where ``parallel/pipeline.py`` expresses a pipeline as one SPMD program
(GPipe over the ``stage`` mesh axis, single slice), this module is the
MPMD design of "Scaling Deep Learning Training with MPMD Pipeline
Parallelism" (arxiv 2412.14374): each pipeline stage is a **long-lived
actor** pinned to its own placement-group bundle (one stage per TPU
slice), activations and gradients stream between adjacent stages as
microbatches over the zero-copy p2p path
(``collective.p2p.StageChannel`` → ``SerializedPayload`` out-of-band
framing), and an interleaved 1F1B schedule bounds the pipeline bubble.
DP composes *within* a stage (``PipelineConfig.dp_devices_per_stage``:
each microbatch is split over the ranks of a ``LocalGroup`` on the
stage's devices, and their gradients are summed by its allreduce), PP
composes *across* stages — exactly the paper's PP-outside / DP-inside
split.

A stage runs on the card its actor leased (``resources_per_stage["GPU"]``)
and on the CPU when it leased none.  Each chunk keeps only its input
between its forward and its backward, and the backward recomputes the
forward under autograd, as the JAX package's ``jax.vjp`` does.

The model is declared as a list of virtual-stage **modules** produced by
a ``module_builder(virtual_idx, total_virtual) -> StageModule`` callable
(cloudpickled to the stage actors).  Virtual stage ``v`` lives on actor
``v % num_stages`` (Megatron-style interleaving); module 0 consumes the
raw per-microbatch input, the last module computes the scalar loss.

Failure semantics: the driver checkpoints all stages synchronously
(initially and every ``checkpoint_every_n_steps``); a stage-actor death
is detected by the step deadline, the dead actor is restarted into the
same bundle, every stage reloads the last synchronized checkpoint, and
training resumes from that step (bounded by ``FailureConfig.max_failures``).

Self-instrumentation (flight recorder): per-stage forward/backward/stall
histograms, a computed bubble-fraction gauge, inter-stage activation
bytes + achieved bandwidth — all under the ``ray_tpu_pipeline_*`` names
documented in docs/observability.md.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import pickle
import time
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.core.serialization import dumps_function

from .config import FailureConfig, PipelineConfig, Result, RunConfig

logger = logging.getLogger(__name__)


# ------------------------------------------------- quantized grad exchange
@dataclasses.dataclass
class _QuantizedLeaf:
    """One block-quantized tensor riding a B-edge push: int8 payload,
    per-block fp32 scales, and enough metadata to restore the original
    tensor (its shape and torch dtype)."""

    q: Any
    scales: Any
    size: int
    shape: tuple
    dtype: Any


def _quantize_grad_tree(tree, block_size: int):
    """Quantize every float leaf of a gradient pytree for the wire
    (non-float leaves pass through untouched).  The blocks round as the
    collective layer's numpy twins do (``quantize_blocks_np``)."""
    import torch
    from torch.utils import _pytree as pytree

    from ray_tpu_torch.collective import algorithms as alg

    def q(leaf):
        if not isinstance(leaf, torch.Tensor) or not alg.quantizable_dtype(
                leaf.dtype):
            return leaf
        qv, scales, size = alg.quantize_blocks(leaf, block_size)
        return _QuantizedLeaf(qv, scales, size, tuple(leaf.shape),
                              leaf.dtype)

    return pytree.tree_map(q, tree)


def _dequantize_grad_tree(tree):
    from torch.utils import _pytree as pytree

    from ray_tpu_torch.collective import algorithms as alg

    def d(leaf):
        if isinstance(leaf, _QuantizedLeaf):
            return alg.dequantize_blocks(
                leaf.q, leaf.scales, leaf.size, leaf.shape, leaf.dtype
            )
        return leaf

    return pytree.tree_map(d, tree)


# --------------------------------------------------------------- schedule
@dataclasses.dataclass(frozen=True)
class PipeOp:
    """One slot of a stage's static schedule: run ``kind`` ("F"/"B") for
    ``microbatch`` through local model chunk ``chunk``."""

    kind: str
    chunk: int
    microbatch: int


def build_1f1b_schedule(
    num_stages: int, num_microbatches: int, interleave: int = 1
) -> List[List[PipeOp]]:
    """Per-stage op order for (interleaved) 1F1B.

    Non-interleaved (``interleave == 1``): stage ``s`` runs
    ``min(M, S-1-s)`` warmup forwards, then alternates F/B (the steady
    1F1B window), then drains backwards — at most ``S - s`` microbatches
    are ever in flight on a stage.  Interleaved: the Megatron-LM virtual
    -stage schedule; microbatches advance in groups of ``num_stages``
    per chunk, warmup grows by ``(V-1)·S``, and the bubble shrinks by
    ``1/V``.  Returns ``schedules[stage] -> [PipeOp, ...]``.
    """
    S, M, V = num_stages, num_microbatches, interleave
    if S < 1 or M < 1 or V < 1:
        raise ValueError("num_stages, num_microbatches, interleave >= 1")
    if V > 1 and M % S != 0:
        raise ValueError(
            "interleaved 1F1B needs num_microbatches divisible by "
            f"num_stages (got {M} over {S})"
        )
    total = M * V

    def chunk_of(counter: int, forward: bool) -> int:
        c = (counter % (S * V)) // S
        return c if forward else V - 1 - c

    def mb_of(counter: int) -> int:
        return (counter // (S * V)) * S + counter % S

    schedules: List[List[PipeOp]] = []
    for s in range(S):
        if V == 1:
            warmup = min(M, S - 1 - s)
        else:
            warmup = min(total, (S - 1 - s) * 2 + (V - 1) * S)
        ops: List[PipeOp] = []
        f = b = 0
        for _ in range(warmup):
            ops.append(PipeOp("F", chunk_of(f, True), mb_of(f)))
            f += 1
        for _ in range(total - warmup):
            ops.append(PipeOp("F", chunk_of(f, True), mb_of(f)))
            f += 1
            ops.append(PipeOp("B", chunk_of(b, False), mb_of(b)))
            b += 1
        for _ in range(warmup):
            ops.append(PipeOp("B", chunk_of(b, False), mb_of(b)))
            b += 1
        schedules.append(ops)
    return schedules


def theoretical_bubble_fraction(
    num_stages: int, num_microbatches: int, interleave: int = 1
) -> float:
    """The classic 1F1B bubble bound: (S-1) / (S-1 + M·V)."""
    s1 = num_stages - 1
    return s1 / (s1 + num_microbatches * interleave)


# ----------------------------------------------------------- model chunks
@dataclasses.dataclass
class StageModule:
    """One virtual stage of the model.

    ``init(gen) -> params`` (a tree of tensors; ``gen`` is a
    ``torch.Generator`` on the chunk's device); ``apply(params, x) -> y``
    for interior
    modules, ``apply(params, x, targets) -> scalar loss`` when
    ``is_loss_stage`` (the final virtual stage).  The first module's
    ``x`` is the raw microbatch input (e.g. int32 tokens) and is treated
    as non-differentiable."""

    init: Callable
    apply: Callable
    is_loss_stage: bool = False


def gpt2_stage_modules(cfg, total_virtual: int, seed: int = 0):
    """Split a GPT-2 into ``total_virtual`` sequential chunks.

    Chunk 0 owns the embeddings + the first layers; the last chunk owns
    the remaining layers, the final layernorm, and an (untied) copy of
    the unembedding matrix + the loss.  All chunks slice their
    parameters out of one ``gpt2_init`` draw sequence from ``seed``, so a
    pipelined run and the sequential reference start from bit-identical
    weights.  Returns a ``module_builder`` for :class:`PipelinedTrainer`.
    """
    if total_virtual < 1 or cfg.n_layer < total_virtual:
        raise ValueError(
            f"cannot split {cfg.n_layer} layers into {total_virtual} chunks"
        )
    bounds = [
        (cfg.n_layer * v // total_virtual,
         cfg.n_layer * (v + 1) // total_virtual)
        for v in range(total_virtual)
    ]

    def module_builder(v: int, total: int) -> StageModule:
        assert total == total_virtual
        import torch

        from ray_tpu_torch.device import dtype_of
        from ray_tpu_torch.models.gpt2 import (
            _ce_from_logits,
            _block,
            _layernorm,
        )
        from ray_tpu_torch.models.params import normal

        lo, hi = bounds[v]
        first, last = v == 0, v == total_virtual - 1

        def init(gen):
            # The partition is drawn from the builder's seed (not the
            # trainer's generator) so every chunk derives from the same
            # virtual full model.  Mirrors gpt2_init's draw SEQUENCE
            # exactly, on the generator's device, but holds one full
            # tensor at a time and keeps only this chunk's [lo:hi] slice
            # — a stage's resident memory is its share of the model
            # (equality with gpt2_init slicing is regression-pinned in
            # tests/test_torch_train_pipeline.py).
            dev = gen.device
            g = torch.Generator(device=dev).manual_seed(seed)
            e, h, d, L = cfg.d_model, cfg.n_head, cfg.head_dim, cfg.n_layer
            dt = dtype_of(cfg.dtype)
            s = 0.02
            so = s / (2 * L) ** 0.5  # gpt-2 residual-out scaling
            n = hi - lo

            def draw(shape, scale, keep, sl=None):
                # A torch generator cannot skip a draw: every tensor is
                # drawn (sequence parity), only what this chunk keeps
                # stays.
                t = normal(g, shape, scale, dt, dev)
                if not keep:
                    return None
                return t[sl].clone() if sl is not None else t

            def const(fill, shape):
                return fill(shape, dtype=dt, device=dev)

            sl = slice(lo, hi)
            wte = draw((cfg.vocab_size, e), s, first or last)
            wpe = draw((cfg.max_seq, e), s, first)
            params = {
                "blocks": {
                    "ln1_g": const(torch.ones, (n, e)),
                    "ln1_b": const(torch.zeros, (n, e)),
                    "wqkv": draw((L, e, 3, h, d), s, True, sl),
                    "bqkv": const(torch.zeros, (n, 3, h, d)),
                    "wo": draw((L, h, d, e), so, True, sl),
                    "bo": const(torch.zeros, (n, e)),
                    "ln2_g": const(torch.ones, (n, e)),
                    "ln2_b": const(torch.zeros, (n, e)),
                    "wi": draw((L, e, 4 * e), s, True, sl),
                    "bi": const(torch.zeros, (n, 4 * e)),
                    "wo2": draw((L, 4 * e, e), so, True, sl),
                    "bo2": const(torch.zeros, (n, e)),
                },
            }
            if first:
                params["wte"] = wte
                params["wpe"] = wpe
            if last:
                params["lnf_g"] = const(torch.ones, (e,))
                params["lnf_b"] = const(torch.zeros, (e,))
                # Untied unembedding: starts equal to wte, trains on the
                # unembed gradient only (standard for pipeline splits —
                # tying would make wte's gradient span two stages).  Its
                # own tensor, so a one-chunk model updates each once.
                params["unembed"] = wte.clone()
            return params

        def run_blocks(params, x):
            blocks = params["blocks"]
            for i in range(hi - lo):
                x = _block(x, {k: t[i] for k, t in blocks.items()}, cfg)
            return x

        def apply(params, x, targets=None):
            if first:
                s = x.shape[1]
                h = params["wte"][x] + params["wpe"][:s][None]
            else:
                h = x
            h = run_blocks(params, h)
            if not last:
                return h
            h = _layernorm(h, params["lnf_g"], params["lnf_b"])
            logits = torch.einsum("bse,ve->bsv", h, params["unembed"])
            b, s = targets.shape
            return _ce_from_logits(logits, targets.long(), 0.0) / (b * s)

        return StageModule(init=init, apply=apply, is_loss_stage=last)

    return module_builder


# ------------------------------------------------------------ chunk state
class _Chunk:
    """Executor for one virtual stage resident on a stage actor: forward
    without autograd, backward by recomputing the forward under autograd
    (only the input is kept in between, as ``jax.vjp`` there), in-flight
    input stash, gradient accumulator, AdamW."""

    def __init__(self, vidx: int, total_v: int, module: StageModule,
                 rng_seed: int, lr: float, dp_group=None, device=None):
        import torch
        from torch.utils import _pytree as pytree

        self.vidx = vidx
        self.is_first = vidx == 0
        self.is_last = vidx == total_v - 1
        self.module = module
        self._stash: Dict[int, Any] = {}  # microbatch -> input (+targets)
        self.stash_hwm = 0
        self._dp_group = dp_group
        self.device = torch.device(device or "cpu")

        gen = torch.Generator(device=self.device).manual_seed(rng_seed)
        tree = module.init(gen)
        leaves, self._spec = pytree.tree_flatten(tree)
        self._leaves = [
            leaf.detach().to(self.device).clone().requires_grad_(True)
            for leaf in leaves
        ]
        self.params = pytree.tree_unflatten(self._leaves, self._spec)
        # optax.adamw(lr)'s defaults, spelled out: torch's AdamW decays by
        # 1e-2 unless told otherwise.
        self._opt = torch.optim.AdamW(
            self._leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=1e-4,
        )
        self._grad_acc = None

    # ------------------------------------------------------------ plumbing
    def _replica(self, device):
        """This chunk's parameter leaves for a DP rank on ``device``: the
        leaves themselves on the chunk's own device, else copies that
        take their own gradients."""
        if device == self.device:
            return self._leaves
        return [leaf.detach().to(device).requires_grad_(True)
                for leaf in self._leaves]

    def _ranks(self, *parts):
        """``(device, *shares)`` of each DP rank: its equal share of each
        part's batch axis, on its device (``None`` stays ``None``).
        Without DP, one rank holding the whole microbatch on the chunk's
        device."""
        import torch

        devices = (self._dp_group.devices if self._dp_group is not None
                   else [self.device])
        n = len(devices)
        split = []
        for part in parts:
            if part is None:
                split.append([None] * n)
                continue
            part = torch.as_tensor(part)
            if part.shape[0] % n:
                raise ValueError(
                    f"microbatch axis {part.shape[0]} cannot be split "
                    f"evenly over {n} DP ranks"
                )
            split.append(part.chunk(n))
        return [
            (dev, *(None if s is None else s.to(dev) for s in shares))
            for dev, *shares in zip(devices, *split)
        ]

    def _run(self, leaves, x, targets=None):
        from torch.utils import _pytree as pytree

        params = pytree.tree_unflatten(leaves, self._spec)
        if self.is_last:
            return self.module.apply(params, x, targets)
        return self.module.apply(params, x)

    # ----------------------------------------------------------- schedule
    def forward(self, mb: int, x, targets=None):
        import torch

        if self.is_last:
            self._stash[mb] = (x, targets)
        else:
            self._stash[mb] = x
        self.stash_hwm = max(self.stash_hwm, len(self._stash))
        with torch.no_grad():
            outs = [self._run(self._replica(dev), xr, tr).to(self.device)
                    for dev, xr, tr in self._ranks(x, targets)]
        if len(outs) == 1:
            return outs[0]
        if self.is_last:
            return sum(outs) / len(outs)  # equal shards: the full mean
        return torch.cat(outs)

    def backward(self, mb: int, gy=None):
        """Returns (loss_or_None, gx_or_None); accumulates param grads.

        Recomputes the forward under autograd from the stashed input.
        With DP each rank differentiates its shard (the loss scaled by
        ``1/dp``, so the ranks' sum is the full microbatch's mean) and the
        group's SUM allreduce combines the parameter gradients."""
        import torch

        if self.is_last:
            x, targets = self._stash.pop(mb)
        else:
            x, targets = self._stash.pop(mb), None
        ranks = self._ranks(x, targets, gy)
        dp = len(ranks)
        loss = None
        grads_by_rank, gx_parts = [], []
        for dev, xr, tr, gyr in ranks:
            leaves = self._replica(dev)
            if not self.is_first:
                xr = xr.detach().requires_grad_(True)
            wrt = leaves if self.is_first else leaves + [xr]
            with torch.enable_grad():
                out = self._run(leaves, xr, tr)
                if self.is_last:
                    out = out / dp
                    part = out.detach().to(self.device)
                    loss = part if loss is None else loss + part
                grads = torch.autograd.grad(
                    out, wrt,
                    grad_outputs=None if self.is_last else gyr.to(out.dtype),
                    allow_unused=True,
                )
            grads = [torch.zeros_like(w) if g is None else g
                     for g, w in zip(grads, wrt)]
            grads_by_rank.append(grads[:len(leaves)])
            if not self.is_first:
                gx_parts.append(grads[-1].to(self.device))
        if dp == 1:
            gp = grads_by_rank[0]
        else:
            gp = [
                self._dp_group.allreduce([g[i] for g in grads_by_rank])[0]
                .to(self.device)
                for i in range(len(self._leaves))
            ]
        gx = None
        if not self.is_first:
            gx = gx_parts[0] if dp == 1 else torch.cat(gx_parts)

        if self._grad_acc is None:
            self._grad_acc = [g.detach() for g in gp]
        else:
            self._grad_acc = [a + g for a, g in zip(self._grad_acc, gp)]
        return loss, gx

    def apply_grads(self, num_microbatches: int):
        if self._grad_acc is None:
            return
        for leaf, g in zip(self._leaves, self._grad_acc):
            leaf.grad = g / num_microbatches
        self._opt.step()
        self._opt.zero_grad(set_to_none=True)
        self._grad_acc = None

    def state(self):
        """Parameters and optimizer state as CPU tensors (bf16 has no
        numpy dtype): what the trainer's checkpoint pickles."""
        import torch
        from torch.utils import _pytree as pytree

        def host(x):
            return x.detach().cpu() if isinstance(x, torch.Tensor) else x

        return {
            "params": pytree.tree_map(host, self.params),
            "opt_state": pytree.tree_map(host, self._opt.state_dict()),
        }

    def load_state(self, state):
        import torch
        from torch.utils import _pytree as pytree

        with torch.no_grad():
            for leaf, src in zip(self._leaves,
                                 pytree.tree_leaves(state["params"])):
                leaf.copy_(src)
        self._opt.load_state_dict(state["opt_state"])
        self._grad_acc = None
        self._stash.clear()


# ------------------------------------------------------------- stage actor
def _stage_device():
    """Where a stage runs: the card its lease made visible, or the CPU when
    it leased none.  A stage that leased a card and sees no CUDA device
    raises; it never carries on on the CPU."""
    import torch

    visible = os.environ.get("CUDA_VISIBLE_DEVICES", "")
    if visible in ("", "-1"):
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"this stage leased a GPU (CUDA_VISIBLE_DEVICES={visible!r}) "
            "but sees no CUDA device"
        )
    torch.cuda.set_device(0)
    return torch.device("cuda", 0)


@ray_tpu_torch.remote
class PipelineStage:
    """One pipeline stage: owns ``interleave`` model chunks, executes its
    static 1F1B op list each step, streams activations/gradients to its
    neighbors over the zero-copy p2p channel, and applies its own
    optimizer after the last microbatch."""

    def __init__(self, stage_idx: int, cfg: PipelineConfig, run_id: str):
        from ray_tpu_torch.util.debug_locks import make_lock

        self.stage = stage_idx
        self.cfg = cfg
        self.run_id = run_id
        self.chunks: Dict[int, _Chunk] = {}  # chunk slot -> executor
        self.addresses: List[str] = []
        self.channel = None
        self.generation = -1
        self._schedule: List[PipeOp] = []
        self._op_trace: List[tuple] = []
        self._last_stats: Dict[str, Any] = {}
        # Zombie-step fencing: an abandoned run_step (its driver ref was
        # dropped after a peer died) keeps executing on another actor
        # lane.  reset() raises _abort and waits for _inflight to drain
        # before touching chunk state, so a superseded step can never
        # race load_state or feed on the recovered generation.
        self._inflight = 0
        self._abort = False
        self._inflight_lock = make_lock("pipeline-stage-inflight")
        # Fault-injection state (devtools.chaos): lives on the ACTOR, so
        # a remediation respawn-and-replace — a fresh actor in the
        # bundle — clears it, the way replacing a sick process clears
        # its sickness.  reset() deliberately does NOT clear it.
        self._chaos: Dict[str, Any] = {}

    # ------------------------------------------------------------- wiring
    def rpc_address(self) -> str:
        from ray_tpu_torch.collective.p2p import StageChannel

        return StageChannel.self_address()

    def build(self, module_builder_payload: bytes, lr: float,
              rng_seed: int) -> bool:
        """Instantiate this stage's model chunks (one per interleave
        slot); chunk slot c executes virtual stage ``c*S + stage``."""
        from ray_tpu_torch.core.serialization import loads_function

        builder = loads_function(module_builder_payload)
        cfg = self.cfg
        total_v = cfg.total_virtual_stages
        device = _stage_device()
        dp_group = self._make_dp_group(cfg.dp_devices_per_stage, device)
        for c in range(cfg.interleave):
            v = c * cfg.num_stages + self.stage
            self.chunks[c] = _Chunk(
                v, total_v, builder(v, total_v), rng_seed, lr,
                dp_group=dp_group, device=device,
            )
        self._schedule = build_1f1b_schedule(
            cfg.num_stages, cfg.num_microbatches, cfg.interleave
        )[self.stage]
        return True

    def _make_dp_group(self, dp: int, device):
        """``dp`` ranks of a ``LocalGroup``: one card each on the card (as
        many as the stage leased), ``dp`` CPU ranks on the CPU."""
        if dp <= 1:
            return None
        import torch

        from ray_tpu_torch.collective.local_group import LocalGroup

        if device.type == "cuda":
            visible = torch.cuda.device_count()
            if visible < dp:
                raise ValueError(
                    f"dp_devices_per_stage={dp} but only {visible} local "
                    "devices are visible to this stage"
                )
            devices = [f"cuda:{i}" for i in range(dp)]
        else:
            devices = [device] * dp
        return LocalGroup(f"pp:{self.run_id}:dp{self.stage}", devices=devices)

    def wire(self, addresses: List[str], generation: int) -> bool:
        """(Re)connect to the neighbor stages; bump the schedule
        generation so tensors from an aborted generation are ignored."""
        from ray_tpu_torch.collective.p2p import StageChannel

        self.addresses = list(addresses)
        self.generation = generation
        self.channel = StageChannel(
            f"pp:{self.run_id}:g{generation}",
            recv_timeout_s=self.cfg.recv_timeout_s,
        )
        return True

    def reset(self) -> int:
        """Quiesce any superseded in-flight step, then drop parked
        tensors of EVERY generation of this run and the aborted step's
        chunk state (restart path)."""
        from ray_tpu_torch.collective.p2p import local_mailbox

        # Fence first: zombie run_steps notice _abort within one recv
        # slice (~1s) or at their next op; only after the last one exits
        # is it safe to clear stashes / reload params.
        self._abort = True
        deadline = time.monotonic() + self.cfg.recv_timeout_s + 10.0
        while time.monotonic() < deadline:
            with self._inflight_lock:
                if self._inflight == 0:
                    break
            time.sleep(0.05)
        else:
            logger.warning(
                "stage %d reset: %d run_step(s) still in flight after "
                "quiesce deadline", self.stage, self._inflight,
            )
        self._abort = False
        dropped = local_mailbox().drop_prefix(f"pp:{self.run_id}:")
        if self.channel is not None:
            self.channel.reset()
        for chunk in self.chunks.values():
            chunk._stash.clear()
            chunk._grad_acc = None
        return dropped

    # -------------------------------------------------------------- state
    def get_state(self) -> bytes:
        return pickle.dumps(
            {c: chunk.state() for c, chunk in self.chunks.items()}
        )

    def load_state(self, blob: bytes) -> bool:
        states = pickle.loads(blob)
        for c, state in states.items():
            self.chunks[c].load_state(state)
        return True

    def prepare_evict(self) -> bytes:
        """Checkpoint-then-evict hook: the returned blob is parked in the
        cluster KV (namespace ``eviction``) by the worker runtime before
        this stage's bundle is reclaimed, so the preempted trainer's next
        incarnation resumes bit-identical (docs/scheduling.md)."""
        return self.get_state()

    def ping(self) -> bool:
        return True

    def inject_chaos(self, spec: Optional[Dict[str, Any]]) -> bool:
        """``devtools.chaos`` hook; ``None`` (or ``{}``) reverts.

        - ``{"compute_delay_s": s}`` — slow host: every forward op takes
          ``s`` longer, landing in this stage's fwd histogram while its
          PEERS accumulate the stall (the real slow-host signature: the
          straggler rule flags a waiting victim, and the trainer's
          actuator localizes the culprit by compute share — see
          ``PipelinedTrainer._remediation_actuator``).
        - ``{"recv_delay_s": s}`` — slow delivery: every neighbor-tensor
          receive stalls ``s`` extra on this stage."""
        self._chaos = dict(spec or {})
        return True

    # ---------------------------------------------------------- execution
    @staticmethod
    def _edge_fwd(channel, v: int) -> str:
        return channel.edge(f"f{v}", f"f{v + 1}")

    @staticmethod
    def _edge_bwd(channel, v: int) -> str:
        return channel.edge(f"b{v}", f"b{v - 1}")

    def _neighbor(self, stage: int) -> str:
        return self.addresses[stage % self.cfg.num_stages]

    def _recv(self, channel, edge: str, seq):
        """Blocking recv in ~1s slices so a superseded step (reset() in
        progress) bails out promptly instead of holding the quiesce."""
        delay = self._chaos.get("recv_delay_s")
        if delay:
            # Injected straggle (devtools.chaos): counted inside the
            # caller's stall window, exactly like a real slow neighbor.
            time.sleep(float(delay))
        deadline = time.monotonic() + self.cfg.recv_timeout_s
        while True:
            self._check_abort()
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(
                    f"stage {self.stage}: recv timed out on {edge!r} "
                    f"seq {seq!r}"
                )
            try:
                return channel.recv(edge, seq, timeout=min(1.0, remaining))
            except TimeoutError:
                continue

    def _check_abort(self):
        if self._abort:
            raise RuntimeError(
                f"stage {self.stage}: step superseded by reset()"
            )

    def run_step(self, step: int, inputs: Optional[List] = None,
                 targets: Optional[List] = None) -> Dict[str, Any]:
        """Execute this stage's 1F1B op list for one training step.

        ``inputs``: per-microbatch raw inputs (stage 0 only).
        ``targets``: per-microbatch targets (last stage only).
        Returns stats (+ per-microbatch losses on the last stage).
        """
        with self._inflight_lock:
            self._inflight += 1
        try:
            return self._run_step_fenced(step, inputs, targets)
        finally:
            with self._inflight_lock:
                self._inflight -= 1

    def _run_step_fenced(self, step, inputs, targets) -> Dict[str, Any]:
        from ray_tpu_torch.util import flight_recorder

        cfg = self.cfg
        S, M, V = cfg.num_stages, cfg.num_microbatches, cfg.interleave
        # Pin this step to its wiring generation: a concurrent recovery
        # swaps self.channel, but THIS step keeps sending/receiving only
        # on its own generation's edges (and aborts at the next fence).
        channel = self.channel
        self._maybe_debug_fail(step)
        t_step0 = time.perf_counter()
        fwd_s = bwd_s = stall_s = 0.0
        losses: Dict[int, float] = {}
        self._op_trace = []

        for op in self._schedule:
            self._check_abort()
            chunk = self.chunks[op.chunk]
            v = op.chunk * S + self.stage
            mb = op.microbatch
            seq = (step, mb)
            if op.kind == "F":
                if chunk.is_first:
                    x = inputs[mb]
                else:
                    t0 = time.perf_counter()
                    x = self._recv(channel, self._edge_fwd(channel, v - 1),
                                   seq)
                    stall_s += time.perf_counter() - t0
                t0 = time.perf_counter()
                y = chunk.forward(
                    mb, x, targets[mb] if chunk.is_last else None
                )
                self._block_until_ready(y)
                if self._chaos.get("compute_delay_s"):
                    # Injected slow host (devtools.chaos): lands in the
                    # forward histogram like real slow compute.
                    time.sleep(float(self._chaos["compute_delay_s"]))
                dt = time.perf_counter() - t0
                fwd_s += dt
                flight_recorder.record_pipeline_op("F", self.stage, dt)
                if not chunk.is_last:
                    channel.send(
                        self._edge_fwd(channel, v), seq, self._to_host(y),
                        self._neighbor(self.stage + 1),
                    )
            else:
                gy = None
                if not chunk.is_last:
                    t0 = time.perf_counter()
                    gy = self._recv(channel, self._edge_bwd(channel, v + 1),
                                    seq)
                    if cfg.quantized_grad_exchange:
                        gy = _dequantize_grad_tree(gy)
                    stall_s += time.perf_counter() - t0
                t0 = time.perf_counter()
                loss, gx = chunk.backward(mb, gy)
                if loss is not None:
                    losses[mb] = float(loss)
                if gx is not None:
                    self._block_until_ready(gx)
                dt = time.perf_counter() - t0
                bwd_s += dt
                flight_recorder.record_pipeline_op("B", self.stage, dt)
                if not chunk.is_first:
                    gx_wire = self._to_host(gx)
                    if cfg.quantized_grad_exchange:
                        # Opt-in EQuARX-style wire quantization of the
                        # gradient stream (the DCN-bound direction) —
                        # int8 blocks + scales, ~4x fewer bytes pushed.
                        gx_wire = _quantize_grad_tree(
                            gx_wire, cfg.quant_block_size
                        )
                    channel.send(
                        self._edge_bwd(channel, v), seq, gx_wire,
                        self._neighbor(self.stage - 1),
                    )
            self._op_trace.append((op.kind, op.chunk, mb))

        channel.flush()
        self._check_abort()
        for chunk in self.chunks.values():
            chunk.apply_grads(M)
        wall_s = time.perf_counter() - t_step0
        flight_recorder.record_pipeline_step(
            self.stage, stall_s, wall_s, M * V
        )
        stats = {
            "stage": self.stage,
            "step": step,
            "fwd_s": fwd_s,
            "bwd_s": bwd_s,
            "stall_s": stall_s,
            "wall_s": wall_s,
            "stash_hwm": max(
                (c.stash_hwm for c in self.chunks.values()), default=0
            ),
            "channel": channel.stats(),
            "op_trace": list(self._op_trace),
        }
        if losses:
            stats["losses"] = [losses[mb] for mb in sorted(losses)]
        self._last_stats = stats
        return stats

    @staticmethod
    def _block_until_ready(tree):
        """Wait for the streams that produce the tree's card tensors."""
        import torch
        from torch.utils import _pytree as pytree

        devices = {leaf.device for leaf in pytree.tree_leaves(tree)
                   if isinstance(leaf, torch.Tensor) and leaf.is_cuda}
        for device in devices:
            torch.cuda.current_stream(device).synchronize()

    @staticmethod
    def _to_host(tree):
        """Card tensors -> CPU tensors for the zero-copy send path (on
        the CPU this is copy-free; on the card it is the one D2H).  The
        core's serialization carries them, bf16 included, as raw bytes."""
        import torch
        from torch.utils import _pytree as pytree

        return pytree.tree_map(
            lambda x: x.detach().cpu() if isinstance(x, torch.Tensor) else x,
            tree,
        )

    def _maybe_debug_fail(self, step: int) -> None:
        hook = self.cfg.debug_fail
        if not hook or hook.get("stage") != self.stage:
            return
        if step != hook.get("step"):
            return
        marker = hook.get("marker", "")
        if marker and os.path.exists(marker):
            return  # already died once; restarted actor runs through
        if marker:
            with open(marker, "w") as f:
                f.write("died")
        logger.warning("debug_fail: stage %d exiting at step %d",
                       self.stage, step)
        os._exit(1)


# ---------------------------------------------------------------- trainer
class PipelinedTrainer:
    """JaxTrainer-style driver for pipeline-parallel training.

    ``module_builder(virtual_idx, total_virtual) -> StageModule`` defines
    the model partition; ``data_per_step(step) -> (inputs, targets)``
    feeds each step, where both are arrays whose leading (batch) axis is
    split into ``num_microbatches`` equal microbatches.
    """

    def __init__(
        self,
        module_builder: Callable[[int, int], StageModule],
        *,
        pipeline_config: Optional[PipelineConfig] = None,
        data_per_step: Callable[[int], tuple] = None,
        num_steps: int = 1,
        learning_rate: float = 1e-3,
        rng_seed: int = 0,
        run_config: Optional[RunConfig] = None,
        resources_per_stage: Optional[Dict[str, float]] = None,
    ):
        self.module_builder = module_builder
        self.cfg = pipeline_config or PipelineConfig()
        self.data_per_step = data_per_step
        self.num_steps = num_steps
        self.learning_rate = learning_rate
        self.rng_seed = rng_seed
        self.run_config = run_config or RunConfig()
        self.resources_per_stage = resources_per_stage or {"CPU": 1.0}
        self._pg = None
        self.stages: List[Any] = []
        self._generation = 0
        self._restarts = 0
        # Last synchronized checkpoint: (step_to_resume_from, [blob/stage]).
        self._ckpt: Optional[tuple] = None
        # SLO-remediation hook: a stage index flagged (from any thread)
        # for respawn-and-replace; fit() honors it between steps via the
        # same generation-fenced recovery path stage DEATH takes.
        self._respawn_request: Optional[int] = None
        self._last_step_stats: List[Dict[str, Any]] = []

    # ------------------------------------------------------------ topology
    def _create_stages(self):
        from ray_tpu_torch.core.placement import pipeline_stage_placement_group

        run_id = f"{os.getpid()}_{id(self):x}"
        self._run_id = getattr(self, "_run_id", run_id)
        if self._pg is None:
            self._pg = pipeline_stage_placement_group(
                self.cfg.num_stages, self.resources_per_stage
            )
            self._pg.ready(timeout=120)
        self.stages = [
            self._spawn_stage(i) for i in range(self.cfg.num_stages)
        ]
        self._build_and_wire(range(self.cfg.num_stages))

    def _spawn_stage(self, i: int):
        from ray_tpu_torch.core.placement import placement_group_strategy

        return PipelineStage.options(
            num_cpus=self.resources_per_stage.get("CPU", 1),
            num_gpus=self.resources_per_stage.get("GPU", 0) or None,
            scheduling_strategy=placement_group_strategy(self._pg, i),
            max_concurrency=4,
        ).remote(i, self.cfg, self._run_id)

    def _build_and_wire(self, build_indices):
        payload = dumps_function(self.module_builder)
        timeout = max(120.0, self.cfg.recv_timeout_s)
        ray_tpu_torch.get(
            [
                self.stages[i].build.remote(
                    payload, self.learning_rate, self.rng_seed
                )
                for i in build_indices
            ],
            timeout=timeout,
        )
        addresses = ray_tpu_torch.get(
            [s.rpc_address.remote() for s in self.stages], timeout=timeout
        )
        ray_tpu_torch.get(
            [
                s.wire.remote(addresses, self._generation)
                for s in self.stages
            ],
            timeout=timeout,
        )

    # ---------------------------------------------------------- checkpoint
    def _save_checkpoint(self, next_step: int):
        blobs = ray_tpu_torch.get(
            [s.get_state.remote() for s in self.stages],
            timeout=max(120.0, self.cfg.recv_timeout_s),
        )
        self._ckpt = (next_step, blobs)
        run_dir = self._ckpt_dir()
        if run_dir:
            d = os.path.join(run_dir, f"pipeline_ckpt_{next_step:08d}")
            os.makedirs(d, exist_ok=True)
            for i, blob in enumerate(blobs):
                with open(os.path.join(d, f"stage_{i}.pkl"), "wb") as f:
                    f.write(blob)

    def _ckpt_dir(self) -> str:
        path = self.run_config.storage_path
        if not path:
            return ""
        d = os.path.join(path, self.run_config.name or "pipeline_run")
        os.makedirs(d, exist_ok=True)
        return d

    def _restore_checkpoint(self):
        step, blobs = self._ckpt
        ray_tpu_torch.get(
            [
                s.load_state.remote(blobs[i])
                for i, s in enumerate(self.stages)
            ],
            timeout=max(120.0, self.cfg.recv_timeout_s),
        )
        return step

    # ------------------------------------------------------------ recovery
    def _recover(self) -> int:
        """Restart dead stages into their bundles, reset survivors, reload
        the last synchronized checkpoint everywhere, bump the channel
        generation.  Returns the step to resume from."""
        from ray_tpu_torch.util import flight_recorder

        self._restarts += 1
        dead = []
        for i, s in enumerate(self.stages):
            try:
                ray_tpu_torch.get(s.ping.remote(), timeout=10)
            except Exception:  # noqa: BLE001 — dead or wedged: replace
                dead.append(i)
        logger.warning(
            "pipeline recovery #%d: restarting stages %s from checkpoint "
            "step %s", self._restarts, dead, self._ckpt and self._ckpt[0],
        )
        for i in dead:
            try:
                ray_tpu_torch.kill(self.stages[i])
            except Exception:  # raylint: waive[RTL003] already-dead actor kill is best-effort
                pass
            self.stages[i] = self._spawn_stage(i)
            flight_recorder.record_pipeline_restart(i)
        self._generation += 1
        # Survivors drop parked tensors before (re)wiring; new actors
        # need build() first.
        alive = [i for i in range(len(self.stages)) if i not in dead]
        ray_tpu_torch.get(
            [self.stages[i].reset.remote() for i in alive],
            timeout=max(120.0, self.cfg.recv_timeout_s),
        )
        self._build_and_wire(dead)  # build() on replacements; wire() on all
        return self._restore_checkpoint()

    # ------------------------------------------------------- remediation
    def request_stage_respawn(self, stage_idx: int,
                              reason: str = "") -> bool:
        """Flag ``stage_idx`` for respawn-and-replace (a fresh actor in
        its bundle, every stage rolled back to the last synchronized
        checkpoint, generation fence bumped).  Callable from any thread
        — the remediation controller's straggler actuator; fit() applies
        it between steps."""
        if not 0 <= stage_idx < self.cfg.num_stages:
            return False
        logger.warning(
            "stage %d flagged for remediation respawn%s", stage_idx,
            f" ({reason})" if reason else "",
        )
        self._respawn_request = stage_idx
        return True

    def _remediation_actuator(self, target: str, violation, **_kw) -> str:
        """``pipeline_stage_respawn`` actuator (registered while fit()
        runs): target is the SLO subject's ``stage=N``.

        The straggler rule flags the stage with the high STALL — in a
        barrier-synced pipeline that is the victim waiting on a slow
        peer, not necessarily the culprit.  Before acting, localize the
        culprit from the last step's per-stage compute times (fwd+bwd,
        the signal the stall correlates against): respawn the stage
        doing outsized compute if one stands out, else the flagged
        stage itself."""
        from ray_tpu_torch.util.remediation import RemediationSkipped, subject_tags

        stage = subject_tags(target).get("stage")
        if stage is None or not stage.isdigit():
            raise RemediationSkipped(f"unparseable stage target {target!r}")
        victim = int(stage)
        culprit, note = victim, ""
        stats = self._last_step_stats
        if stats and len(stats) == self.cfg.num_stages:
            compute = [s.get("fwd_s", 0.0) + s.get("bwd_s", 0.0)
                       for s in stats]
            peak = max(range(len(compute)), key=compute.__getitem__)
            peers = [c for i, c in enumerate(compute) if i != peak]
            if peers and compute[peak] > 2.0 * max(
                sum(peers) / len(peers), 1e-6
            ):
                culprit = peak
                if culprit != victim:
                    note = (f" (victim stage {victim}; culprit by compute "
                            f"share: {compute[peak]:.3f}s vs peer mean "
                            f"{sum(peers) / len(peers):.3f}s)")
        if not self.request_stage_respawn(
            culprit, reason=getattr(violation, "detail", "") or "slo"
        ):
            raise RemediationSkipped(f"no such stage {culprit}")
        return (f"stage {culprit} respawn requested (applied between "
                f"steps){note}")

    def _apply_pending_respawn(self) -> Optional[int]:
        """Honor a flagged respawn: kill the target stage, then run the
        normal generation-fenced recovery.  Returns the resume step, or
        None when nothing was pending."""
        pending, self._respawn_request = self._respawn_request, None
        if pending is None or not 0 <= pending < len(self.stages):
            return None
        logger.warning("remediation respawn: replacing stage %d", pending)
        try:
            ray_tpu_torch.kill(self.stages[pending])
        except Exception:  # raylint: waive[RTL003] already-dead target kill is best-effort
            pass
        return self._recover()

    # ----------------------------------------------------------------- fit
    def fit(self) -> Result:
        from ray_tpu_torch.core.usage import record_library_usage
        from ray_tpu_torch.util import remediation

        record_library_usage("train.pipeline")
        cfg = self.cfg
        failure_cfg: FailureConfig = self.run_config.failure_config
        self._create_stages()
        self._save_checkpoint(0)  # synchronized step-0 baseline
        step_timeout = cfg.step_timeout_s or (cfg.recv_timeout_s * 3 + 60)
        metrics_history: List[Dict[str, Any]] = []
        attempts = 0
        step = 0
        actuator = remediation.register_actuator(
            "pipeline_stage_respawn", self._remediation_actuator
        )
        try:
            return self._fit_loop(
                cfg, failure_cfg, step_timeout, metrics_history,
                attempts, step,
            )
        finally:
            remediation.unregister_actuator(actuator)

    def _fit_loop(self, cfg, failure_cfg, step_timeout, metrics_history,
                  attempts, step) -> Result:
        def failed(e) -> Result:
            return Result(
                metrics=metrics_history[-1] if metrics_history else {},
                checkpoint=None,
                path=self._ckpt_dir(),
                error=e,
                metrics_history=metrics_history,
            )

        err = [None]

        def recover_bounded():
            """Bounded recovery: each attempt — including recoveries
            interrupted by ANOTHER death (chaos soak: kills landing
            mid-rebuild) — spends a failure attempt, so a kill loop
            exhausts the budget instead of escaping the fence.  Returns
            the resume step, or None when the budget is spent (the
            caller returns the failed Result)."""
            nonlocal attempts
            while True:
                attempts += 1
                if attempts > max(0, failure_cfg.max_failures):
                    return None
                try:
                    return self._recover()
                except Exception as e2:  # noqa: BLE001 — death mid-recovery
                    err[0] = e2

        def rolled_back(new_step: int) -> int:
            # The rolled-back steps will be re-run: drop their history
            # entries so consumers never see duplicate step numbers.
            metrics_history[:] = [
                m for m in metrics_history if m["step"] < new_step
            ]
            return new_step

        final_ckpt_done = False
        while step < self.num_steps or not final_ckpt_done:
            if step >= self.num_steps:
                # Training done: the FINAL synchronized checkpoint is
                # inside the fence too — a stage dying under it rolls
                # back and re-runs the tail instead of escaping fit()
                # as a raw exception.
                try:
                    self._save_checkpoint(self.num_steps)
                    final_ckpt_done = True
                    continue
                except Exception as e:  # noqa: BLE001 — death racing the final checkpoint
                    err[0] = e
                    new_step = recover_bounded()
                    if new_step is None:
                        return failed(err[0])
                    step = rolled_back(new_step)
                    if step >= self.num_steps:
                        continue  # checkpoint was current: retry it
            try:
                respawn_step = self._apply_pending_respawn()
            except Exception as e:  # noqa: BLE001 — death racing the respawn
                err[0] = e
                respawn_step = recover_bounded()
                if respawn_step is None:
                    return failed(err[0])
            if respawn_step is not None:
                step = rolled_back(respawn_step)
            # Outside the failure fence: a bad batch shape is a config
            # error and must RAISE, not be "recovered".
            inputs, targets = self._microbatches(step)
            t_step = time.perf_counter()
            try:
                # One span per step: every stage's run_step (and, through
                # the p2p trace propagation, every pipeline_push edge
                # between stages) stitches into a single cluster trace.
                from ray_tpu_torch.util import tracing

                with tracing.start_span(
                    "pipeline.step",
                    {"step": step, "num_stages": cfg.num_stages},
                ):
                    refs = []
                    for i, s in enumerate(self.stages):
                        kw = {}
                        if i == 0:
                            kw["inputs"] = inputs
                        if i == cfg.num_stages - 1:
                            kw["targets"] = targets
                        refs.append(s.run_step.remote(step, **kw))
                    stats = ray_tpu_torch.get(refs, timeout=step_timeout)
            except Exception as e:  # noqa: BLE001 — stage death/step loss
                err[0] = e
                new_step = recover_bounded()
                if new_step is None:
                    return failed(err[0])
                step = rolled_back(new_step)
                continue
            losses = stats[-1].get("losses") or []
            loss = sum(losses) / len(losses) if losses else float("nan")
            self._last_step_stats = stats
            bubble = self._record_step_metrics(stats)
            metrics_history.append({
                "step": step,
                "loss": loss,
                "bubble_fraction": bubble,
                "step_wall_s": time.perf_counter() - t_step,
                "restarts": self._restarts,
            })
            step += 1
            if (
                cfg.checkpoint_every_n_steps
                and step % cfg.checkpoint_every_n_steps == 0
            ):
                try:
                    self._save_checkpoint(step)
                except Exception as e:  # noqa: BLE001 — death racing the checkpoint
                    err[0] = e
                    new_step = recover_bounded()
                    if new_step is None:
                        return failed(err[0])
                    step = rolled_back(new_step)
        return Result(
            metrics=metrics_history[-1] if metrics_history else {},
            checkpoint=None,
            path=self._ckpt_dir(),
            error=None,
            metrics_history=metrics_history,
        )

    def _microbatches(self, step: int):
        import numpy as np

        inputs, targets = self.data_per_step(step)
        M = self.cfg.num_microbatches
        n = inputs.shape[0]
        if n % M:
            raise ValueError(
                f"batch axis {n} must be divisible by "
                f"num_microbatches={M}"
            )
        return (
            list(np.split(np.asarray(inputs), M)),
            list(np.split(np.asarray(targets), M)),
        )

    def _record_step_metrics(self, stats: List[Dict[str, Any]]) -> float:
        from ray_tpu_torch.util import flight_recorder

        total_stall = sum(s["stall_s"] for s in stats)
        total_wall = sum(s["wall_s"] for s in stats)
        bubble = total_stall / total_wall if total_wall > 0 else 0.0
        flight_recorder.record_pipeline_bubble(bubble, per_stage={
            s["stage"]: (s["stall_s"] / s["wall_s"] if s["wall_s"] else 0.0)
            for s in stats
        })
        return bubble

    def shutdown(self):
        for s in self.stages:
            try:
                ray_tpu_torch.kill(s)
            except Exception:  # raylint: waive[RTL003] teardown kill is best-effort
                pass
        self.stages = []
        if self._pg is not None:
            from ray_tpu_torch.core.placement import remove_placement_group

            try:
                remove_placement_group(self._pg)
            except Exception:  # raylint: waive[RTL003] teardown remove is best-effort
                pass
            self._pg = None

    def get_stage_states(self) -> List[dict]:
        """Materialized chunk states per stage (tests/inspection)."""
        blobs = ray_tpu_torch.get(
            [s.get_state.remote() for s in self.stages],
            timeout=max(120.0, self.cfg.recv_timeout_s),
        )
        return [pickle.loads(b) for b in blobs]


# --------------------------------------------------------------- reference
def reference_run(
    module_builder: Callable[[int, int], StageModule],
    total_virtual: int,
    data_per_step: Callable[[int], tuple],
    num_steps: int,
    *,
    num_microbatches: int = 1,
    learning_rate: float = 1e-3,
    rng_seed: int = 0,
    device=None,
):
    """Sequential (non-pipelined) execution of the SAME chunked model
    with the SAME microbatch gradient accumulation — the 1-stage
    self-baseline for loss-parity checks and bench `vs` ratios — on
    ``device`` (the card unless it says "cpu").

    Returns (per-step mean losses, final [chunk state dicts]); per-step
    wall times are exposed on the returned list as ``.step_walls`` via
    :class:`_LossList` (the bench's steady-state timing hook).
    """
    import numpy as np

    from ray_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    chunks = [
        _Chunk(v, total_virtual, module_builder(v, total_virtual),
               rng_seed, learning_rate, device=dev)
        for v in range(total_virtual)
    ]
    losses_per_step = _LossList()
    for step in range(num_steps):
        t_step = time.perf_counter()
        inputs, targets = data_per_step(step)
        mb_inputs = np.split(np.asarray(inputs), num_microbatches)
        mb_targets = np.split(np.asarray(targets), num_microbatches)
        mb_losses = []
        for mb in range(num_microbatches):
            x = mb_inputs[mb]
            for chunk in chunks:
                y = chunk.forward(
                    mb, x, mb_targets[mb] if chunk.is_last else None
                )
                x = y
            gy = None
            for chunk in reversed(chunks):
                loss, gy = chunk.backward(mb, gy)
                if loss is not None:
                    mb_losses.append(float(loss))
        for chunk in chunks:
            chunk.apply_grads(num_microbatches)
        losses_per_step.append(sum(mb_losses) / len(mb_losses))
        losses_per_step.step_walls.append(time.perf_counter() - t_step)
    return losses_per_step, [c.state() for c in chunks]


class _LossList(list):
    """Per-step losses with per-step wall times riding along."""

    def __init__(self, *args):
        super().__init__(*args)
        self.step_walls: List[float] = []

"""``chip_smoke.py``'s phase 14 across cards: one NCCL process a card.

Phase 14 runs on one card, where a mesh is a world of one (NCCL refuses
two ranks on one card) and the ring's four ranks share ``cuda:0``
single-controller.  This runs the same two functions, with the same gates,
as a world of one process a card (``parallel.launch.run_world``):

  (a) ``seq_parallel_attention`` over a ``seq=n`` mesh at 14a's shape
      (B=4, global S=4096, H=12, D=64, bf16, causal): each rank's ring and
      Ulysses against the whole-sequence kernels on its own card;
  (b) ``sharded_train`` with GPT-2 small (``attention="ring"``, no remat)
      on a (fsdp=n/2, seq=2) mesh: in bf16 at 14b's B=32 x S=1024, and in
      f32 at B=8 (the unsharded f32 step at B=32 does not fit one card
      without remat).  The f32 run is the witness for the bf16 loss gate:
      there the sharded and unsharded steps differ only in the order of
      their reductions, at f32 rounding, so it is held at phase 14b's
      2e-3.  In bf16 the first step's gradients are held leaf by leaf
      (``SHARDED_GRAD_TOL``) and the losses at ``LOSS_TOL["bfloat16"]``;
  (c) phase 18's north-star #4 loop (``chip_smoke.northstar4_phase``) at
      GPT-2-medium's width (bf16, flash, remat, B=8 x S=1024, 2 + 5
      steps) in a ``TorchTrainer`` of one worker a card, each leasing its
      card (NCCL), each reading its own dataset shard, the parameters and
      AdamW state sharded over a (data=2, fsdp=n/2) mesh of the workers:
      every step's loss within ``LOSS_TOL["bfloat16"]`` of the same global
      batches' steps run unsharded on one card in this process, 48/24/24
      flash launches a step in every worker.

Prints one JSON line per part and the card's name and power limit.

    python3 tools/parallel_cards.py        # (a), (b) and (c); 2+ cards
    python3 tools/parallel_cards.py c      # (c) alone; an even count
"""

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

# |sharded - unsharded| loss, every step.  f32 is 14b's gate; bf16 is
# wider because the 4-card mesh sums bf16 gradients in another order and
# AdamW's first steps move each weight by about one bf16 ulp, so the two
# runs part a little more every step (see PERF.md).
LOSS_TOL = {"bfloat16": 2e-2, "float32": 2e-3}
TRAIN = {"bfloat16": 32, "float32": 8}  # B at S=1024


def rank_main(device, attn_shape, reps, cfg_kwargs, seq, batches, steps):
    """One rank: 14a over a seq mesh of the world, then 14b in each dtype
    of ``batches`` ({dtype: B}) on (fsdp=n/2, seq=2)."""
    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    from ray_tpu_torch.models import GPT2Config
    from ray_tpu_torch.parallel import MeshConfig, build_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    n = dist.get_world_size()
    out = {"rank": dist.get_rank(),
           "attention": cs.seq_parallel_attention(
               shape=attn_shape, reps=reps, device=device,
               mesh=build_mesh(MeshConfig(seq=n)))}
    for dtype, batch in batches.items():
        cfg = GPT2Config(**{**cfg_kwargs, "dtype": dtype})
        out[dtype] = cs.sharded_train(
            cfg, batch, seq, steps, device=device,
            mesh_cfg=MeshConfig(fsdp=n // 2, seq=2),
            loss_tol=LOSS_TOL[dtype])
    return out


def northstar4_cards(n, device="cuda", cfg=None, shape=None):
    """(c): phase 18 over ``n`` workers, one a card, on a (data=2,
    fsdp=n/2) mesh, its losses held at ``LOSS_TOL`` of its dtype against
    the unsharded steps on one card here.  ``cfg`` (GPT2Config keywords)
    and ``shape`` shrink it for a rehearsal on the CPU (gloo workers
    leasing no card)."""
    import chip_smoke as cs
    from ray_tpu_torch.models import GPT2Config
    from ray_tpu_torch.parallel import MeshConfig

    cfg = (GPT2Config(**cfg) if cfg is not None else GPT2Config.medium(
        dtype="bfloat16", attention="flash", remat=True))
    return cs.northstar4_phase(
        device=device, cfg=cfg, shape=shape or cs.NS4_SHAPE, workers=n,
        mesh_cfg=MeshConfig(data=2, fsdp=n // 2),
        loss_tol=LOSS_TOL[cfg.dtype])


def ab(n) -> None:
    """(a) and (b): one world of ``n`` NCCL processes, one a card."""
    import chip_smoke as cs
    from ray_tpu_torch.parallel.launch import run_world

    cfg = dict(vocab_size=50304, max_seq=1024, n_layer=12, n_head=12,
               d_model=768, attention="ring")
    ranks = run_world("parallel_cards:rank_main", n, paths=[HERE],
                      backend="nccl", timeout=900,
                      args=("cuda", cs.SP_SHAPE, cs.SP_REPS, cfg, 1024,
                            TRAIN, cs.SHARDED_STEPS))
    att = ranks[0]["attention"]
    att["launches_by_rank"] = {
        name: [r["attention"][name]["launches"] for r in ranks]
        for name in ("ring", "ulysses")}
    print("attention " + json.dumps(att), flush=True)
    for dtype in TRAIN:
        train = ranks[0][dtype]
        train["launches_per_step_by_rank"] = [
            r[dtype]["sharded"]["launches_per_step"] for r in ranks]
        print(f"train_{dtype} " + json.dumps(train), flush=True)


def main(parts="abc") -> int:
    import torch

    import chip_smoke as cs
    from ray_tpu_torch.ops import _build

    n = torch.cuda.device_count()
    if n < 2 or ("c" in parts and n % 2):
        print("parallel_cards: needs 2 or more cards, an even count for "
              "(c)", file=sys.stderr)
        return 1
    _build.build()  # once, before the ranks load the libraries
    t0 = time.perf_counter()
    print(f"card: {cs.card_line()} x {n}", flush=True)
    if "a" in parts or "b" in parts:
        ab(n)
    if "c" in parts:
        ns4 = northstar4_cards(n)
        cs.report_northstar4_phase(f"{cs.card_line()} x {n}", ns4)
    print(f"parallel_cards: {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))

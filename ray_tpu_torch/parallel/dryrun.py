"""Entry points: a one-card forward step, and the multi-device dry
run — port of the JAX package's ``__graft_entry__.py``.

``entry()`` returns a GPT-2 small forward step with example args for one
card.  ``dryrun_multichip(n)`` starts a world of ``n`` processes
(``parallel.launch``: one NCCL process a card, as the JAX dry run takes
the chips, or gloo processes when the caller asks for the CPU), builds an
n-rank mesh with real DP/FSDP/TP/SP axes, runs the FULL training step
(loss + grad + AdamW update) with ring attention over the seq axis once
on tiny shapes, then the scaling curve, the SP parity and a 2-slice loss.

    python -m ray_tpu_torch.parallel.dryrun [--device cpu]  # N_DEVICES=8
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import torch


def entry():
    """-> (fn, example_args): GPT-2 small forward, bf16, on the card."""
    from ..device import resolve_device
    from ..models import GPT2Config, gpt2_apply, gpt2_init

    device = resolve_device(None)
    cfg = GPT2Config.small(dtype="bfloat16")  # 124M params
    params = gpt2_init(torch.Generator(device=device).manual_seed(0), cfg,
                       device=device)
    tokens = torch.zeros((2, 512), dtype=torch.int64, device=device)

    def fn(params, tokens):
        return gpt2_apply(params, tokens, cfg)

    return fn, (params, tokens)


def mesh_config_for(n_devices: int):
    """Tensor parallel ×2 and sequence parallel ×2 when divisible; fsdp
    absorbs the rest; a data axis on top for ≥16."""
    from .mesh import MeshConfig

    model = 2 if n_devices % 2 == 0 else 1
    seq = 2 if n_devices % (model * 2) == 0 else 1
    rest = n_devices // (model * seq)
    data = 2 if rest % 2 == 0 and rest >= 4 else 1
    fsdp = rest // data
    return MeshConfig(data=data, fsdp=fsdp, seq=seq, model=model)


# Leaves whose value after the step ``dryrun_multichip`` reports.
UPDATED_LEAVES = ("wte", "blocks.wqkv", "blocks.wo2", "lnf_g")


def _tiny_cfg(attention: str, device):
    """The JAX dry run's tiny GPT-2 (4 heads of 16).  On the cards the ring
    runs the flash kernels, which take head dims of 64 or 128, so there
    the heads are 64 wide (d_model 256)."""
    from ..models import GPT2Config

    return GPT2Config(vocab_size=256, max_seq=64, n_layer=2, n_head=4,
                      d_model=64 if device.type == "cpu" else 256,
                      dtype="float32", attention=attention)


def _params(cfg, params_np, device):
    from ..convert import params_from_jax
    from ..models import gpt2_init

    if params_np is not None:
        return params_from_jax(params_np, cfg, device=device)
    return gpt2_init(torch.Generator(device).manual_seed(0), cfg,
                     device=device)


def _full(x):
    from torch.distributed.tensor import DTensor

    x = x.detach()
    return (x.full_tensor() if isinstance(x, DTensor) else x).cpu().numpy()


def _dryrun_rank(n_devices: int, params_np: Optional[Dict]) -> Dict:
    """One rank: the sharded train step, then the 2-slice loss."""
    from ..models import gpt2_loss, gpt2_param_axes
    from .launch import rank_device
    from .mesh import MeshConfig, build_mesh
    from .multislice import (
        MultiSliceConfig, build_multislice_mesh, default_rules_for_mesh,
    )
    from .scaling_bench import _optimizer
    from .sharding import shard_pytree

    device = rank_device()
    cfg_mesh = mesh_config_for(n_devices)
    mesh = build_mesh(cfg_mesh)
    attention = "ring" if cfg_mesh.seq > 1 else "dense"
    cfg = _tiny_cfg(attention, device)
    params = shard_pytree(_params(cfg, params_np, device), gpt2_param_axes(),
                          mesh)
    params.requires_grad_(True)
    opt = _optimizer(params)
    batch = max(2, cfg_mesh.data * cfg_mesh.fsdp)
    seq_len = 32  # +1 target shift below
    tokens = torch.zeros((batch, seq_len + 1), dtype=torch.int64,
                         device=device)
    loss = gpt2_loss(params, tokens, cfg, mesh)
    loss.backward()
    opt.step()
    leaves = dict(params.named_parameters())
    out = {"mesh": cfg_mesh.shape, "attention": attention,
           "loss": float(loss),
           "updated": {k: _full(leaves[k]) for k in UPDATED_LEAVES}}
    if n_devices >= 4 and n_devices % 2 == 0:
        # Multi-slice composition: 2 slices x per-slice mesh, dense.
        per = MeshConfig(fsdp=n_devices // 2)
        ms_mesh = build_multislice_mesh(MultiSliceConfig(2, per))
        ms_cfg = _tiny_cfg("dense", device)
        ms_params = shard_pytree(_params(ms_cfg, params_np, device),
                                 gpt2_param_axes(), ms_mesh,
                                 default_rules_for_mesh(ms_mesh))
        ms_tokens = torch.zeros((n_devices, seq_len + 1), dtype=torch.int64,
                                device=device)
        with torch.no_grad():
            out["multislice_loss"] = float(
                gpt2_loss(ms_params, ms_tokens, ms_cfg, ms_mesh))
        out["multislice_axes"] = ms_mesh.mesh_dim_names
        out["multislice_shape"] = per.shape
    return out


def dryrun_multichip(n_devices: int, params: Optional[Dict] = None,
                     scaling: bool = True, device=None) -> Dict:
    """Run the full sharded training step over an n-rank mesh once on tiny
    shapes, then (``scaling``) the curve and the SP parity: on ``n``
    cards, one process each, unless ``device`` is the CPU (raises when
    fewer cards are present, as the JAX dry run does for chips).
    ``params``: a JAX-layout tree of numpy leaves for the device's tiny
    config (default: the port's seeded init).  Prints what the JAX dry
    run prints and returns it as a dict, with the values of
    ``UPDATED_LEAVES`` after the step under ``"updated"``."""
    from .launch import backend_for, run_world
    from .scaling_bench import WORLD_TIMEOUT_S

    backend = backend_for(device, n_devices)
    rep = run_world("ray_tpu_torch.parallel.dryrun:_dryrun_rank", n_devices,
                    args=(n_devices, params), timeout=WORLD_TIMEOUT_S,
                    backend=backend)[0]
    print(f"dryrun_multichip({n_devices}): mesh={rep['mesh']} "
          f"attention={rep['attention']} loss={rep['loss']:.4f}")
    if scaling:
        from .scaling_bench import run_scaling_curve, run_sp_parity

        counts = [c for c in (1, 2, 4, 8, 16, 32) if c <= n_devices]
        curve = run_scaling_curve(counts, device=device)
        print("scaling_curve:", json.dumps(curve))
        if curve:
            print(f"gpt2_{curve[-1]['devices']}dev_partition_retention"
                  f"_weak_scaling:", curve[-1]["retention"])
        rep["scaling_curve"] = curve
        rep["sp_parity"] = run_sp_parity(seq_len=64, device=device)
        print("sp_parity:", json.dumps(rep["sp_parity"]))
    if "multislice_loss" in rep:
        print(f"multislice(2x{rep['multislice_shape']}): "
              f"axes={rep['multislice_axes']} "
              f"loss={rep['multislice_loss']:.4f}")
    return rep


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cpu for gloo processes (default: one process a "
                         "card)")
    dryrun_multichip(int(os.environ.get("N_DEVICES", "8")),
                     device=ap.parse_args(argv).device)


if __name__ == "__main__":
    main()

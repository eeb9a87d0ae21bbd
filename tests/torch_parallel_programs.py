"""The port's halves of the parallel parity tests, run as SPMD worlds.

``tests/test_torch_parallel.py``, ``test_torch_multislice.py`` and
``test_torch_models_sharded.py`` start one world of gloo processes per
module (``ray_tpu_torch.parallel.launch.run_world``) and call one suite
here; the JAX halves run in the test process, on its 8 virtual devices.
This module imports torch and the port only: a world's processes never
load JAX.  Every suite takes numpy inputs made by the test and returns
numpy results, the same on every rank (rank 0's are compared).
"""

from __future__ import annotations

import numpy as np
import torch


def _t(a, grad=False):
    t = torch.from_numpy(np.array(a))
    return t.requires_grad_(True) if grad else t


def _np(t):
    return t.detach().numpy()


def _mesh(**axes):
    from ray_tpu_torch.parallel import MeshConfig, build_mesh

    return build_mesh(MeshConfig(**axes))


def _attention_case(fn, qkv, cot, mesh, **kw):
    """Output of ``fn(q, k, v, mesh, **kw)`` and the gradients of
    ``sum(out * cot)`` with respect to q, k, v."""
    q, k, v = (_t(x, grad=True) for x in qkv)
    out = fn(q, k, v, mesh, **kw)
    (out * _t(cot)).sum().backward()
    return {"out": _np(out), "dq": _np(q.grad), "dk": _np(k.grad),
            "dv": _np(v.grad)}


def parallel_suite(inp):
    from ray_tpu_torch.parallel import (
        logical_sharding, pipelined, ring_attention, shard_pytree,
        ulysses_attention,
    )
    from ray_tpu_torch.parallel.mesh import axis_size

    res = {}
    mesh = _mesh(fsdp=4, model=2)
    res["mesh_sizes"] = {a: axis_size(mesh, a) for a in mesh.mesh_dim_names}

    fsdp8 = _mesh(fsdp=8)
    sharded = shard_pytree({"w": torch.ones(16, 4), "b": torch.ones(4)},
                           {"w": ("embed", None), "b": (None,)}, fsdp8)
    res["w_placements"] = [str(p) for p in sharded["w"].placements]
    res["w_local_shape"] = tuple(sharded["w"].to_local().shape)
    res["w_spec_placements"] = [
        str(p) for p in logical_sharding(fsdp8, ("embed", None))]

    seq8, dp_seq = _mesh(seq=8), _mesh(data=2, seq=4)
    cases = {"causal": (seq8, True), "noncausal": (seq8, False),
             "data_parallel": (dp_seq, True)}
    for name, (m, causal) in cases.items():
        for route in ("plain", "kernel"):
            res[f"ring_{name}_{route}"] = _attention_case(
                ring_attention, inp[f"ring_{name}"], inp[f"cot_{name}"], m,
                causal=causal, route=route)
    for name in ("ulysses", "ulysses_grad"):
        res[name] = _attention_case(ulysses_attention, inp[name],
                                    inp[f"cot_{name}"], dp_seq, causal=True)

    stage = _mesh(data=2, stage=4)
    apply = pipelined(lambda w, x: torch.tanh(x @ w), stage, batch_axes=None)
    res["pipeline"] = _np(apply(_t(inp["pipe_w"]), _t(inp["pipe_x"])))
    apply_dp = pipelined(lambda w, x: torch.tanh(x @ w), stage)
    res["pipeline_dp"] = _np(apply_dp(_t(inp["pipe_w"]), _t(inp["pipe_x"])))
    return res


def _family(name):
    from ray_tpu_torch import models as tm

    if name == "gpt2":
        return tm.GPT2Config, tm.gpt2_loss, tm.gpt2_apply, tm.gpt2_param_axes
    return tm.LlamaConfig, tm.llama_loss, tm.llama_apply, tm.llama_param_axes


def _leaf_grads(params):
    """Gradients of a sharded ParamTree, whole, as a JAX-layout tree."""
    out = {k: _np(v.grad.full_tensor())
           for k, v in params.named_parameters(recurse=False)}
    out["blocks"] = {k: _np(v.grad.full_tensor())
                     for k, v in params.blocks.items()}
    return out


def models_suite(inp):
    """Losses (and, for the ring, logits and every gradient leaf) of both
    families on the (fsdp=2, seq=2, model=2) mesh, JAX's weights; then, in
    the same world, ``vision_moe_suite`` under ``"vision"``."""
    from ray_tpu_torch.convert import params_from_jax
    from ray_tpu_torch.parallel import shard_pytree

    mesh = _mesh(fsdp=2, seq=2, model=2)
    res = {}
    for name in ("gpt2", "llama"):
        cfg_cls, loss_fn, apply_fn, axes = _family(name)
        for attention in ("ring", "ulysses"):
            cfg = cfg_cls(**inp[f"{name}_cfg"], attention=attention)
            params = shard_pytree(
                params_from_jax(inp[f"{name}_params"], cfg, device="cpu"),
                axes(), mesh).requires_grad_(True)
            tokens = _t(inp["tokens"])
            loss = loss_fn(params, tokens, cfg, mesh)
            res[f"{name}_{attention}_loss"] = float(loss)
            if attention == "ring":
                loss.backward()
                res[f"{name}_ring_grads"] = _leaf_grads(params)
                with torch.no_grad():
                    logits = apply_fn(params, tokens[:, :-1], cfg, mesh)
                res[f"{name}_ring_logits"] = _np(logits.full_tensor())
    res["vision"] = vision_moe_suite(inp["vision"])
    return res


def multislice_suite(inp):
    from ray_tpu_torch import models as tm
    from ray_tpu_torch.convert import params_from_jax
    from ray_tpu_torch.parallel import (
        MeshConfig, MultiSliceConfig, build_mesh, build_multislice_mesh,
        default_rules_for_mesh, group_devices_by_slice, shard_pytree,
    )
    from ray_tpu_torch.parallel.mesh import axis_size
    from ray_tpu_torch.parallel.scaling_bench import _optimizer

    res = {"groups": group_devices_by_slice(list(range(8)), 2)}
    mesh = build_multislice_mesh(
        MultiSliceConfig(2, MeshConfig(fsdp=2, model=2)))
    res["axes"] = mesh.mesh_dim_names
    res["sizes"] = {a: axis_size(mesh, a) for a in ("dcn", "fsdp", "model")}
    res["batch_rule"] = default_rules_for_mesh(
        build_multislice_mesh(MultiSliceConfig(2, MeshConfig(fsdp=4))))[
            "batch"]
    cfg = tm.GPT2Config(**inp["cfg"])

    def sharded(m):
        return shard_pytree(params_from_jax(inp["params"], cfg, device="cpu"),
                            tm.gpt2_param_axes(), m,
                            default_rules_for_mesh(m))

    with torch.no_grad():
        for key, m in (("single", build_mesh(MeshConfig(fsdp=8))),
                       ("multi", mesh)):
            res[f"{key}_loss"] = float(
                tm.gpt2_loss(sharded(m), _t(inp["tokens"]), cfg, m))
    params = sharded(mesh).requires_grad_(True)
    opt = _optimizer(params)
    losses = []
    for _ in range(2):
        loss = tm.gpt2_loss(params, torch.zeros((8, 33), dtype=torch.int64),
                            cfg, mesh)
        loss.backward()
        opt.step()
        opt.zero_grad()
        losses.append(float(loss))
    res["train_losses"] = losses
    return res


def _full_tree(tree):
    """A tree of DTensors and tensors as numpy, each leaf whole."""
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch.models.params import as_tree, map_tree

    return map_tree(lambda t: _np(t.full_tensor() if isinstance(t, DTensor)
                                  else t), as_tree(tree))


def vision_moe_suite(inp):
    """The vision models and the MoE LM under the JAX tests' meshes, JAX's
    weights: ResNet eval on data=8, ResNet train (loss, new_state, every
    gradient leaf) on data=2, ViT on (fsdp=4, model=2), MoE logits and aux
    on (data=2, expert=4).  The data=2 mesh holds ranks 0 and 1; the other
    ranks build it and return None for its results."""
    import torch.distributed as dist

    from ray_tpu_torch import models as tm
    from ray_tpu_torch.convert import params_from_jax, resnet_params_from_jax
    from ray_tpu_torch.parallel import MeshConfig, build_mesh, shard_pytree

    res = {}
    cfg = tm.ResNetConfig.tiny(dtype="float32")

    def resnet(mesh):
        params, state = resnet_params_from_jax(
            inp["resnet_params"], inp["resnet_state"], cfg, device="cpu")
        return shard_pytree(params, tm.resnet_param_axes(params), mesh), state

    mesh = _mesh(data=8)
    params, state = resnet(mesh)
    with torch.no_grad():
        out, _ = tm.resnet_apply(params, state, _t(inp["resnet_x8"]), cfg,
                                 mesh=mesh)
    res["resnet_data8_eval"] = _np(out.full_tensor())

    mesh2 = build_mesh(MeshConfig(data=2), devices=[0, 1])
    if dist.get_rank() < 2:
        params, state = resnet(mesh2)
        params.requires_grad_(True)
        loss, new_state = tm.resnet_loss(
            params, state, _t(inp["resnet_x4"]), _t(inp["resnet_y4"]), cfg,
            mesh=mesh2)
        loss.backward()
        res["resnet_data2_train"] = {
            "loss": float(loss), "new_state": _full_tree(new_state),
            "grads": _full_tree({n: p.grad for n, p in
                                 params.named_parameters()})}

    vcfg = tm.ViTConfig.tiny(dtype="float32")
    mesh = _mesh(fsdp=4, model=2)
    params = shard_pytree(params_from_jax(inp["vit_params"], vcfg,
                                          device="cpu"),
                          tm.vit_param_axes(), mesh)
    with torch.no_grad():
        res["vit_fsdp4_model2"] = _np(
            tm.vit_apply(params, _t(inp["vit_x"]), vcfg, mesh).full_tensor())

    mcfg = tm.MoEConfig.tiny(dtype="float32")
    mesh = _mesh(data=2, expert=4)
    params = shard_pytree(params_from_jax(inp["moe_params"], mcfg,
                                          device="cpu"),
                          tm.moe_param_axes(), mesh)
    with torch.no_grad():
        logits, aux = tm.moe_apply(params, _t(inp["moe_tokens"][:, :-1]),
                                   mcfg, mesh)
    params.requires_grad_(True)
    loss = tm.moe_loss(params, _t(inp["moe_tokens"]), mcfg, mesh)
    loss.backward()
    res["moe_data2_expert4"] = {
        "logits": _np(logits.full_tensor()), "aux": float(aux),
        "loss": float(loss),
        "grads": _full_tree({n: p.grad for n, p in
                             params.named_parameters()})}
    return res


def rank_and_world():
    import torch.distributed as dist

    return dist.get_rank(), dist.get_world_size()


def raise_on_rank_1():
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise ValueError("rank 1 refuses")
    dist.barrier()  # rank 0 waits on rank 1 here until the world is killed


def sleep_forever():
    import time

    while True:
        time.sleep(1)

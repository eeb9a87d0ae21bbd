"""GPT-2 weights made from a seed, on the device, in one draw.

The benchmark makes the weights, hands them to the program and, after the
window, makes the same ones again for the reference: the program is given
them and makes none.  The layout is the one the port takes (the JAX
tree's: ``wqkv [L, E, 3, H, D]``, ``wo [L, H, D, E]``, the unembedding tied
to ``wte``); the scales are GPT-2's (normal 0.02, the residual-out
projections 0.02/sqrt(2L), layer-norm gains 1, biases 0).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

SEED_MASK = (1 << 63) - 1


def gpt2_shapes(n_layer: int, n_head: int, d_model: int, vocab: int,
                n_ctx: int) -> Dict[str, Tuple[int, ...]]:
    e, h, L = d_model, n_head, n_layer
    d = e // h
    return {
        "wte": (vocab, e), "wpe": (n_ctx, e),
        "ln1_g": (L, e), "ln1_b": (L, e),
        "wqkv": (L, e, 3, h, d), "bqkv": (L, 3, h, d),
        "wo": (L, h, d, e), "bo": (L, e),
        "ln2_g": (L, e), "ln2_b": (L, e),
        "wi": (L, e, 4 * e), "bi": (L, 4 * e),
        "wo2": (L, 4 * e, e), "bo2": (L, e),
        "lnf_g": (e,), "lnf_b": (e,),
    }


BLOCK_LEAVES = ("ln1_g", "ln1_b", "wqkv", "bqkv", "wo", "bo", "ln2_g",
                "ln2_b", "wi", "bi", "wo2", "bo2")


def model_dims(config: dict) -> dict:
    """The sizes a run uses, from a configuration file: the published
    ones, the vocabulary padded as the configuration's ``assumed`` says."""
    return {"n_layer": config["n_layer"], "n_head": config["n_head"],
            "d_model": config["n_embd"],
            "vocab": config["assumed"]["padded_vocab_size"],
            "n_ctx": config["n_ctx"],
            "true_vocab": config["vocab_size"], "dtype": config["dtype"]}


def gpt2_weights(seed: int, dims: dict, device) -> Dict[str, torch.Tensor]:
    """Flat ``{name: tensor}`` of GPT-2 weights in the configuration's
    dtype: one normal draw of every element from a generator on
    ``device`` seeded with ``seed``, split into the leaves and scaled, the
    gains set to 1 and the biases to 0."""
    dtype = getattr(torch, dims["dtype"])
    shapes = gpt2_shapes(dims["n_layer"], dims["n_head"], dims["d_model"],
                         dims["vocab"], dims["n_ctx"])
    sizes = [torch.Size(s).numel() for s in shapes.values()]
    gen = torch.Generator(device=device).manual_seed(int(seed) & SEED_MASK)
    flat = torch.randn(sum(sizes), generator=gen, device=device,
                       dtype=dtype)
    out_scale = 0.02 / (2 * dims["n_layer"]) ** 0.5
    leaves = {}
    for (name, shape), part in zip(shapes.items(), flat.split(sizes)):
        leaf = part.view(shape)
        if name.endswith("_g"):
            leaf.fill_(1.0)
        elif name.startswith("b") or name.endswith("_b"):
            leaf.zero_()
        else:
            leaf.mul_(out_scale if name in ("wo", "wo2") else 0.02)
        leaves[name] = leaf
    return leaves


def as_port_tree(leaves: Dict[str, torch.Tensor]) -> dict:
    """The nested layout the port's ``ParamTree`` takes."""
    tree = {k: v for k, v in leaves.items() if k not in BLOCK_LEAVES}
    tree["blocks"] = {k: leaves[k] for k in BLOCK_LEAVES}
    return tree

"""Logical-axis sharding rules — port of ``ray_tpu/parallel/sharding.py``.

Models annotate tensors with *logical* axis names ("batch", "embed",
"heads", …); a rule table maps logical names to mesh axes.  Changing the
parallelism strategy = changing the table, not the model.

Logical axes are written as tuples of logical names, one entry per tensor
dim (the JAX package writes a ``PartitionSpec``; a tuple is a leaf of the
port's trees as a PartitionSpec is of JAX's):

    axes = {"wq": ("embed", "heads"), "bias": (None,)}

``logical_spec`` maps such a tuple to mesh axes entry by entry, as JAX's
does.  On a ``DeviceMesh`` the spec becomes DTensor placements, one per
mesh dim: a tensor dim whose entry names one or several mesh axes is
``Shard(dim)`` on each of them (in mesh order, the order JAX splits a
dim over a tuple of axes), and every other mesh dim is ``Replicate()``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

LogicalRules = Dict[str, Union[str, Tuple[str, ...], None]]

# The default recipe: batch splits over (data, fsdp); params shard their
# feature axes over fsdp (ZeRO-3) and their model-parallel axes over model;
# sequence splits over seq for context parallelism.
DEFAULT_RULES: LogicalRules = {
    "batch": ("data", "fsdp"),
    "seq": "seq",
    "embed": "fsdp",  # parameter axis (ZeRO-3 shard)
    "act_embed": None,  # activation feature axis (replicated across fsdp)
    "mlp": "model",
    "heads": "model",
    "kv": None,
    "vocab": "model",
    "stage": "stage",
    "norm": None,
    # MoE: the expert axis of per-expert params and of dispatched token
    # buffers shards over the expert mesh axis.
    "expert": "expert",
    "capacity": None,
    "expert_mlp": "model",
}


def logical_spec(logical_axes, rules: Optional[LogicalRules] = None):
    """Map a tuple of logical names to a tuple of mesh-axis entries (a
    name, a tuple of names, or None per tensor dim)."""
    rules = rules if rules is not None else DEFAULT_RULES
    return tuple(None if name is None else rules.get(name)
                 for name in tuple(logical_axes))


def placements_for(mesh, spec):
    """DTensor placements (one per mesh dim) of a mesh-axis spec as
    ``logical_spec`` returns it."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh.mesh_dim_names
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"axes {axes} of dim {dim} are not in mesh "
                             f"order {names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"mesh axis {names[i]!r} used twice in "
                                 f"{spec}")
            out[i] = Shard(dim)
    return tuple(out)


def logical_sharding(mesh, logical_axes, rules: Optional[LogicalRules] = None):
    """The placements of ``logical_axes`` on ``mesh`` (the port's
    ``NamedSharding``)."""
    if rules is None:
        # Multi-slice mesh: batch additionally spans the cross-slice dcn
        # axis (see parallel.multislice) — models need no changes.
        from .multislice import default_rules_for_mesh

        rules = default_rules_for_mesh(mesh)
    return placements_for(mesh, logical_spec(logical_axes, rules))


def with_logical_constraint(x, logical_axes, mesh=None,
                            rules: Optional[LogicalRules] = None):
    """Reshard ``x`` to a logical sharding (``DTensor.redistribute``).
    No-op when no mesh is provided (single-device runs).  A plain tensor
    under a mesh is taken as the global value, the same on every rank."""
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor, Replicate

    want = logical_sharding(mesh, logical_axes, rules)
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def shard_pytree(params, axes_tree, mesh, rules: Optional[LogicalRules] = None):
    """Place a tree of tensors according to a matching tree of logical
    axes (``distribute_tensor``; a leaf whose axes are None is
    replicated).  A ``models.ParamTree`` (nested dicts and lists, as the
    vision models' trees are) comes back as a ``ParamTree`` of DTensor
    ``nn.Parameter``s, its ``requires_grad`` kept; a dict or list comes
    back as a dict or list of DTensors."""
    from torch.distributed.tensor import distribute_tensor

    from ..models.params import ParamTree, as_tree

    def place(x, axes):
        if axes is None:
            axes = (None,) * x.dim()
        return distribute_tensor(x.detach(), mesh,
                                 logical_sharding(mesh, axes, rules))

    def walk(tree, axes):
        if isinstance(tree, dict):
            return {k: walk(v, axes[k]) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, a) for v, a in zip(tree, axes)]
        return place(tree, axes)

    if not isinstance(params, ParamTree):
        return walk(params, axes_tree)
    grad = any(p.requires_grad for p in params.parameters())
    return ParamTree(walk(as_tree(params), axes_tree)).requires_grad_(grad)


def sharding_tree(axes_tree, mesh, rules: Optional[LogicalRules] = None):
    """Turn a tree of logical axes into a tree of placements."""
    if isinstance(axes_tree, dict):
        return {k: sharding_tree(v, mesh, rules) for k, v in axes_tree.items()}
    return logical_sharding(mesh, axes_tree, rules)

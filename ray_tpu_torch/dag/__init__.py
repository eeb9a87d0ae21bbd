"""Lazy DAGs over tasks/actors + ahead-of-time compiled execution.

Equivalent of the reference's ``python/ray/dag/`` (classic DAG API +
Compiled Graphs/aDAG).  Build graphs with ``.bind()``, run them either as
ordinary task/actor submissions (``dag.execute()``) or compiled into
channel-driven per-actor loops (``dag.experimental_compile()``).
"""

from .collective_ops import CollectiveOpNode, allreduce_bind
from .compiled import CompiledDAG, CompiledDAGRef, DAGError
from .nodes import (
    ClassMethodNode,
    DAGNode,
    FunctionNode,
    InputAttributeNode,
    InputNode,
    MultiOutputNode,
)

__all__ = [
    "CollectiveOpNode",
    "CompiledDAG",
    "CompiledDAGRef",
    "DAGError",
    "ClassMethodNode",
    "DAGNode",
    "FunctionNode",
    "InputAttributeNode",
    "InputNode",
    "MultiOutputNode",
    "allreduce_bind",
]

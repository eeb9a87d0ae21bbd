"""DAG node types for lazy task/actor graphs.

Equivalent of the reference's ``python/ray/dag/dag_node.py:32`` (DAGNode),
``input_node.py`` (InputNode/InputAttributeNode), ``class_node.py``
(ClassMethodNode), and ``output_node.py`` (MultiOutputNode).  Nodes are
built with ``.bind()`` and either executed lazily as ordinary tasks/actor
calls (``execute()``) or compiled into a static channel-driven pipeline
(``experimental_compile()`` → ``ray_tpu_torch.dag.compiled``).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

_input_ctx = threading.local()


class DAGNode:
    """Base class: a lazily-bound computation with upstream dependencies."""

    def __init__(self, args: tuple, kwargs: dict):
        self._bound_args = tuple(args)
        self._bound_kwargs = dict(kwargs)

    def upstream(self) -> List["DAGNode"]:
        ups = []
        for a in list(self._bound_args) + list(self._bound_kwargs.values()):
            if isinstance(a, DAGNode):
                ups.append(a)
        return ups

    # -- classic (uncompiled) execution ------------------------------------
    def execute(self, *input_args, **input_kwargs):
        """Recursively submit the graph as ordinary tasks/actor calls and
        return the resulting ObjectRef(s) (reference: DAGNode.execute)."""
        cache: Dict[int, Any] = {}
        return self._execute_node(cache, input_args, input_kwargs)

    def _resolve_arg(self, a, cache, input_args, input_kwargs):
        if isinstance(a, DAGNode):
            return a._execute_node(cache, input_args, input_kwargs)
        return a

    def _execute_node(self, cache, input_args, input_kwargs):
        key = id(self)
        if key not in cache:
            cache[key] = self._execute_impl(cache, input_args, input_kwargs)
        return cache[key]

    def _execute_impl(self, cache, input_args, input_kwargs):
        raise NotImplementedError

    # -- compiled execution -------------------------------------------------
    def experimental_compile(self, buffer_size_bytes: int = 8 * 1024 * 1024):
        from .compiled import CompiledDAG

        return CompiledDAG(self, buffer_size_bytes=buffer_size_bytes)


class InputNode(DAGNode):
    """The DAG's formal parameter.  Use as a context manager:

        with InputNode() as inp:
            out = actor.fwd.bind(inp)
    """

    def __init__(self):
        super().__init__((), {})

    def __enter__(self):
        _input_ctx.node = self
        return self

    def __exit__(self, *exc):
        _input_ctx.node = None

    def __getitem__(self, key):
        return InputAttributeNode(self, key)

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return InputAttributeNode(self, name)

    def _execute_impl(self, cache, input_args, input_kwargs):
        if input_kwargs:
            raise ValueError(
                "kwargs passed to execute() require InputAttributeNode access"
            )
        if len(input_args) == 1:
            return input_args[0]
        return tuple(input_args)


class InputAttributeNode(DAGNode):
    """``inp[i]`` / ``inp.key`` — selects one piece of the DAG input."""

    def __init__(self, parent: InputNode, key):
        super().__init__((parent,), {})
        self._key = key

    def _execute_impl(self, cache, input_args, input_kwargs):
        if isinstance(self._key, int):
            return input_args[self._key]
        return input_kwargs[self._key]


class ClassMethodNode(DAGNode):
    """A bound actor-method call (reference: ClassMethodNode)."""

    def __init__(self, actor_handle, method_name: str, args, kwargs):
        super().__init__(args, kwargs)
        self._actor = actor_handle
        self._method_name = method_name

    def _execute_impl(self, cache, input_args, input_kwargs):
        args = [
            self._resolve_arg(a, cache, input_args, input_kwargs)
            for a in self._bound_args
        ]
        kwargs = {
            k: self._resolve_arg(v, cache, input_args, input_kwargs)
            for k, v in self._bound_kwargs.items()
        }
        import ray_tpu_torch

        # Upstream results here are ObjectRefs (from .remote); pass them
        # through so the runtime resolves them (zero extra copies), except
        # plain input values which are passed as-is.
        method = getattr(self._actor, self._method_name)
        return method.remote(*args, **kwargs)


class FunctionNode(DAGNode):
    """A bound remote-function call (reference: FunctionNode)."""

    def __init__(self, remote_fn, args, kwargs):
        super().__init__(args, kwargs)
        self._remote_fn = remote_fn

    def _execute_impl(self, cache, input_args, input_kwargs):
        args = [
            self._resolve_arg(a, cache, input_args, input_kwargs)
            for a in self._bound_args
        ]
        kwargs = {
            k: self._resolve_arg(v, cache, input_args, input_kwargs)
            for k, v in self._bound_kwargs.items()
        }
        return self._remote_fn.remote(*args, **kwargs)


class MultiOutputNode(DAGNode):
    """Marks multiple leaves as the DAG output (reference: MultiOutputNode)."""

    def __init__(self, outputs: List[DAGNode]):
        super().__init__(tuple(outputs), {})

    def _execute_impl(self, cache, input_args, input_kwargs):
        return [
            self._resolve_arg(a, cache, input_args, input_kwargs)
            for a in self._bound_args
        ]


def topological_order(root: DAGNode) -> List[DAGNode]:
    """Deterministic post-order (upstream before downstream)."""
    seen: Dict[int, DAGNode] = {}
    order: List[DAGNode] = []

    def visit(n: DAGNode):
        if id(n) in seen:
            return
        seen[id(n)] = n
        for u in n.upstream():
            visit(u)
        order.append(n)

    visit(root)
    return order

"""Compiled static DAGs over actors — channel-driven execution.

Equivalent of the reference's ``python/ray/dag/compiled_dag_node.py:805``
(CompiledDAG): at compile time every edge of the graph becomes a
shared-memory mutable-object channel (ray
``experimental/channel/shared_memory_channel.py``), and every participating
actor starts a long-lived execution loop that reads its input channels,
runs the bound method, and writes its output channel — no per-call RPC,
scheduling, or serialization of the graph structure on the hot path.

TPU note: channel payloads are host bytes.  Device-resident jax.Arrays
handed between actors on the same host transfer via shm once (device→host
→device); cross-slice tensor movement belongs to the collective layer
(ray_tpu_torch.collective), exactly as NCCL channels do in the reference.
"""

from __future__ import annotations

import logging
import os
import secrets
from typing import Any, Dict, List, Optional, Tuple

from ..core import shm
from ..core.native import NativeChannel, ChannelClosedError, available as native_available
from ..core.serialization import deserialize_from_bytes, serialize_to_bytes
from .nodes import (
    ClassMethodNode,
    DAGNode,
    FunctionNode,
    InputAttributeNode,
    InputNode,
    MultiOutputNode,
    topological_order,
)


logger = logging.getLogger(__name__)


class DAGError(RuntimeError):
    pass


class CompiledDAG:
    """A compiled static graph.  ``execute()`` pushes one input through the
    pipeline; results are read in submission order via the returned ref's
    ``get()``."""

    def __init__(self, root: DAGNode, buffer_size_bytes: int = 8 * 1024 * 1024):
        if not native_available():
            raise RuntimeError(
                "compiled DAGs require the native channel library "
                "(build/librtpu_native.so)"
            )
        from ..core.core_worker import global_worker

        self._worker = global_worker()
        self._session = self._worker.session_id
        self._dag_id = secrets.token_hex(4)
        self._buffer = buffer_size_bytes
        self._channels: List[NativeChannel] = []
        self._loop_refs = []
        self._pending = 0
        self._torn_down = False

        self._build(root)

    # ------------------------------------------------------------- building
    def _chan_path(self, idx: str) -> str:
        return os.path.join(
            shm.SHM_DIR, f"{shm._PREFIX}_{self._session}_dag{self._dag_id}_{idx}"
        )

    def _build(self, root: DAGNode):
        if isinstance(root, MultiOutputNode):
            output_nodes = list(root._bound_args)
        else:
            output_nodes = [root]
        self._n_outputs = len(output_nodes)
        self._multi = isinstance(root, MultiOutputNode)

        order = [
            n
            for n in topological_order(root)
            if isinstance(n, ClassMethodNode)
        ]
        if not order:
            raise DAGError("compiled DAG must contain at least one actor method")
        for n in topological_order(root):
            if isinstance(n, FunctionNode):
                raise DAGError(
                    "compiled DAGs support actor methods only (bind methods on "
                    "actors; plain task nodes run via .execute())"
                )

        node_idx = {id(n): i for i, n in enumerate(order)}

        # Decide, per compute node, who consumes its value.
        consumer_actors: Dict[int, set] = {i: set() for i in range(len(order))}
        input_consumers: set = set()
        for n in order:
            actor_key = n._actor._actor_id
            for a in list(n._bound_args) + list(n._bound_kwargs.values()):
                if isinstance(a, ClassMethodNode):
                    j = node_idx[id(a)]
                    if a._actor._actor_id != actor_key:
                        consumer_actors[j].add(actor_key)
                elif isinstance(a, (InputNode, InputAttributeNode)):
                    input_consumers.add(actor_key)

        for n in output_nodes:
            if not isinstance(n, ClassMethodNode):
                raise DAGError("DAG outputs must be actor method nodes")
        is_output = {node_idx[id(n)] for n in output_nodes}

        # Create channels: input channel + one per node that needs one.  A
        # DAG whose ops never read the input gets no input channel at all
        # (writing to a reader-less channel would wedge the second execute).
        self._input_chan = None
        if input_consumers:
            self._input_chan = NativeChannel.create(
                self._chan_path("in"), self._buffer, n_readers=len(input_consumers)
            )
            self._channels.append(self._input_chan)

        node_chan_path: Dict[int, Optional[str]] = {}
        self._output_chans: Dict[int, NativeChannel] = {}
        for i, n in enumerate(order):
            n_readers = len(consumer_actors[i]) + (1 if i in is_output else 0)
            if n_readers == 0:
                node_chan_path[i] = None
                continue
            path = self._chan_path(f"n{i}")
            ch = NativeChannel.create(path, self._buffer, n_readers=n_readers)
            self._channels.append(ch)
            node_chan_path[i] = path
            if i in is_output:
                self._output_chans[i] = ch

        # Per-actor plans.
        plans: Dict[Any, dict] = {}
        handles: Dict[Any, Any] = {}
        for i, n in enumerate(order):
            key = n._actor._actor_id
            handles[key] = n._actor
            plan = plans.setdefault(
                key,
                {
                    "ops": [],
                    "input_path": self._input_chan.path if self._input_chan else None,
                },
            )

            def argspec(a):
                if isinstance(a, ClassMethodNode):
                    j = node_idx[id(a)]
                    if a._actor._actor_id == key:
                        return ("local", j)
                    return ("chan", node_chan_path[j])
                if isinstance(a, InputNode):
                    return ("input", None)
                if isinstance(a, InputAttributeNode):
                    return ("input", a._key)
                return ("const", a)

            plan["ops"].append(
                {
                    "idx": i,
                    "method": n._method_name,
                    "args": [argspec(a) for a in n._bound_args],
                    "kwargs": {k: argspec(v) for k, v in n._bound_kwargs.items()},
                    "out_path": node_chan_path[i],
                }
            )

        # Start the per-actor execution loops.
        from ..core.api_frontend import ActorMethod

        for key, plan in plans.items():
            handle = handles[key]
            ref = ActorMethod(handle, "__rtpu_dag_exec_loop__").remote(plan)
            self._loop_refs.append(ref)

        # Output read order: submission order of output_nodes.
        self._output_idxs = [node_idx[id(n)] for n in output_nodes]

    # ------------------------------------------------------------ execution
    def execute(self, *args, **kwargs) -> "CompiledDAGRef":
        if self._torn_down:
            raise DAGError("DAG has been torn down")
        if self._input_chan is not None:
            payload = serialize_to_bytes((args, kwargs))
            self._input_chan.write(payload, timeout=60.0)
        elif args or kwargs:
            raise DAGError("this DAG does not consume any input")
        self._pending += 1
        return CompiledDAGRef(self)

    def _read_result(self, timeout: Optional[float]):
        """Read one execution's outputs.  Every distinct output channel is
        drained exactly once per execution — even when one errors — so
        pipelined executions stay in sync."""
        values: Dict[int, Any] = {}
        first_exc: Optional[BaseException] = None
        seen = set()
        for i in self._output_idxs:
            if i in seen:
                continue
            seen.add(i)
            try:
                data, err = self._output_chans[i].read(timeout=timeout)
            except BaseException as e:  # timeout / closed
                if first_exc is None:
                    first_exc = e
                continue
            if err:
                exc = deserialize_from_bytes(data)
                if not isinstance(exc, BaseException):
                    exc = DAGError(str(exc))
                if first_exc is None:
                    first_exc = exc
            else:
                values[i] = deserialize_from_bytes(data)
        self._pending -= 1
        if first_exc is not None:
            raise first_exc
        outs = [values[i] for i in self._output_idxs]
        return outs if self._multi else outs[0]

    def teardown(self):
        if self._torn_down:
            return
        self._torn_down = True
        from ray_tpu_torch.util import flight_recorder as _fr

        for ch in self._channels:
            try:
                ch.close_channel()
            except Exception:
                # Best-effort: a worker that died mid-run already
                # invalidated its channel; count it so leaks show up.
                logger.debug("channel close failed during teardown",
                             exc_info=True)
                _fr.count_suppressed("dag.teardown.close_channel")
        # Loops observe the close and finish; collect their final status.
        import ray_tpu_torch

        for ref in self._loop_refs:
            try:
                ray_tpu_torch.get(ref, timeout=10)
            except Exception as e:
                logger.warning(
                    "DAG worker loop exited abnormally during teardown: %s",
                    e,
                )
                _fr.count_suppressed("dag.teardown.loop_join")
        for ch in self._channels:
            ch.detach()
            ch.unlink()
        self._channels.clear()

    def __del__(self):
        try:
            self.teardown()
        except Exception:
            # GC-time teardown: the interpreter may be mid-shutdown, so
            # even logging infrastructure can be gone — swallow, but not
            # silently when the logger still works.
            try:
                logger.debug("teardown from __del__ failed", exc_info=True)
            except Exception:  # raylint: waive[RTL003] interpreter shutdown
                pass


class CompiledDAGRef:
    """Future for one execution (reference: CompiledDAGRef).  Results must be
    consumed in submission order — the pipeline is a static schedule."""

    def __init__(self, dag: CompiledDAG):
        self._dag = dag
        self._done = False
        self._value = None

    def get(self, timeout: Optional[float] = 60.0):
        if not self._done:
            self._value = self._dag._read_result(timeout)
            self._done = True
        return self._value

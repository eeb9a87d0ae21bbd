"""Actor-side execution loop for compiled DAGs.

Runs inside the actor's worker process as one long-lived task (dispatched by
the core worker under the reserved method name ``__rtpu_dag_exec_loop__``).
Per tick it reads its input channels, executes the actor's bound methods in
topological order, and writes output channels — the analog of the
reference's per-actor ``do_exec_tasks`` loop (ray
``python/ray/dag/compiled_dag_node.py:125``).
"""

from __future__ import annotations

from typing import Any, Dict

from ..core.native import ChannelClosedError, NativeChannel
from ..core.serialization import deserialize_from_bytes, serialize_to_bytes


class _Err:
    """An upstream error flowing through the pipeline: ops forward it to
    their outputs without executing."""

    __slots__ = ("payload",)

    def __init__(self, payload: bytes):
        self.payload = payload


def dag_exec_loop(instance, plan: Dict[str, Any]) -> str:
    """Execute the per-actor plan until any channel closes.

    plan = {"input_path": str|None,
            "ops": [{"idx", "method", "args", "kwargs", "out_path"}, ...]}
    arg spec: ("const", v) | ("chan", path) | ("local", node_idx)
            | ("input", None|int|str)
    """
    chans: Dict[str, NativeChannel] = {}

    def chan(path: str) -> NativeChannel:
        ch = chans.get(path)
        if ch is None:
            ch = NativeChannel.attach(path)
            chans[path] = ch
        return ch

    needs_input = any(
        spec[0] == "input"
        for op in plan["ops"]
        for spec in list(op["args"]) + list(op["kwargs"].values())
    )

    try:
        while True:
            tick_chan_vals: Dict[str, Any] = {}
            input_val: Any = None
            if needs_input:
                data, err = chan(plan["input_path"]).read()
                input_val = _Err(data) if err else deserialize_from_bytes(data)
            local_vals: Dict[int, Any] = {}

            def resolve(spec):
                kind, ref = spec
                if kind == "const":
                    return ref
                if kind == "local":
                    return local_vals[ref]
                if kind == "chan":
                    if ref not in tick_chan_vals:
                        data, err = chan(ref).read()
                        tick_chan_vals[ref] = (
                            _Err(data) if err else deserialize_from_bytes(data)
                        )
                    return tick_chan_vals[ref]
                if kind == "input":
                    if isinstance(input_val, _Err):
                        return input_val
                    in_args, in_kwargs = input_val
                    if ref is None:
                        if in_kwargs:
                            raise ValueError("kwargs require input attribute access")
                        return in_args[0] if len(in_args) == 1 else tuple(in_args)
                    if isinstance(ref, int):
                        return in_args[ref]
                    return in_kwargs[ref]
                raise ValueError(f"bad arg spec {spec!r}")

            for op in plan["ops"]:
                # Any per-op failure — bad input selection, method raise, or
                # unserializable/oversized result — becomes a pipeline error
                # delivered to the driver; only channel closure (teardown)
                # may end the loop.
                try:
                    args = [resolve(s) for s in op["args"]]
                    kwargs = {k: resolve(s) for k, s in op["kwargs"].items()}
                except ChannelClosedError:
                    raise
                except BaseException as e:  # noqa: BLE001
                    args, kwargs = [_Err(serialize_to_bytes(e))], {}
                upstream_err = next(
                    (a for a in list(args) + list(kwargs.values()) if isinstance(a, _Err)),
                    None,
                )
                if upstream_err is not None:
                    result: Any = upstream_err
                else:
                    try:
                        from .collective_ops import (
                            RESERVED_COLLECTIVE_METHOD,
                            apply_collective,
                        )

                        if op["method"] == RESERVED_COLLECTIVE_METHOD:
                            group_name = kwargs.get("_group")
                            if group_name is not None:
                                # Device-path reduction through the bound
                                # collective group (the same path
                                # DeviceRef transfers ride; NCCL between
                                # cards, gloo through the host).
                                from ray_tpu_torch.collective import (
                                    ReduceOp, get_group,
                                )
                                from ray_tpu_torch.collective.local_group import (
                                    LocalGroup,
                                )

                                _rop = {
                                    "sum": ReduceOp.SUM,
                                    "mean": ReduceOp.MEAN,
                                    "max": ReduceOp.MAX,
                                    "min": ReduceOp.MIN,
                                    "product": ReduceOp.PRODUCT,
                                }[kwargs["_op"]]
                                group = get_group(group_name)
                                if isinstance(group, LocalGroup):
                                    # Single-process group: its API takes
                                    # the full per-rank tensor list.
                                    result = group.allreduce(
                                        list(args), _rop
                                    )[0]
                                else:
                                    # Multi-process backend (nccl, gloo):
                                    # each rank contributes ONLY its own
                                    # tensor — participants are bound in
                                    # rank order, so this actor's value is
                                    # args[rank].
                                    own = (
                                        args[group.rank]
                                        if len(args) > 1
                                        else args[0]
                                    )
                                    result = group.allreduce(own, _rop)
                            else:
                                # Host path: reduction over the
                                # channel-delivered values, on the card
                                # where this actor's own value is.
                                result = apply_collective(
                                    kwargs["_op"], args
                                )
                        else:
                            result = getattr(instance, op["method"])(
                                *args, **kwargs
                            )
                    except BaseException as e:  # noqa: BLE001 — becomes a pipeline error
                        result = _Err(serialize_to_bytes(e))
                local_vals[op["idx"]] = result
                if op["out_path"] is not None:
                    out = chan(op["out_path"])
                    if isinstance(result, _Err):
                        out.write(result.payload, error=1)
                    else:
                        try:
                            payload = serialize_to_bytes(result)
                            if len(payload) > out.capacity:
                                raise ValueError(
                                    f"DAG op {op['method']!r} result of "
                                    f"{len(payload)} bytes exceeds the channel "
                                    f"buffer ({out.capacity}); recompile with a "
                                    f"larger buffer_size_bytes"
                                )
                        except BaseException as e:  # noqa: BLE001
                            local_vals[op["idx"]] = _Err(serialize_to_bytes(e))
                            out.write(local_vals[op["idx"]].payload, error=1)
                        else:
                            out.write(payload)
    except ChannelClosedError:
        return "closed"
    finally:
        for ch in chans.values():
            ch.detach()

"""The per-process worker runtime — core-worker equivalent.

Embedded in every driver and worker process (Ray
``src/ray/core_worker/core_worker.h``).  Owns:
  - the in-process memory store + shm store client (object plane)
  - the ownership table + distributed reference counting
    (Ray ``reference_counter.h`` — simplified borrow protocol: args-holds on
    submission, incref/decref from deserializing borrowers)
  - normal task submission: lease pools per scheduling class with pipelining,
    spillback handling, retries (Ray ``normal_task_submitter.h``)
  - actor task submission: per-actor sequencing, restart-aware retries
    (Ray ``actor_task_submitter.h``)
  - the task execution loop: ordered actor queues, concurrency via a thread
    pool, inline vs shm return routing (Ray ``task_execution/``)
  - pubsub subscriptions for actor/node state.

Threading model: one asyncio event loop runs all protocol work.  In a driver
the loop runs on a background thread and the public API bridges with
``run_coroutine_threadsafe``; in a worker the loop is the main thread and
user code runs on a thread pool, so the loop stays responsive to serve
owned objects while user code blocks.
"""

from __future__ import annotations

import asyncio
import inspect
import logging
import os
import tempfile
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Set, Tuple

from .config import GlobalConfig
from .exceptions import (
    ActorDiedError,
    GetTimeoutError,
    ObjectLostError,
    TaskCancelledError,
    TaskError,
    WorkerCrashedError,
)
from .ids import (
    ActorID,
    JobID,
    NodeID,
    ObjectID,
    TaskID,
    WorkerID,
    new_object_id,
    new_task_id,
)
from .object_store import MemoryStore, ShmObjectStore
from .owner_table import OwnerTable
from .rpc import (
    UNBOUNDED,
    ClientPool,
    DirectCall,
    ForwardToPrimary,
    RetryableRpcClient,
    RpcConnectionError,
    RpcRemoteError,
    RpcServer,
    RpcTimeoutError,
    resolve_service_lanes,
)
from .serialization import (
    SerializedPayload,
    deserialize_from_bytes,
    deserialize_payload,
    dumps_function,
    is_plain_data,
    loads_function,
    oob_bytes,
    payload_nbytes,
    serialize_payload,
    serialize_to_bytes,
)
from .task_spec import ActorSpec, ObjectRef, TaskSpec, _RefMarker, function_key
from ..util.debug_locks import make_condition, make_lock

logger = logging.getLogger(__name__)


_current_trace_context = None


def _maybe_start_profile():
    """cProfile the protocol loop thread when RAY_TPU_TORCH_PROFILE_DIR is set
    (per-process .prof dumps; see docs/profiling.md).  The loop thread is
    where all RPC/serialization work happens, so this is the flamegraph
    that matters for control-plane throughput."""
    if not os.environ.get("RAY_TPU_TORCH_PROFILE_DIR"):
        return None
    import cProfile

    prof = cProfile.Profile()
    prof.enable()
    return prof


def _maybe_dump_profile(prof, role: str):
    if prof is None:
        return
    prof.disable()
    out_dir = os.environ.get("RAY_TPU_TORCH_PROFILE_DIR", tempfile.gettempdir())
    try:
        os.makedirs(out_dir, exist_ok=True)
        prof.dump_stats(os.path.join(out_dir, f"{role}-{os.getpid()}.prof"))
    except Exception:  # raylint: waive[RTL003] profiling must never break teardown
        pass


def _tracing_context():
    global _current_trace_context
    if _current_trace_context is None:
        from ray_tpu_torch.util.tracing import current_context

        _current_trace_context = current_context
    return _current_trace_context()


_flight_recorder = None


def _fr():
    """Cached lazy import of the flight recorder (import-cycle-safe: core
    modules load before ray_tpu_torch.util's package init can run)."""
    global _flight_recorder
    if _flight_recorder is None:
        from ray_tpu_torch.util import flight_recorder

        _flight_recorder = flight_recorder
    return _flight_recorder

_global_worker: Optional["CoreWorker"] = None


def global_worker() -> "CoreWorker":
    if _global_worker is None:
        raise RuntimeError("ray_tpu_torch is not initialized — call ray_tpu_torch.init() first")
    return _global_worker


def try_global_worker() -> Optional["CoreWorker"]:
    return _global_worker


def set_global_worker(w: Optional["CoreWorker"]):
    global _global_worker
    _global_worker = w


PENDING, READY, ERROR = "PENDING", "READY", "ERROR"

_EMPTY_ARGS_PAYLOAD: Optional[bytes] = None


def _inline_to_bytes(payload) -> bytes:
    """Normalize a received inline value to owned flat bytes.  Out-of-band
    reply shapes (SerializedPayload / memoryview) reference the transport
    read buffer — persisting them in an OwnedObject would pin the whole
    frame for the object's lifetime."""
    if type(payload) is SerializedPayload:
        return payload.to_bytes()
    if type(payload) is memoryview:
        return bytes(payload)
    return payload


class _LocationCache:
    """Per-worker ``object_id -> shm locations`` cache consulted before any
    borrowed-ref owner round-trip, so repeated gets of stable objects skip
    the owner entirely (the deserialized-value memo in ``memory_store``
    only covers values this process already materialized).

    Entries carry the cache *generation* at fill time: any observed fetch
    failure bumps the generation, so a fill racing an invalidation (an
    owner reply that was in flight when the loss was noticed) is dropped
    instead of resurrecting dead locations.  Loop-thread only."""

    __slots__ = (
        "_entries", "capacity", "generation",
        "hits", "misses", "invalidations",
    )

    def __init__(self, capacity: int = 4096):
        from collections import OrderedDict

        self._entries: "OrderedDict[ObjectID, list]" = OrderedDict()
        self.capacity = capacity
        self.generation = 0
        self.hits = 0
        self.misses = 0
        self.invalidations = 0

    def lookup(self, oid: ObjectID):
        entry = self._entries.get(oid)
        if entry is None:
            self.misses += 1
            return None
        self._entries.move_to_end(oid)
        self.hits += 1
        return entry

    def fill(self, oid: ObjectID, locations, gen: int):
        if gen != self.generation:
            return  # a loss was observed while this reply was in flight
        self._entries[oid] = list(locations)
        self._entries.move_to_end(oid)
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)

    def invalidate(self, oid: ObjectID):
        """A fetch through these locations failed (or the owner pruned
        them): drop the entry and fence in-flight fills."""
        self.generation += 1
        self.invalidations += 1
        self._entries.pop(oid, None)

    def drop(self, oid: ObjectID):
        # Free-path removal — no loss observed, in-flight fills of other
        # objects stay valid, so the generation does not move.
        self._entries.pop(oid, None)


class _BatchedCompleter:
    """Shared completion-batching substrate for execution threads.

    One ``call_soon_threadsafe`` loop wakeup per drain pass instead of
    per finished call — the dominant per-call cost of run_in_executor on
    a 1-core box (self-pipe write + epoll + futex each).  Used by both
    ExecPipeline (exclusive drainer) and LanePool (concurrency lanes);
    any flush-path fix lands in exactly one place.
    """

    def _init_completer(self, loop: asyncio.AbstractEventLoop):
        self.loop = loop
        self._done: List[tuple] = []
        self._done_lock = make_lock("core_worker.completer.done")
        self._done_flush_scheduled = False

    def _complete(self, fut, res):
        schedule = False
        with self._done_lock:
            self._done.append((fut, res))
            if not self._done_flush_scheduled:
                self._done_flush_scheduled = True
                schedule = True
        if schedule:
            try:
                self.loop.call_soon_threadsafe(self._flush_done)
            except RuntimeError:  # loop closed at teardown
                pass

    def _flush_done(self):
        with self._done_lock:
            done, self._done = self._done, []
            self._done_flush_scheduled = False
        for fut, res in done:
            if not fut.done():
                fut.set_result(res)


class ExecPipeline(_BatchedCompleter):
    """Sticky exclusive-execution thread for task/actor-call execution at
    max_concurrency == 1 (the default).

    Why not ThreadPoolExecutor per call: each run_in_executor round trip
    costs two GIL/futex handoffs (wake the pool thread, wake the loop
    back) — ~1ms each under contention on a 1-core box, which capped
    actor-call throughput (reference analog: Ray executes actor tasks on
    a dedicated execution thread fed by a queue, not a fresh dispatch per
    call, ``core_worker/task_execution.cc``).  A single sticky drainer
    thread executes a run of queued calls back-to-back: handoffs amortize
    across the burst, and completions flush to the loop in batches (one
    wakeup per drain pass, not per call).

    Exclusivity: the drainer IS the mutual exclusion (one thread).
    Coroutine/streaming work enqueues a bridge item: the drainer submits
    it to the event loop and blocks until it finishes, preserving
    exclusion without holding an asyncio lock across the await.

    Ordering: tickets are issued at dispatch (loop thread, arrival
    order); the drainer executes strictly in ticket order, so a call
    whose argument resolution suspends cannot be overtaken by a later
    call.  A ticket that can't be used (dispatch failed) MUST be
    abandoned or the cursor wedges — _execute guarantees this.
    """

    class Ticket:
        __slots__ = ("seq", "consumed")

        def __init__(self, seq: int):
            self.seq = seq
            self.consumed = False

    def __init__(self, loop: asyncio.AbstractEventLoop):
        self._init_completer(loop)
        self._cv = make_condition("core_worker.exec_pipeline")
        self._items: Dict[int, tuple] = {}
        self._next_ticket = 0
        self._next_exec = 0
        self._stopped = False
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------- loop-thread API
    def ticket(self) -> "ExecPipeline.Ticket":
        t = self.Ticket(self._next_ticket)
        self._next_ticket += 1
        return t

    async def run_sync(self, ticket: "ExecPipeline.Ticket", fn, *args, **kwargs):
        """Execute ``fn(*args, **kwargs)`` on the drainer thread."""
        fut = self.loop.create_future()
        ticket.consumed = True
        with self._cv:
            self._items[ticket.seq] = ("sync", (fn, args, kwargs), fut)
            self._cv.notify()
        self._ensure_thread()
        ok, val = await fut
        if ok:
            return val
        raise val

    async def run_coro(self, ticket: "ExecPipeline.Ticket", coro_factory):
        """Run a coroutine on the event loop while the drainer blocks on
        it — exclusive like a sync item, but suspendable."""
        fut = self.loop.create_future()
        ticket.consumed = True
        with self._cv:
            self._items[ticket.seq] = ("coro", coro_factory, fut)
            self._cv.notify()
        self._ensure_thread()
        ok, val = await fut
        if ok:
            return val
        raise val

    def abandon(self, ticket: "ExecPipeline.Ticket"):
        """Release an issued-but-unused ticket (dispatch failed before
        enqueue) so the in-order cursor can pass it.  Idempotent."""
        if ticket.consumed:
            return
        ticket.consumed = True
        with self._cv:
            self._items[ticket.seq] = ("skip", None, None)
            self._cv.notify()

    def stop(self):
        with self._cv:
            self._stopped = True
            self._cv.notify_all()

    # ---------------------------------------------------------- drainer side
    def _ensure_thread(self):
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._drain, daemon=True, name="exec-pipeline"
            )
            self._thread.start()

    def _drain(self):
        while True:
            with self._cv:
                while self._next_exec not in self._items and not self._stopped:
                    self._cv.wait()
                if self._next_exec not in self._items:
                    return  # stopped and drained
                kind, work, fut = self._items.pop(self._next_exec)
                self._next_exec += 1
            if kind == "skip":
                continue
            if kind == "sync":
                fn, args, kwargs = work
                try:
                    res = (True, fn(*args, **kwargs))
                except BaseException as e:  # noqa: BLE001 — reported to caller
                    res = (False, e)
            else:
                try:
                    cfut = asyncio.run_coroutine_threadsafe(work(), self.loop)
                    res = (True, cfut.result())
                except BaseException as e:  # noqa: BLE001
                    res = (False, e)
            self._complete(fut, res)



class LanePool(_BatchedCompleter):
    """N sticky execution threads for max_concurrency > 1 actors.

    run_in_executor's per-call cost on a 1-core box is dominated by the
    completion path: one ``call_soon_threadsafe`` loop wakeup per call
    (self-pipe write + epoll + futex).  The lanes share ExecPipeline's
    batched done-flush instead — a burst of overlapping calls completes
    with one loop wakeup per drain pass.  No ordering guarantees (that is
    the point of concurrency lanes); exclusion, when the user wants it,
    is the actor's own locks, exactly like the reference's concurrent
    actor threads.
    """

    def __init__(self, loop: asyncio.AbstractEventLoop, size: int):
        import queue as _queue

        self._init_completer(loop)
        self.size = max(1, size)
        self._q: "_queue.SimpleQueue" = _queue.SimpleQueue()
        self._threads: List[threading.Thread] = []
        # Under _lane_lock: lanes parked in q.get / items enqueued but not
        # yet claimed by a lane.  The spawn decision compares the two —
        # `_idle` alone LAGS the queue (an idle lane stays counted until
        # the OS schedules it), so back-to-back enqueues would under-spawn
        # and serialize behind one lane.
        self._idle = 0
        self._pending = 0
        self._lane_lock = make_lock("core_worker.lane_pool")
        self._stopped = False

    async def run(self, fn, *args, **kwargs):
        fut = self.loop.create_future()
        # Lanes spawn ON DEMAND, one per uncovered item: serve replicas
        # declare max_concurrency=1000, and eagerly spawning `size`
        # threads was a thread storm that starved a 1-core box long
        # enough to trip replica health checks.  The stopped check and
        # the enqueue share the lane lock with stop()'s drain, so no item
        # can slip into the queue after the drain ran (it would sit
        # behind the sentinels, unserved, hanging its awaiting handler).
        with self._lane_lock:
            if self._stopped:
                raise RuntimeError("lane pool is stopped")
            self._pending += 1
            spawn = (
                self._pending > self._idle
                and len(self._threads) < self.size
            )
            if spawn:
                t = threading.Thread(
                    target=self._worker, daemon=True,
                    name=f"actor-lane-{len(self._threads)}",
                )
                self._threads.append(t)
            self._q.put((fn, args, kwargs, fut))
        if spawn:
            t.start()
        ok, val = await fut
        if ok:
            return val
        raise val

    def stop(self):
        """Fail-fast shutdown.  Items a lane already claimed run to
        completion; items still QUEUED are failed with 'lane pool
        stopped' (their futures must resolve — a dropped item would hang
        its awaiting RPC handler forever).  The drain runs BEFORE the
        sentinels are pushed and under the lane lock: draining after
        would pop the sentinels themselves, stranding busy lanes blocked
        in q.get() forever, and an unlocked drain could race run() into
        enqueueing an item behind the sentinels where no lane ever serves
        it."""
        import queue as _queue

        with self._lane_lock:
            if self._stopped:
                return  # idempotent: a second drain would eat sentinels
            self._stopped = True
            while True:
                try:
                    item = self._q.get_nowait()
                except _queue.Empty:
                    break
                if item is None:  # unreachable (sentinels push below);
                    continue      # kept so a drained sentinel can't crash
                self._pending -= 1
                self._complete(
                    item[3], (False, RuntimeError("lane pool stopped"))
                )
            for _ in self._threads:
                self._q.put(None)

    def _worker(self):
        while True:
            item = None
            with self._lane_lock:
                self._idle += 1
            try:
                item = self._q.get()
            finally:
                with self._lane_lock:
                    self._idle -= 1
                    if item is not None:
                        self._pending -= 1
            if item is None:
                return  # items queued before the sentinel were served
            fn, args, kwargs, fut = item
            try:
                res = (True, fn(*args, **kwargs))
            except BaseException as e:  # noqa: BLE001 — reported to caller
                res = (False, e)
            self._complete(fut, res)



class _SubmitBudget:
    """Byte-budgeted submission backpressure (graceful overload
    degradation for the queued-task plane).

    Every task submission charges its serialized-args size (plus a small
    per-task overhead) against ``task_queue_memory_cap_bytes``; the charge
    is released when the task reaches a terminal state (reply or failure).
    A submission that would cross the cap BLOCKS its calling user thread
    until enough earlier work drains — so a producer loop submitting
    faster than the cluster executes reaches a steady state instead of
    growing driver RSS without bound (reference analog: the raylet's
    backpressure on task submission queues).  Invariants:

      - at least one submission is always admitted (a single charge larger
        than the cap passes when nothing is queued), so the cap can never
        deadlock a producer;
      - only USER threads block — the protocol loop must never wait on its
        own completions, so charges from the loop thread are
        account-only;
      - a block longer than ``task_queue_block_timeout_s`` raises
        PendingTaskBackpressureTimeout — overload surfaces as a clear
        error, not a silent hang.
    """

    # Fixed per-task cost charged on top of the args payload: spec object,
    # queue slots, return-object records.  Keeps a flood of empty-args
    # tasks bounded too.
    PER_TASK_OVERHEAD = 512

    def __init__(self):
        self._cv = make_condition("core_worker.submit_budget")
        self.queued_bytes = 0
        self.peak_bytes = 0
        self.blocked_total = 0  # submissions that had to wait at least once

    def charge(self, nbytes: int, may_block: bool):
        cap = GlobalConfig.task_queue_memory_cap_bytes
        block_start = None
        try:
            with self._cv:
                if cap > 0 and may_block:
                    deadline = None
                    while self.queued_bytes > 0 and (
                        self.queued_bytes + nbytes > cap
                    ):
                        if block_start is None:
                            block_start = time.monotonic()
                            self.blocked_total += 1
                        if deadline is None:
                            deadline = (
                                time.monotonic()
                                + GlobalConfig.task_queue_block_timeout_s
                            )
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            from .exceptions import (
                                PendingTaskBackpressureTimeout,
                            )

                            raise PendingTaskBackpressureTimeout(
                                f"submission of {nbytes} B blocked "
                                f">{GlobalConfig.task_queue_block_timeout_s}s on "
                                f"the task-queue memory cap ({cap} B, "
                                f"{self.queued_bytes} B queued)"
                            )
                        self._cv.wait(min(remaining, 1.0))
                self.queued_bytes += nbytes
                if self.queued_bytes > self.peak_bytes:
                    self.peak_bytes = self.queued_bytes
        finally:
            # Telemetry outside the cv (the flight recorder takes the
            # metrics lock); runs on both the admitted and timeout paths —
            # the wait happened either way.
            if block_start is not None:
                _fr().record_backpressure_wait(
                    time.monotonic() - block_start
                )

    def release(self, nbytes: int):
        with self._cv:
            self.queued_bytes -= nbytes
            self._cv.notify_all()

    def stats(self) -> dict:
        with self._cv:
            return {
                "queued_bytes": self.queued_bytes,
                "peak_bytes": self.peak_bytes,
                "blocked_total": self.blocked_total,
            }


class _InflightReplies:
    """Exactly-once execution under at-least-once push delivery.

    Transport-level retries of ``push_task``/``actor_push_task`` (the RPC
    layer reconnects and resends after a lost connection or a dropped
    reply) must NOT re-execute the task: the first push claims
    (task_id, attempt) and installs a future; duplicates await the same
    future and receive the same reply.  Completed entries age out FIFO
    (bounded memory); in-flight entries are never evicted.

    Reference analog: the raylet/worker task-dedup on lease retries —
    without it, a dropped REPLY would mean the task ran but the caller
    counts the attempt as failed, and any resend double-executes.
    """

    def __init__(self):
        self._futs: Dict[tuple, asyncio.Future] = {}
        self._order: deque = deque()  # (key, claim_time)

    def _retention_s(self) -> float:
        # An entry must outlive every possible resend of its push: the
        # caller retries after task_push_keepalive_s, so evicting sooner
        # than a couple of windows would let a late resend re-execute.
        return GlobalConfig.task_push_keepalive_s * 2 + 30.0

    def claim(self, key: tuple, loop) -> tuple:
        """Returns (future, is_owner)."""
        fut = self._futs.get(key)
        if fut is not None:
            return fut, False
        fut = loop.create_future()
        self._futs[key] = fut
        now = time.monotonic()
        self._order.append((key, now))
        # Age-based eviction ONLY (never count-based): exactly-once under
        # resends requires completed entries to survive the full resend
        # window regardless of how busy the worker is.
        horizon = now - self._retention_s()
        while self._order and self._order[0][1] < horizon:
            old, _ = self._order[0]
            done = self._futs.get(old)
            if done is not None and not done.done():
                break  # still running; nothing older can be evicted yet
            self._order.popleft()
            self._futs.pop(old, None)
        return fut, True


class OwnedObject:
    __slots__ = (
        "state", "inline_payload", "locations", "size", "local_refs",
        "borrows", "args_holds", "error", "event", "lineage",
        "sync_waiters",
    )

    def __init__(self):
        self.state = PENDING
        self.inline_payload: Optional[bytes] = None
        self.locations: Set[str] = set()  # agent addresses
        self.size = 0
        self.local_refs = 0
        self.borrows = 0
        self.args_holds = 0
        self.error: Optional[BaseException] = None
        self.event = asyncio.Event()
        self.lineage: Optional[TaskSpec] = None  # for reconstruction
        # threading.Events registered by user threads blocked in the
        # no-loop-roundtrip sync get fast path (see CoreWorker.get).
        self.sync_waiters: Optional[List[threading.Event]] = None

    def wake(self):
        """Mark complete: wake loop-side awaiters AND user threads blocked
        in the sync-get fast path.  Loop-thread only."""
        self.event.set()
        waiters = self.sync_waiters
        if waiters:
            for w in waiters:
                w.set()
            self.sync_waiters = None


class _ActorState:
    def __init__(self, actor_id: ActorID):
        self.actor_id = actor_id
        self.address: Optional[str] = None
        self.incarnation = 0
        self.state = "PENDING_CREATION"
        self.death_cause = ""
        self.max_task_retries = 0
        self.changed = asyncio.Event()
        self.next_seq = 0
        self.subscribed = False
        # Serializes wait-for-ALIVE + seq assignment so submission order is
        # preserved even when waiters wake in arbitrary order.  ``waiters``
        # counts submissions queued on (or about to take) the lock: the
        # synchronous ALIVE fast path may only run when it is zero, or it
        # would overtake an earlier submission still parked in the queue.
        self.submit_lock = asyncio.Lock()
        self.waiters = 0
        # Direct-submit coordination (CoreWorker._direct_submit_actor_task):
        # every seq assignment — loop path or user thread — happens under
        # seq_mutex; loop_submits counts loop-path submissions that have
        # not yet been assigned a seq, and the direct path only runs while
        # it is zero, so the two planes can never invert program order.
        self.seq_mutex = threading.Lock()
        self.loop_submits = 0
        # Direct pushes outstanding (accepted, no reply yet).  The direct
        # lane only engages while this is zero: a true sync caller waits
        # out each call so it is always zero at submit time, while an
        # async burst trips it after the first call and falls back to the
        # loop path — which batches frames.  Without this gate a burst
        # degrades into one raw send() syscall per call.
        self.direct_inflight = 0


class _DirectPushHandler(DirectCall):
    """Completion sink for a user-thread direct actor push
    (CoreWorker._direct_submit_actor_task)."""

    __slots__ = ("worker", "spec", "state", "incarnation", "seq")

    def __init__(self, worker: "CoreWorker", spec, state: _ActorState):
        super().__init__()
        self.worker = worker
        self.spec = spec
        self.state = state
        self.incarnation = 0
        self.seq = 0

    def on_reply(self, payload):
        # Fires on the worker's protocol loop — the owner→worker client's
        # read loop lives there — so the loop-affine reply plumbing runs
        # inline, exactly as it does after an awaited call().
        with self.state.seq_mutex:
            self.state.direct_inflight -= 1
        self.worker._handle_task_reply(self.spec, payload)

    def on_error(self, exc: BaseException):
        # May fire on the read loop OR, in teardown races, the submitting
        # thread; recovery touches loop-affine state, so always post.
        # Exactly one of on_reply/on_error fires per submit (the pending
        # table pops the handler before dispatch), so the inflight count
        # cannot double-decrement.
        with self.state.seq_mutex:
            self.state.direct_inflight -= 1
        self.worker._post(
            lambda: self.worker._recover_direct_push(self, exc)
        )


class _LeasePool:
    """Leases + pipelined pushes for one scheduling class
    (NormalTaskSubmitter analog)."""

    def __init__(self, worker: "CoreWorker", sched_class: tuple, template: TaskSpec):
        self.worker = worker
        self.sched_class = sched_class
        self.template = template
        self.queue: asyncio.Queue = asyncio.Queue()
        self.leases: Dict[int, dict] = {}  # lease_id -> {addr, client, inflight}
        self._tasks: set = set()  # in-flight pool coroutines (see _spawn)
        self.requesting = False
        self.idle_cancel: Dict[int, asyncio.TimerHandle] = {}
        self.pending_returns: set = set()  # in-flight return_lease RPCs
        # Per-lease pipelining cap; None = the global knob.  Recovery pools
        # pin it to 1 (see _resubmit_for_recovery); tasks submitted with
        # pipeline_depth carry their own (scheduling_class includes it, so
        # one pool never mixes depths).
        self.max_inflight: Optional[int] = (
            template.pipeline_depth or None
        )

    def submit(self, spec: TaskSpec, attempt: int = 0):
        self.queue.put_nowait((spec, attempt))
        self._pump()

    def _spawn(self, coro) -> bool:
        """create_task if a loop is running; else drop the coroutine.

        _pump/_drop_lease can fire from ``finally`` blocks while the event
        loop is tearing down (GeneratorExit during interpreter shutdown) —
        at that point there is no loop to schedule onto and the work is
        moot anyway.  Tasks are tracked so shutdown can cancel in-flight
        lease requests instead of leaving "Task was destroyed but it is
        pending" noise when the loop stops mid-grant.
        """
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            coro.close()
            return False
        t = loop.create_task(coro)
        self._tasks.add(t)
        t.add_done_callback(self._tasks.discard)
        return True

    def _pump(self):
        # Dispatch queued tasks onto leases with spare in-flight capacity.
        # Pushes use transport-level call batching: a burst dispatched in
        # one loop pass rides one multiplexed frame with independent
        # per-call replies (see RpcClient.call(batch=True)).
        try:
            asyncio.get_running_loop()
        except RuntimeError:
            # Loop tearing down (e.g. fired from a ``finally`` during
            # interpreter shutdown): bail before dequeuing anything so no
            # spec is dropped with its returns never failed.
            return
        max_inflight = (
            self.max_inflight
            if self.max_inflight is not None
            else GlobalConfig.max_tasks_in_flight_per_worker
        )
        while not self.queue.empty():
            lease = None
            for l in self.leases.values():
                if l["inflight"] < max_inflight and not l["dead"]:
                    lease = l
                    break
            if lease is None:
                self._maybe_request_lease()
                return
            spec, attempt = self.queue.get_nowait()
            if getattr(spec, "_cancelled", False):
                # ray_tpu_torch.cancel: never push it.  A queued-path cancel
                # already failed the returns, but a pushed-then-resubmitted
                # spec (worker died after the cancel notify) has not — its
                # returns still sit in _task_of_return and would hang any
                # get() forever if dropped silently here.
                if any(
                    oid in self.worker._task_of_return
                    for oid in spec.return_ids()
                ):
                    self.worker._fail_task_returns(
                        spec, TaskCancelledError(spec.name)
                    )
                continue
            lease["inflight"] += 1
            # Recorded synchronously at dispatch (same loop thread as
            # cancel_tasks): a spec either has a push address or is still
            # queued — cancel never misses the window in between.
            spec._pushed_addr = lease["addr"]  # type: ignore[attr-defined]
            timer = self.idle_cancel.pop(lease["lease_id"], None)
            if timer:
                timer.cancel()
            self._spawn(self._push(lease, spec, attempt))
        # The queue can drain without a single push (every spec was
        # cancelled): any lease left idle must still get its idle-return
        # timer, or it holds a cluster worker slot for the driver's life.
        for l in self.leases.values():
            if l["inflight"] == 0 and not l["dead"]:
                self._arm_idle(l)

    def _maybe_request_lease(self):
        if self.requesting:
            return
        self.requesting = True
        if not self._spawn(self._request_lease()):
            self.requesting = False

    async def _request_lease(self):
        try:
            agent = self.worker.agent
            payload = {
                "resources": self.template.resources,
                "strategy": self.template.strategy,
                "placement_group_id": self.template.placement_group_id,
                "bundle_index": self.template.bundle_index,
                "env_vars": self.template.env_vars,
                # OOM-defense policy input: only leases whose tasks can be
                # resubmitted should be preferred kill victims.
                "retriable": self.template.max_retries > 0,
                # Stable owner identity: leases survive transport
                # reconnects (grace + owner_ping re-association).
                "owner_id": self.worker.address,
                # Quota admission input for control-plane spillback.
                "job_id": (
                    self.template.job_id.hex()
                    if self.template.job_id else None
                ),
            }
            while True:
                try:
                    reply = await agent.call(
                        "request_lease", payload,
                        timeout=GlobalConfig.worker_startup_timeout_s + 30,
                    )
                except RpcConnectionError:
                    # A spillback target died before (or while) granting —
                    # the control plane may not have noticed yet (health
                    # timeout).  Fall back to the local agent, which will
                    # re-pick a live node; only a dead LOCAL agent is fatal.
                    if agent is self.worker.agent:
                        raise
                    agent = self.worker.agent
                    await asyncio.sleep(0.2)
                    continue
                if reply.get("granted"):
                    lease = {
                        "lease_id": reply["lease_id"],
                        "addr": reply["worker_address"],
                        "client": self.worker.worker_clients.get(
                            reply["worker_address"]
                        ),
                        "inflight": 0,
                        "dead": False,
                        "agent": agent,
                    }
                    self.leases[reply["lease_id"]] = lease
                    if self.queue.empty():
                        # Work drained while we waited for the grant: don't
                        # leak the lease — arm its idle-return timer.
                        self._arm_idle(lease)
                    break
                if reply.get("spillback"):
                    agent = self.worker.agent_clients.get(reply["spillback"])
                    continue
                await asyncio.sleep(0.2)  # cluster full; retry
        except Exception as e:  # noqa: BLE001
            # Fail one queued task so the error surfaces; rest retried later.
            if not self.queue.empty():
                spec, _ = self.queue.get_nowait()
                self.worker._fail_task_returns(spec, e)
        finally:
            self.requesting = False
            if not self.queue.empty():
                self._pump()

    async def _push(self, lease, spec: TaskSpec, attempt: int):
        try:
            # Keepalive re-push: tasks may run arbitrarily long, but an
            # UNBOUNDED reply wait turns a silently lost reply (peer
            # closed between execute and send) into an infinite hang.
            # Bounded waits + resend are SAFE: the worker dedups by
            # (task_id, attempt) (_InflightReplies), so a resend either
            # joins the still-running execution or returns the finished
            # reply instantly — exactly-once execution either way.
            delivered = False
            while True:
                try:
                    reply = await lease["client"].call(
                        "push_task",
                        {"spec": spec, "attempt": attempt},
                        timeout=GlobalConfig.task_push_keepalive_s,
                        retries=3,
                        batch=True,
                    )
                    break
                except RpcTimeoutError:
                    # The request went out and the worker is (still)
                    # executing — a later connection failure is a
                    # mid-execution death, not a failed hand-off.
                    delivered = True
                    continue
            self.worker._handle_task_reply(spec, reply)
        except RpcRemoteError as e:
            # The worker is healthy — the handler itself raised (e.g. the
            # function failed to deserialize).  Fail the task, KEEP the lease.
            self.worker._fail_task_returns(spec, e)
        except RpcConnectionError as e:
            # Worker died: drop the lease (resources are released by the
            # agent's worker monitor) and retry if allowed.
            lease["dead"] = True
            self._drop_lease(lease, returned=False)
            never_started = (
                not delivered and not getattr(e, "maybe_delivered", True)
            )
            if never_started and getattr(spec, "_handoff_retries", 0) < 20:
                # Every connect attempt was refused before the push frame
                # was ever written: the task never started anywhere, so
                # re-leasing it is exactly-once safe whatever its
                # max_retries (that budget is for mid-execution deaths).
                # Typical cause: a lease granted on a node that died in
                # the grant→push window, before the control plane's
                # health check noticed.  Bounded separately so a
                # persistently unreachable grant target cannot spin the
                # submit loop forever.
                spec._handoff_retries = getattr(spec, "_handoff_retries", 0) + 1
                logger.warning(
                    "task %s never reached its leased worker (%s); "
                    "re-leasing (handoff retry %d)",
                    spec.name, e, spec._handoff_retries,
                )
                await asyncio.sleep(0.2)  # let the health check catch up
                spec._pushed_addr = None  # re-queued: cancellable again
                self.submit(spec, attempt)
            elif attempt < spec.max_retries:
                logger.warning(
                    "task %s attempt %d failed (%s); retrying", spec.name, attempt, e
                )
                if spec.streaming:
                    # A retried generator replays from scratch; drop the
                    # dead attempt's undelivered items + stragglers.
                    self.worker._reset_stream_for_retry(spec.task_id)
                spec._pushed_addr = None  # re-queued: cancellable again
                self.submit(spec, attempt + 1)
            else:
                self.worker._fail_task_returns(
                    spec,
                    WorkerCrashedError(f"worker died executing {spec.name}: {e}"),
                )
            return
        finally:
            if not lease["dead"]:
                lease["inflight"] -= 1
        self._pump()
        if lease["inflight"] == 0 and self.queue.empty() and not lease["dead"]:
            self._arm_idle(lease)

    def _arm_idle(self, lease):
        if lease["lease_id"] in self.idle_cancel:
            return
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:  # loop tearing down; idle return is moot
            return
        self.idle_cancel[lease["lease_id"]] = loop.call_later(
            GlobalConfig.lease_idle_timeout_s,
            lambda: self._drop_lease(lease, returned=True),
        )

    def _drop_lease(self, lease, returned: bool):
        self.leases.pop(lease["lease_id"], None)
        timer = self.idle_cancel.pop(lease["lease_id"], None)
        if timer:
            timer.cancel()
        if returned:
            # Tracked: shutdown must await in-flight returns, or a lease
            # whose return RPC hasn't flushed stays pinned on the agent
            # for the owner-reap grace period after a clean exit.
            try:
                loop = asyncio.get_running_loop()
            except RuntimeError:
                return
            t = loop.create_task(self._return_lease_rpc(lease))
            self.pending_returns.add(t)
            t.add_done_callback(self.pending_returns.discard)

    async def _return_lease_rpc(self, lease):
        try:
            await lease["agent"].call(
                "return_lease", {"lease_id": lease["lease_id"]}, retries=2
            )
        except Exception as e:
            logger.debug("return_lease RPC failed: %s", e)


class ObjectRefGenerator:
    """Iterator over a streaming-generator task's yields (reference:
    ``ObjectRefGenerator``/streaming generator returns).  Each ``next()``
    blocks until the executor pushes the next item and yields an ObjectRef
    whose ``get`` returns the value."""

    def __init__(self, task_id: TaskID, worker: "CoreWorker"):
        self._task_id = task_id
        self._worker = worker

    def __iter__(self) -> "ObjectRefGenerator":
        return self

    def __next__(self):
        kind, value = self._worker._run_sync(
            self._worker._stream_next(self._task_id)
        )
        if kind == "item":
            return value
        self._closed = True
        if kind == "err":
            raise value
        raise StopIteration

    def close(self):
        """Drop the stream (abandoned consumers must not leak the queue
        and undelivered item refs for the process lifetime)."""
        if not getattr(self, "_closed", False):
            self._closed = True
            try:
                self._worker.cancel_stream(self._task_id)
            except Exception:  # raylint: waive[RTL003] shutdown races
                pass

    def __del__(self):
        self.close()


class CoreWorker:
    DRIVER = "driver"
    WORKER = "worker"

    # Owner-service methods the multi-lane RPC server may run directly on
    # a lane thread (see rpc.RpcServer): read-only resolution against the
    # sharded owner table + memory store, with ``ForwardToPrimary`` punts
    # for anything that must wait or mutate (unset events, loss reports,
    # reconstruction).  Everything NOT named here — task pushes, ref
    # counting, streams, cancels — transparently forwards to the primary
    # loop and keeps its single-threaded semantics.
    LANE_SAFE_METHODS = frozenset({
        "get_object",
        "get_object_batch",
        "probe_object",
        "probe_object_batch",
        "ping",
        # Pipeline microbatch pushes deposit into the process-local p2p
        # mailbox (own lock, no owner-table access) — lane execution keeps
        # activation streaming off the primary control loop entirely.
        "pipeline_push",
    })

    def __init__(
        self,
        mode: str,
        cp_address: str,
        agent_address: str,
        session_id: str,
        node_id: NodeID,
        job_id: Optional[JobID] = None,
        worker_id: Optional[WorkerID] = None,
        job_priority: Optional[int] = None,
        job_quota: Optional[Dict[str, float]] = None,
    ):
        self.mode = mode
        self.cp_address = cp_address
        self.agent_address = agent_address
        self.session_id = session_id
        self.node_id = node_id
        self.job_id = job_id or JobID.from_random()
        self.worker_id = worker_id or WorkerID.from_random()
        # Multi-tenant arbitration inputs, shipped with register_job (and
        # every re-register, so they survive a control-plane restart).
        self.job_priority = job_priority
        self.job_quota = dict(job_quota) if job_quota else None

        self.server = RpcServer(
            self, "127.0.0.1", 0,
            lanes=resolve_service_lanes(
                "worker" if mode == self.WORKER else "driver"
            ),
        )
        self.address: str = ""
        self.cp: Optional[RetryableRpcClient] = None
        self.agent: Optional[RetryableRpcClient] = None
        self.agent_clients = ClientPool()
        self.worker_clients = ClientPool()

        self.memory_store = MemoryStore()
        self.shm_store = ShmObjectStore(session_id)
        self.submit_budget = _SubmitBudget()
        # Sharded ownership table: lane threads resolve READY objects
        # against shards directly (see LANE_SAFE_METHODS); all mutation
        # stays on the protocol loop.
        self.owned: OwnerTable = OwnerTable(GlobalConfig.owner_table_shards)
        self.lease_pools: Dict[tuple, _LeasePool] = {}
        self.actors: Dict[ActorID, _ActorState] = {}

        self.loop: Optional[asyncio.AbstractEventLoop] = None
        self._loop_thread: Optional[threading.Thread] = None
        self._fn_cache: Dict[str, Any] = {}
        self._exported_fns: Set[str] = set()
        self._task_executor = ThreadPoolExecutor(
            max_workers=4, thread_name_prefix="task"
        )
        self._exec_pipeline: Optional[ExecPipeline] = None  # created on loop
        # Actor-execution state (when this worker hosts an actor)
        self.actor_instance = None
        self.actor_spec: Optional[ActorSpec] = None
        self.actor_incarnation = 0
        self._actor_exec_lock: Optional[asyncio.Semaphore] = None
        self._actor_seq_state: Dict[tuple, dict] = {}  # (caller, inc) -> {expected, buffer}
        self._current_task_name = ""
        self._shutdown = False
        self._inflight_submits: set = set()  # cancelled at shutdown
        self.task_events = None  # TaskEventBuffer, created on the loop
        # Streaming-generator returns: task_id -> stream state.  The item
        # queue holds ("item", ref) | ("end", None) | ("err", exc); "end"
        # enqueues only after ALL `expected` items arrived (stream notifies
        # and the task reply travel on different sockets and may reorder).
        self._streams: Dict[TaskID, dict] = {}
        # In-flight lineage reconstructions, keyed by creating task id
        # (reference: core_worker/object_recovery_manager.h:41 — concurrent
        # gets of lost objects share one resubmission).
        self._reconstructions: Dict[TaskID, asyncio.Future] = {}
        self._recovery_waiters: Dict[TaskID, asyncio.Event] = {}
        # Cross-thread callback batching: a burst of submissions/ref events
        # from user threads wakes the loop once, not once per callback.
        self._post_lock = make_lock("core_worker.post_queue")
        self._post_queue: List = []
        # Borrowed refs this process re-serialized (lent onward): their
        # outgoing decref is grace-delayed.  See on_ref_relent.
        self._relent_refs: Set[ObjectID] = set()
        # token -> (timer handle, fn): grace-delayed ref ops, flushed
        # immediately at shutdown (see _delay_refop).
        self._delayed_refops: Dict[object, tuple] = {}
        # Data-plane fast path state: borrowed-object location cache +
        # batched-get counters (published by the flight recorder flush).
        self._loc_cache = _LocationCache()
        self._batch_get_calls = 0
        self._batch_get_refs = 0
        # Owner-service shard accounting: entries served by the lock-free
        # READY fast path (any lane) vs punted to the primary loop.
        self._shard_fast_entries = 0
        self._shard_forwarded_entries = 0
        # Best-effort task cancellation (ray_tpu_torch.cancel).  Owner side:
        # return-object id -> live TaskSpec for normal tasks, pruned when
        # the task reply lands or its returns fail.  Executor side:
        # _pending_exec_tasks holds ids of pushed-but-not-replied normal
        # tasks; a cancel notify is recorded in _cancelled_tasks only for
        # a pending task (push and cancel share one ordered connection,
        # so an absent id means the task already replied) and is dropped
        # again when the reply goes out — a stale entry would wrongly
        # skip a later re-execution of the same task id (retry / lineage
        # reconstruction).  _cancelled_order bounds the set as a backstop.
        self._task_of_return: Dict[ObjectID, TaskSpec] = {}
        self._pending_exec_tasks: Set[TaskID] = set()
        self._cancelled_tasks: Set[TaskID] = set()
        self._cancelled_order: deque = deque()
        self._tasks_cancelled = 0  # owner-side accepted cancels

    def _post(self, cb) -> None:
        """Run ``cb()`` on the protocol loop; bursts coalesce into a single
        loop wakeup (the per-call ``call_soon_threadsafe`` socketpair write
        was the dominant cost of high-rate submission from user threads)."""
        with self._post_lock:
            self._post_queue.append(cb)
            if len(self._post_queue) > 1:
                return  # a drain is already scheduled
        try:
            self.loop.call_soon_threadsafe(self._drain_posts)
        except RuntimeError:
            # Loop already closed (interpreter teardown racing GC-driven
            # ref releases): drop the callback, nothing left to run it on.
            with self._post_lock:
                self._post_queue.clear()

    def _drain_posts(self) -> None:
        # One swap per invocation: callbacks posted while this batch runs
        # schedule their own drain (the len==1 guard in _post), so a fast
        # producer cannot starve the event loop inside one callback.
        with self._post_lock:
            cbs, self._post_queue = self._post_queue, []
        for cb in cbs:
            try:
                cb()
            except Exception:  # noqa: BLE001 — isolate callbacks
                logger.exception("posted callback failed")

    # ------------------------------------------------------------- lifecycle
    async def async_start(self):
        self.loop = asyncio.get_running_loop()
        self._exec_pipeline = ExecPipeline(asyncio.get_running_loop())
        self._lane_pool = None  # created at actor init for max_concurrency>1
        self._inflight_replies = _InflightReplies()
        self.address = await self.server.start()
        cp_ha_dir = os.environ.get("RAY_TPU_TORCH_CP_HA_DIR")
        cp_resolver = None
        if cp_ha_dir:
            from .cp_ha import make_cp_resolver

            cp_resolver = make_cp_resolver(cp_ha_dir, self.cp_address)
        self.cp = RetryableRpcClient(
            self.cp_address,
            push_handler=self._on_push,
            address_resolver=cp_resolver,
        )
        self.agent = RetryableRpcClient(self.agent_address)
        from .task_events import TaskEventBuffer

        self.task_events = TaskEventBuffer(
            self.cp, self.node_id.hex(), self.worker_id.hex()
        )
        # Leased workers are drained by their node agent's heartbeat pull
        # (obs_pull); their own flush loop drops to a backup cadence.
        # Drivers have no agent pulling them and keep the fast loop.
        self.task_events.pull_mode = (
            self.mode == self.WORKER and GlobalConfig.enable_obs_aggregator
        )
        self.task_events.start()
        # obs_pull staging (at-least-once): the last pull reply is kept
        # until the agent acks it on a later pull.
        self._obs_pending = None
        self._obs_batch_seq = 0
        if self.mode == self.DRIVER:
            await self.cp.call(
                "register_job",
                {"job_id": self.job_id, "driver_address": self.address,
                 "priority": self.job_priority, "quota": self.job_quota},
            )
            self._heartbeat_task = self.loop.create_task(
                self._job_heartbeat_loop()
            )
        return self.address

    async def _job_heartbeat_loop(self):
        """Job liveness signal; survives transient control-plane reconnects
        (and re-registers if the control plane restarted)."""
        period = GlobalConfig.health_check_period_s
        while not self._shutdown:
            await asyncio.sleep(period)
            try:
                reply = await self.cp.call(
                    "job_heartbeat", {"job_id": self.job_id}, retries=1
                )
                if reply.get("reregister"):
                    await self.cp.call(
                        "register_job",
                        {"job_id": self.job_id,
                         "driver_address": self.address,
                         "priority": self.job_priority,
                         "quota": self.job_quota},
                        retries=1,
                    )
            except Exception as e:
                logger.debug("driver reregister failed: %s", e)
            # Lease re-association + liveness toward EVERY agent that
            # granted this driver a lease (spillback leases live on remote
            # agents whose socket may sit idle while pushes go straight to
            # the worker): after a client reconnect these pings rebind the
            # leases to the new connection before the grace expires.
            agents = {id(self.agent): self.agent} if self.agent else {}
            for pool in list(self.lease_pools.values()):
                for lease in list(pool.leases.values()):
                    granter = lease.get("agent")
                    if granter is not None:
                        agents[id(granter)] = granter
            for agent in agents.values():
                try:
                    await agent.notify(
                        "owner_ping", {"owner_id": self.address}
                    )
                except Exception as e:
                    logger.debug("owner_ping to agent failed: %s", e)

    def start_threaded(self):
        """Driver mode: run the protocol loop on a background thread."""
        ready = threading.Event()
        err: List[BaseException] = []

        def run():
            prof = _maybe_start_profile()
            loop = asyncio.new_event_loop()
            asyncio.set_event_loop(loop)
            self.loop = loop

            async def boot():
                try:
                    await self.async_start()
                finally:
                    ready.set()

            try:
                loop.run_until_complete(boot())
                loop.run_forever()
            except BaseException as e:  # noqa: BLE001
                err.append(e)
                ready.set()
            finally:
                _maybe_dump_profile(prof, "driver-loop")
                try:
                    loop.close()
                except Exception as e:
                    logger.debug("loop close failed at thread exit: %s", e)

        self._loop_thread = threading.Thread(target=run, daemon=True, name="core-worker")
        self._loop_thread.start()
        ready.wait(timeout=30)
        if err:
            raise err[0]
        if not self.address:
            raise RuntimeError("core worker failed to start")

    def _run_sync(self, coro, timeout=None):
        """Bridge from user threads into the protocol loop."""
        if self.loop is None:
            raise RuntimeError("core worker not started")
        fut = asyncio.run_coroutine_threadsafe(coro, self.loop)
        return fut.result(timeout)

    async def async_shutdown(self):
        self._shutdown = True
        # Pending grace-delayed decrefs/releases fire NOW (their sends get
        # one loop tick to reach the wire before clients close).
        self._flush_delayed_refops()
        await asyncio.sleep(0)
        for t in list(self._inflight_submits):
            if not t.done():
                t.cancel()
        # Return every held lease NOW.  Leases are keyed to a stable owner
        # id with a reconnect grace window (chaos hardening), so a clean
        # exit that merely closes its sockets would pin the node's
        # resources for the full grace period — starving whatever runs
        # next on the cluster.  Idle-return timers are cancelled first
        # (their _drop_lease would race this sweep), and a second pass
        # catches leases landed by in-flight grant replies mid-shutdown.
        pools = list(self.lease_pools.values())
        for pool in pools:
            for timer in pool.idle_cancel.values():
                timer.cancel()
            pool.idle_cancel.clear()
        for _ in range(2):
            returns = []
            for pool in pools:
                for lease in list(pool.leases.values()):
                    pool.leases.pop(lease["lease_id"], None)
                    returns.append(pool._return_lease_rpc(lease))
                returns.extend(pool.pending_returns)
                pool.pending_returns = set()
            if returns:
                try:
                    await asyncio.wait_for(
                        asyncio.gather(*returns, return_exceptions=True),
                        timeout=2.0,
                    )
                except Exception:  # raylint: waive[RTL003] agent may be gone
                    pass
            await asyncio.sleep(0)
        # Only AFTER the return sweep: cancel in-flight pool coroutines so
        # the stopping loop leaves no destroyed-pending-task noise.
        # Cancelling BEFORE would defeat the sweep's second pass — a lease
        # granted server-side whose reply is still in flight would never
        # land in pool.leases and never be returned, pinning the node's
        # resources for the reconnect-grace window.
        for pool in pools:
            for t in list(pool._tasks):
                if not t.done():
                    t.cancel()
        # Ordered teardown (reference: core_worker/shutdown_coordinator.h):
        # cancel periodic loops first so nothing is left pending when the
        # event loop stops.
        hb = getattr(self, "_heartbeat_task", None)
        if hb is not None and not hb.done():
            hb.cancel()
            try:
                await hb
            except (asyncio.CancelledError, Exception):  # raylint: waive[RTL003] awaiting a cancelled task raises by design
                pass
        if self.task_events is not None:
            try:
                await asyncio.wait_for(self.task_events.stop(), timeout=2)
            except Exception as e:
                logger.debug("task-event stop flush failed: %s", e)
        await self._flush_obs_pending()
        # Final metrics push: a short-lived worker/driver must not silently
        # lose the last _FLUSH_INTERVAL_S window of counters on exit.
        try:
            await asyncio.wait_for(self._flush_metrics(), timeout=2)
        except Exception as e:
            logger.debug("final metrics flush failed: %s", e)
        if self._exec_pipeline is not None:
            self._exec_pipeline.stop()
        if self._lane_pool is not None:
            self._lane_pool.stop()
        await self.server.stop()
        for pool in (self.worker_clients, self.agent_clients):
            await pool.close_all()
        if self.cp:
            await self.cp.close()
        if self.agent:
            await self.agent.close()

    async def _flush_metrics(self):
        """Push the local metrics registry to the control plane NOW (loop
        coroutine — bypasses the blocking kv_put bridge)."""
        from ray_tpu_torch.util import metrics as _metrics

        try:
            # Fold the data-plane fast-path counters (framing/batch-get/
            # location-cache ints) into the registry before snapshotting.
            _fr().record_data_plane(self)
        except Exception as e:
            logger.debug("data-plane counter publish failed: %s", e)
        payload = _metrics.payload_snapshot()
        if payload is not None and self.cp is not None:
            await _metrics._kv_put_async(self, payload)

    async def _flush_obs_pending(self):
        """Deliver an unacked obs_pull staging batch straight to the
        control plane (exit path: the agent will never re-pull us).  On
        failure the loss is counted — never silent."""
        pending = getattr(self, "_obs_pending", None)
        if pending is None or self.cp is None:
            return
        te = self.task_events
        try:
            await asyncio.wait_for(
                self.cp.call("task_events", {
                    "events": pending["events"],
                    "profile_events": pending["profile_events"],
                    "worker_id": self.worker_id.hex(),
                    "span_drops": te.num_span_dropped if te else 0,
                }),
                timeout=2,
            )
            self._obs_pending = None
        except Exception as e:  # noqa: BLE001 — exit flush is best-effort
            if te is not None:
                te._count_dropped(
                    len(pending["events"]) + len(pending["profile_events"]),
                    spans=te._count_spans(pending["profile_events"]),
                )
            logger.debug("obs pending flush failed on exit: %s", e)

    async def _flush_observability(self):
        """Flush the task-event buffer AND the metrics registry — the final
        window must survive worker disconnect/exit."""
        if self.task_events is not None:
            try:
                await asyncio.wait_for(self.task_events.flush(), timeout=2)
            except Exception as e:
                logger.debug("task-event flush failed on disconnect: %s", e)
        await self._flush_obs_pending()
        try:
            await asyncio.wait_for(self._flush_metrics(), timeout=2)
        except Exception as e:
            logger.debug("metrics flush failed on disconnect: %s", e)

    def shutdown(self):
        if self.loop and self._loop_thread:
            try:
                self._run_sync(self.async_shutdown(), timeout=5)
            except Exception as e:
                logger.debug("async shutdown failed: %s", e)
            try:
                self.loop.call_soon_threadsafe(self.loop.stop)
            except RuntimeError:
                pass  # loop already closed — don't abort the caller's
                # teardown (node.stop() must still run)
            self._loop_thread.join(timeout=5)
        self._task_executor.shutdown(wait=False)

    # ----------------------------------------------------------------- puts
    def _new_owned(self, object_id: ObjectID, lineage=None) -> OwnedObject:
        obj = OwnedObject()
        obj.lineage = None
        self.owned[object_id] = obj
        if lineage is not None and GlobalConfig.lineage_pinning:
            self._lineage_attach(obj, lineage)
        return obj

    async def _put_async(self, value: Any) -> ObjectRef:
        from .serialization import (
            holds_tensors,
            is_plain_data,
            serialize,
            serialized_nbytes,
            write_serialized,
        )

        oid = new_object_id()
        obj = self._new_owned(oid)
        obj.local_refs += 1
        # Tensors are not cached as given: torch has no read-only tensors,
        # and a CUDA one would stay pinned on the card.  ``get`` decodes
        # them, as CPU tensors, here as in any other process.
        cache = not holds_tensors(value)
        header, views = serialize(value, prefer_plain=is_plain_data(value))
        size = serialized_nbytes(header, views)
        obj.size = size
        if size <= GlobalConfig.max_inline_object_bytes:
            buf = bytearray(size)
            write_serialized(header, views, buf)
            obj.inline_payload = bytes(buf)
            if cache:
                self.memory_store.put(oid, value)
        else:
            # Zero-copy: pickle-5 buffers memcpy straight into the arena.
            # The arena entry is sealed natively before this returns, so
            # readers (local mmap or agent chunk reads, which fall back to
            # the arena) never race it; the agent-side directory seal is
            # only eviction bookkeeping and rides a pipelined oneway frame
            # — FIFO on the agent connection, so any later free/pull on
            # this conn observes it.  Skipping the awaited round trip is
            # worth ~20% put bandwidth at 64 MiB.  Any DISK-bound write
            # (arena-oversized value, or shm exhaustion discovered
            # mid-write — NeedsSpill) moves to an executor thread: a
            # multi-GiB disk write must not stall the protocol loop.  An
            # exhausted spill tier raises ObjectStoreFullError — the put
            # fails loudly instead of hanging or SIGBUS-ing on tmpfs —
            # and a failed put must not strand its owned record.
            try:
                from .object_store import NeedsSpill

                try:
                    _, tier = self.shm_store.create_serialized(
                        oid, header, views, inline_spill_ok=False
                    )
                except NeedsSpill:
                    loop = asyncio.get_running_loop()
                    _, tier = await loop.run_in_executor(
                        None, self.shm_store.create_serialized,
                        oid, header, views,
                    )
            except BaseException:
                self.owned.pop(oid, None)
                self.memory_store.free(oid)
                raise
            await self.agent.notify(
                "seal_object", {"object_id": oid, "size": size, "tier": tier}
            )
            obj.locations.add(self.agent_address)
            if tier != "spill" and cache:
                # Local cache for owner gets.  Spilled values stay on
                # disk: caching would pin an arena-oversized value in the
                # driver heap — exactly the RSS growth spilling avoids.
                self.memory_store.put(oid, value)
        obj.state = READY
        obj.wake()
        ref = ObjectRef.__new__(ObjectRef)
        ref.id = oid
        ref.owner_address = self.address
        ref._worker = self
        return ref

    def put(self, value: Any) -> ObjectRef:
        return self._run_sync(self._put_async(value))

    # ----------------------------------------------------------------- gets
    async def get_async(self, ref: ObjectRef, timeout: Optional[float] = None):
        try:
            return await asyncio.wait_for(self._get_one(ref), timeout)
        except asyncio.TimeoutError:
            raise GetTimeoutError(f"get() timed out on {ref}")

    async def _get_one(self, ref: ObjectRef):
        oid = ref.id
        if ref.owner_address == self.address:
            obj = self.owned.get(oid)
            if obj is None:
                # Owned but already freed, or unknown.
                if self.memory_store.contains(oid):
                    return self.memory_store.peek(oid)
                raise ObjectLostError(oid.hex(), "owner has no record")
            await obj.event.wait()
            if obj.state == ERROR:
                raise obj.error
            if self.memory_store.contains(oid):
                return self.memory_store.peek(oid)
            if obj.inline_payload is not None:
                value = deserialize_from_bytes(obj.inline_payload)
                self.memory_store.put(oid, value)
                return value
            for attempt in range(GlobalConfig.max_object_reconstructions + 1):
                try:
                    return await self._fetch_from_locations(
                        oid, sorted(obj.locations)
                    )
                except Exception as fetch_exc:  # noqa: BLE001 — loss shapes vary
                    if (
                        obj.lineage is None
                        or attempt >= GlobalConfig.max_object_reconstructions
                    ):
                        if isinstance(fetch_exc, ObjectLostError):
                            raise
                        raise ObjectLostError(oid.hex(), str(fetch_exc))
                    await self._reconstruct_object(oid, obj)
                    if obj.state == ERROR:
                        raise obj.error
                    if obj.inline_payload is not None:
                        value = deserialize_from_bytes(obj.inline_payload)
                        self.memory_store.put(oid, value)
                        return value
        # Borrowed object: resolve via the owner.
        if self.memory_store.contains(oid):
            return self.memory_store.peek(oid)
        return await self._get_borrowed(ref)

    async def _get_borrowed(self, ref: ObjectRef, lost: Optional[list] = None):
        oid = ref.id
        cache = self._loc_cache
        if not lost:
            # Location-cache fast path: a stable shm object fetches with
            # zero owner round-trips after the first resolution.
            cached = cache.lookup(oid)
            if cached is not None:
                try:
                    return await self._fetch_from_locations(oid, cached)
                except Exception as fetch_exc:  # noqa: BLE001 — any miss falls to the owner
                    cache.invalidate(oid)
                    lost = list(getattr(fetch_exc, "failed_locations", ()))
        lost = lost or []
        owner = self.worker_clients.get(ref.owner_address)
        for attempt in range(GlobalConfig.max_object_reconstructions + 1):
            # The owner's handler blocks until the producing task finishes
            # (and reconstructs lost values) — don't let the default RPC
            # deadline fire.  Record the generation BEFORE the call: a
            # loss observed while the reply is in flight must fence the
            # fill below.
            gen = cache.generation
            reply = await owner.call(
                "get_object", {"object_id": oid, "lost_locations": lost},
                timeout=UNBOUNDED,
            )
            kind = reply["kind"]
            if kind == "inline":
                value = deserialize_payload(reply["payload"])
                self.memory_store.put(oid, value)
                return value
            if kind == "error":
                raise deserialize_payload(reply["payload"])
            cache.fill(oid, reply["locations"], gen)
            try:
                # shm: fetch via local agent (zero-copy if node-local)
                return await self._fetch_from_locations(
                    oid, reply["locations"]
                )
            except Exception as fetch_exc:  # noqa: BLE001
                # Report ONLY the copies actually tried and failed back to
                # the owner, which prunes them and reconstructs via
                # lineage if none remain (borrower-observed loss;
                # reference: ownership_object_directory + recovery).
                # Claiming every listed copy died would trigger needless
                # lineage reconstruction of still-healthy replicas.
                cache.invalidate(oid)
                lost = list(getattr(fetch_exc, "failed_locations", ()))
                if attempt >= GlobalConfig.max_object_reconstructions:
                    raise ObjectLostError(oid.hex(), str(fetch_exc))
        raise ObjectLostError(oid.hex(), "reconstruction attempts exhausted")

    async def _reconstruct_object(self, oid: ObjectID, obj: "OwnedObject"):
        """Re-run the creating task to rebuild a lost object (reference:
        core_worker/object_recovery_manager.h:41 — all alternate copies are
        gone, so resubmit via lineage).  Concurrent losses of sibling
        return objects share one resubmission."""
        spec = obj.lineage
        fut = self._reconstructions.get(spec.task_id)
        if fut is None:
            fut = asyncio.ensure_future(self._resubmit_for_recovery(spec))
            self._reconstructions[spec.task_id] = fut
            fut.add_done_callback(
                lambda _f: self._reconstructions.pop(spec.task_id, None)
            )
        await asyncio.shield(fut)
        # The resubmission repopulated this object's record; wait for it.
        target = self.owned.get(oid)
        if target is not None:
            await target.event.wait()

    async def _resubmit_for_recovery(self, spec: TaskSpec):
        logger.warning(
            "reconstructing lost object(s) of task %s (%s) via lineage",
            spec.task_id.hex()[:8], spec.name,
        )
        attempt = 0
        if spec.streaming:
            state = self._streams.get(spec.task_id)
            if state is None:
                self._new_stream(spec.task_id, spec)
                state = self._streams[spec.task_id]
                watermark = 10**12  # finished stream: every index is old
            else:
                watermark = state["received"]
                self._reset_stream_for_retry(spec.task_id)
            # Replay-for-recovery: indices the consumer already received
            # ([0, watermark)) are recorded without new refs or enqueues;
            # the live tail (>= watermark) streams to the consumer normally.
            state["recovery_replay"] = True
            state["replay_watermark"] = watermark
            if watermark < 10**12:
                state["received"] = watermark  # old items stay counted
            attempt = state["attempt"]
            # Reset every still-owned item record of this stream so getters
            # wait for the replayed values instead of reading dead
            # locations.
            for robj in list(self.owned.values()):  # user threads insert (submit paths)
                if robj.lineage is spec:
                    robj.state = PENDING
                    robj.error = None
                    robj.inline_payload = None
                    robj.locations = set()
                    robj.event = asyncio.Event()
        else:
            for roid in spec.return_ids():
                robj = self.owned.get(roid)
                if robj is None:
                    continue  # freed meanwhile; the task may still re-run
                robj.state = PENDING
                robj.error = None
                robj.inline_payload = None
                robj.locations = set()
                robj.event = asyncio.Event()
        self.task_events.record(
            spec.task_id.hex(), spec.name, "PENDING_RECONSTRUCTION",
            job_id_hex=spec.job_id.hex(), resources=spec.resources,
        )
        # Recovery submissions use a DEDICATED pool with one task per
        # lease: a shared lease could pipeline the re-execution behind a
        # task that is blocked waiting for this very object (observed
        # deadlock: consume(x) holds the worker while x's producer queues
        # behind it).  One-per-lease also keeps chained reconstructions
        # (b needs a, a lost too) on separate workers.
        sched_key = (spec.scheduling_class, "__recovery__")
        pool = self.lease_pools.get(sched_key)
        if pool is None:
            pool = _LeasePool(self, sched_key, spec)
            pool.max_inflight = 1
            self.lease_pools[sched_key] = pool
        done = asyncio.Event()
        self._recovery_waiters[spec.task_id] = done
        pool.submit(spec, attempt)
        try:
            await done.wait()
        finally:
            self._recovery_waiters.pop(spec.task_id, None)

    async def _fetch_from_locations(self, oid: ObjectID, locations: List[str]):
        if not locations:
            raise ObjectLostError(oid.hex(), "no locations")
        # Track which copies this attempt actually touched: on failure the
        # exception carries them so loss reporting prunes exactly those
        # (never the untouched replicas).
        if self.agent_address not in locations:
            tried = (locations[0],)
        else:
            tried = (self.agent_address,)
        try:
            if self.agent_address not in locations:
                await self.agent.call(
                    "pull_object",
                    {"object_id": oid, "from_agent": locations[0]},
                    timeout=GlobalConfig.rpc_call_timeout_s * 4,
                )
            loop = asyncio.get_running_loop()
            value = await loop.run_in_executor(None, self.shm_store.get, oid)
        except BaseException as e:
            try:
                e.failed_locations = tried  # type: ignore[attr-defined]
            except Exception:  # raylint: waive[RTL003] exotic exception refuses attrs; loss report degrades
                pass
            raise
        self.memory_store.put(oid, value)
        return value

    async def _fetch_batch(self, items: List[tuple]) -> List[Any]:
        """Fetch ``[(oid, locations)]`` shm objects as one batch: remote
        pulls fan in through a single ``pull_objects`` agent RPC, and the
        local arena reads + deserialization for the whole batch ride ONE
        executor hop instead of one per object.  Returns a value or the
        per-object exception in each slot (callers fall back to the
        robust per-ref path for failed slots)."""
        pulls = [
            (oid, locations[0])
            for oid, locations in items
            if locations and self.agent_address not in locations
        ]
        failures: Dict[ObjectID, BaseException] = {}
        if pulls:
            try:
                reply = await self.agent.call(
                    "pull_objects", {"items": pulls},
                    timeout=GlobalConfig.rpc_call_timeout_s * 4,
                )
                for (oid, src), err in zip(pulls, reply["errors"]):
                    if err is not None:
                        e = ObjectLostError(oid.hex(), err)
                        e.failed_locations = (src,)  # type: ignore[attr-defined]
                        failures[oid] = e
            except RpcRemoteError:
                # Agent predates the batch RPC: fall back to per-object
                # pulls (still concurrent).
                outcomes = await asyncio.gather(
                    *(
                        self.agent.call(
                            "pull_object",
                            {"object_id": oid, "from_agent": src},
                            timeout=GlobalConfig.rpc_call_timeout_s * 4,
                        )
                        for oid, src in pulls
                    ),
                    return_exceptions=True,
                )
                for (oid, src), outcome in zip(pulls, outcomes):
                    if isinstance(outcome, BaseException):
                        try:
                            outcome.failed_locations = (src,)  # type: ignore[attr-defined]
                        except Exception:  # raylint: waive[RTL003] exotic exception refuses attrs
                            pass
                        failures[oid] = outcome

        def read_all():
            out = []
            for oid, locations in items:
                failed = failures.get(oid)
                if failed is not None:
                    out.append(failed)
                    continue
                try:
                    out.append(self.shm_store.get(oid))
                except BaseException as e:  # noqa: BLE001 — per-slot isolation
                    if self.agent_address in locations:
                        tried = (self.agent_address,)
                    else:
                        tried = tuple(locations[:1])
                    try:
                        e.failed_locations = tried  # type: ignore[attr-defined]
                    except Exception:  # raylint: waive[RTL003] exotic exception refuses attrs
                        pass
                    out.append(e)
            return out

        loop = asyncio.get_running_loop()
        values = await loop.run_in_executor(None, read_all)
        for (oid, _locations), value in zip(items, values):
            if not isinstance(value, BaseException):
                self.memory_store.put(oid, value)
        return values

    async def _get_batch_from_owner(
        self, owner_address: str, refs: List[ObjectRef]
    ) -> List[Any]:
        """Resolve borrowed refs sharing one owner with a single
        ``get_object_batch`` RPC (mixed inline/shm/error entries), shm
        fetches for the batch issued as one concurrent fan-in."""
        oids = [r.id for r in refs]
        cache = self._loc_cache
        self._batch_get_calls += 1
        self._batch_get_refs += len(refs)
        owner = self.worker_clients.get(owner_address)
        gen = cache.generation
        try:
            reply = await owner.call(
                "get_object_batch", {"object_ids": oids}, timeout=UNBOUNDED
            )
        except RpcRemoteError:
            # Owner predates the batch RPC: per-ref resolution.
            return list(
                await asyncio.gather(*(self._get_one(r) for r in refs))
            )
        entries = reply["entries"]
        results: List[Any] = [None] * len(refs)
        fetch_items: List[tuple] = []  # (slot, locations)
        for i, entry in enumerate(entries):
            kind = entry["kind"]
            if kind == "inline":
                value = deserialize_payload(entry["payload"])
                self.memory_store.put(oids[i], value)
                results[i] = value
            elif kind == "error":
                raise deserialize_payload(entry["payload"])
            else:
                cache.fill(oids[i], entry["locations"], gen)
                fetch_items.append((i, entry["locations"]))
        if fetch_items:
            try:
                values = await self._fetch_batch(
                    [(oids[i], locations) for i, locations in fetch_items]
                )
            except Exception as batch_exc:  # noqa: BLE001
                # Transport-level batch failure (pull deadline over N
                # concurrent pulls, agent reconnect): recover per-ref via
                # the robust path — it retries, reports losses, and
                # surfaces the documented error types instead of a raw
                # transport error aborting the whole get.
                logger.debug("batched fetch failed, per-ref fallback: %s",
                             batch_exc)
                fetched = await asyncio.gather(
                    *(self._get_borrowed(refs[i]) for i, _ in fetch_items)
                )
                for (i, _locations), value in zip(fetch_items, fetched):
                    results[i] = value
                return results
            for (i, _locations), value in zip(fetch_items, values):
                if isinstance(value, BaseException):
                    # Slot failed: retry via the robust per-ref path,
                    # reporting exactly the copies that failed.
                    cache.invalidate(oids[i])
                    results[i] = await self._get_borrowed(
                        refs[i],
                        lost=list(getattr(value, "failed_locations", ())),
                    )
                else:
                    results[i] = value
        return results

    async def _get_many(self, refs: List[ObjectRef]) -> List[Any]:
        """Resolve many refs concurrently.  Borrowed refs are grouped by
        owner into one vectorized ``get_object_batch`` call per owner —
        an N-ref get costs one round-trip per owner, not N."""
        results: List[Any] = [None] * len(refs)
        owner_groups: Dict[str, List[int]] = {}
        coros: List = []
        slots: List[tuple] = []
        for i, ref in enumerate(refs):
            if ref.owner_address == self.address:
                coros.append(self._get_one(ref))
                slots.append((i,))
            elif self.memory_store.contains(ref.id):
                results[i] = self.memory_store.peek(ref.id)
            else:
                owner_groups.setdefault(ref.owner_address, []).append(i)
        for owner_address, idxs in owner_groups.items():
            if len(idxs) == 1:
                coros.append(self._get_one(refs[idxs[0]]))
                slots.append((idxs[0],))
            else:
                coros.append(
                    self._get_batch_from_owner(
                        owner_address, [refs[i] for i in idxs]
                    )
                )
                slots.append(tuple(idxs))
        if coros:
            outs = await asyncio.gather(*coros)
            for slot, out in zip(slots, outs):
                if len(slot) == 1:
                    results[slot[0]] = out
                else:
                    for j, i in enumerate(slot):
                        results[i] = out[j]
        return results

    _GET_MISS = object()  # sentinel: fast path can't serve, use the loop

    def _try_get_sync(self, refs, timeout: Optional[float]):
        """Resolve self-owned inline/in-memory results WITHOUT a protocol
        loop round trip: the user thread parks on a threading.Event that
        the reply handler wakes directly (OwnedObject.wake).  This removes
        the run_coroutine_threadsafe wakeup + gather machinery from the
        hot sync-call path (~2x on 1:1 sync calls on a 1-core box) and
        moves result deserialization off the protocol loop.  Returns
        _GET_MISS if any ref needs the full path (borrowed, shm-located,
        or reconstruction)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        out = []
        for ref in refs:
            if ref.owner_address != self.address:
                return self._GET_MISS
            oid = ref.id
            obj = self.owned.get(oid)
            if obj is None:
                if self.memory_store.contains(oid):
                    out.append(self.memory_store.peek(oid))
                    continue
                return self._GET_MISS
            if not obj.event.is_set():
                ev = threading.Event()
                waiters = obj.sync_waiters
                if waiters is None:
                    waiters = obj.sync_waiters = []
                waiters.append(ev)
                # Re-check after registering: wake() may have run between
                # the is_set probe and the append (it reads sync_waiters
                # after setting the event, so one side always sees the
                # other).
                if not obj.event.is_set():
                    remaining = (
                        None if deadline is None
                        else max(0.0, deadline - time.monotonic())
                    )
                    if not ev.wait(remaining):
                        raise GetTimeoutError(
                            f"get() timed out on {len(refs)} object(s)"
                        )
            if obj.state == ERROR:
                raise obj.error
            if self.memory_store.contains(oid):
                out.append(self.memory_store.peek(oid))
            elif obj.inline_payload is not None:
                value = deserialize_from_bytes(obj.inline_payload)
                self.memory_store.put(oid, value)
                out.append(value)
            elif self.agent_address in obj.locations:
                # Locally-available shm object: read + deserialize HERE,
                # on the user thread — no protocol-loop round trip and no
                # executor handoff (those two wakeups dominated repeated
                # gets of stable shm objects).  The arena is cross-process
                # locked and acquire() pins the block, so a user-thread
                # read is as safe as the loop's executor read.
                try:
                    value = self.shm_store.get(oid)
                except Exception:  # noqa: BLE001 — evicted/spill race: full path recovers
                    return self._GET_MISS
                self.memory_store.put(oid, value)
                out.append(value)
            else:
                return self._GET_MISS  # remote locations / reconstruction
        return out

    def get(self, refs, timeout: Optional[float] = None):
        single = isinstance(refs, ObjectRef)
        if single:
            refs = [refs]
        # One deadline across both paths: time the fast path burned
        # waiting before a _GET_MISS must not be granted again to the
        # async fallback.
        deadline = None if timeout is None else time.monotonic() + timeout
        results = self._try_get_sync(refs, timeout)
        if results is not self._GET_MISS:
            return results[0] if single else results
        if deadline is not None:
            timeout = max(0.001, deadline - time.monotonic())

        async def get_all():
            # Resolve concurrently: borrowed refs group into one batched
            # owner call per owner (see _get_many), and remote-owner
            # round-trips / shm pulls overlap instead of summing.  One
            # deadline timer covers the whole batch (not one per ref) —
            # same semantics, since every ref resolves concurrently under
            # the same timeout.
            if timeout is None:
                return await self._get_many(refs)
            try:
                return await asyncio.wait_for(self._get_many(refs), timeout)
            except asyncio.TimeoutError:
                raise GetTimeoutError(
                    f"get() timed out on {len(refs)} object(s)"
                )

        results = self._run_sync(get_all())
        return results[0] if single else results

    # ----------------------------------------------------------------- wait
    async def _probe_many(self, refs: List[ObjectRef]) -> List[bool]:
        """Readiness probes with the same owner-grouping as _get_many: one
        probe_object_batch RPC per owner per poll pass, not one per ref."""
        out = [False] * len(refs)
        remote: Dict[str, List[int]] = {}
        for i, ref in enumerate(refs):
            oid = ref.id
            if ref.owner_address == self.address:
                obj = self.owned.get(oid)
                out[i] = (
                    self.memory_store.contains(oid)
                    if obj is None
                    else obj.event.is_set()
                )
            elif self.memory_store.contains(oid):
                out[i] = True
            else:
                remote.setdefault(ref.owner_address, []).append(i)

        async def probe_owner(owner_address: str, idxs: List[int]):
            owner = self.worker_clients.get(owner_address)
            try:
                if len(idxs) == 1:
                    reply = await owner.call(
                        "probe_object", {"object_id": refs[idxs[0]].id}
                    )
                    flags = [reply["ready"]]
                else:
                    reply = await owner.call(
                        "probe_object_batch",
                        {"object_ids": [refs[i].id for i in idxs]},
                    )
                    flags = reply["ready"]
            except Exception:  # noqa: BLE001
                flags = [True] * len(idxs)  # owner gone: surface via get()
            for i, flag in zip(idxs, flags):
                out[i] = flag

        if remote:
            await asyncio.gather(
                *(probe_owner(a, idxs) for a, idxs in remote.items())
            )
        return out

    def wait(self, refs: List[ObjectRef], num_returns=1, timeout=None):
        async def do_wait():
            deadline = None if timeout is None else time.monotonic() + timeout
            ready: List[ObjectRef] = []
            pending = list(refs)
            while len(ready) < num_returns:
                flags = await self._probe_many(pending)
                new_pending = []
                for r, ok in zip(pending, flags):
                    if ok:
                        ready.append(r)
                    else:
                        new_pending.append(r)
                pending = new_pending
                if len(ready) >= num_returns or not pending:
                    break
                if deadline is not None and time.monotonic() >= deadline:
                    break
                await asyncio.sleep(0.01)
            return ready, pending

        return self._run_sync(do_wait())

    # ------------------------------------------------------------ ref count
    def on_ref_created(self, ref: ObjectRef):
        # Called on deserialization in a borrower (via _rehydrate_ref) and on
        # explicit construction by the owner.
        if ref.owner_address == self.address:
            obj = self.owned.get(ref.id)
            if obj is not None and self.loop is not None:
                self._post(lambda oid=ref.id: self._incr_local(oid))
        else:
            if self.loop is not None:
                self._post(lambda r=ref: self._send_incref(r))

    def _incr_local(self, oid: ObjectID):
        obj = self.owned.get(oid)
        if obj is not None:
            obj.local_refs += 1

    def on_ref_relent(self, oid: ObjectID):
        """A borrowed ref was re-serialized (lent onward): mark it so this
        process's eventual decref is grace-delayed.  Thread-safe (called
        from pickling on arbitrary threads); set mutation is atomic."""
        self._relent_refs.add(oid)

    def on_ref_escaped(self, oid: ObjectID):
        """An owned ref was serialized for another process: hold a borrow
        for a grace period so the receiver's incref can't race our free.

        Honest scope (vs the reference's exact borrower registration in
        reply metadata, reference_counter.cc): task ARGS are protected
        exactly by args_holds until the task reply; this grace hold covers
        the remaining escape paths (refs inside return values / stored
        messages), where the receiver deserializes within one RPC hop —
        a receiver stalled longer than borrow_handoff_grace_s after
        physically receiving the bytes can still lose the race."""
        if self._shutdown or self.loop is None or self.loop.is_closed():
            return

        def hold():
            obj = self.owned.get(oid)
            if obj is None:
                return
            obj.borrows += 1

            def release():
                o = self.owned.get(oid)
                if o is not None:
                    o.borrows -= 1
                    self._maybe_free(oid)

            self._delay_refop(release)

        try:
            self._post(hold)
        except RuntimeError:
            pass

    def _delay_refop(self, fn):
        """Run ``fn`` after the borrow-handoff grace period — but flush it
        IMMEDIATELY at shutdown: a borrower exiting cleanly inside the
        grace window must not leak the owner's borrow count forever
        (the grace-delayed decref would simply never fire)."""
        token = object()

        def run():
            self._delayed_refops.pop(token, None)
            fn()

        handle = asyncio.get_running_loop().call_later(
            GlobalConfig.borrow_handoff_grace_s, run
        )
        self._delayed_refops[token] = (handle, fn)

    def _flush_delayed_refops(self):
        ops, self._delayed_refops = self._delayed_refops, {}
        for handle, fn in ops.values():
            handle.cancel()
            try:
                fn()
            except Exception:  # raylint: waive[RTL003] best-effort at teardown
                pass

    def _send_incref(self, ref: ObjectRef):
        client = self.worker_clients.get(ref.owner_address)
        asyncio.get_running_loop().create_task(
            self._oneway(client, "incref", {"object_id": ref.id})
        )

    async def _oneway(self, client, method, payload):
        try:
            await client.notify(method, payload)
        except Exception as e:
            logger.debug("oneway %s notify failed: %s", method, e)

    def on_ref_deleted(self, oid: ObjectID, owner_address: str):
        if self._shutdown or self.loop is None or self.loop.is_closed():
            return
        if owner_address == self.address:
            self._post(lambda o=oid: self._decr_local(o))
        else:
            def send():
                # Last borrowed ref gone: its cached locations are dead
                # weight (and a recycled id must never hit stale entries).
                self._loc_cache.drop(oid)
                # Only refs this borrower actually RE-LENT need the grace
                # delay (the sub-borrower's incref must reach the owner
                # before our decref); plain borrows decref immediately so
                # owner-side lifetime isn't inflated.
                def fire():
                    client = self.worker_clients.get(owner_address)
                    asyncio.get_running_loop().create_task(
                        self._oneway(client, "decref", {"object_id": oid})
                    )

                if oid in self._relent_refs:
                    self._relent_refs.discard(oid)
                    self._delay_refop(fire)
                else:
                    fire()
            try:
                self._post(send)
            except RuntimeError:
                pass

    def _decr_local(self, oid: ObjectID):
        obj = self.owned.get(oid)
        if obj is not None:
            obj.local_refs -= 1
            self._maybe_free(oid)

    def _maybe_free(self, oid: ObjectID):
        obj = self.owned.get(oid)
        if obj is None:
            return
        if obj.local_refs <= 0 and obj.borrows <= 0 and obj.args_holds <= 0:
            if obj.state == PENDING:
                return  # task still running; free after completion
            del self.owned[oid]
            self._lineage_detach(obj)
            self.memory_store.free(oid)
            for agent_addr in obj.locations:
                # The local agent's free MUST ride the same connection as
                # _put_async's pipelined seal notify, or the free can be
                # processed before the seal and the late seal would
                # re-register a deleted arena entry (directory leak).
                if agent_addr == self.agent_address:
                    client = self.agent
                else:
                    client = self.agent_clients.get(agent_addr)
                asyncio.get_running_loop().create_task(
                    self._oneway_call_free(client, oid)
                )

    async def _oneway_call_free(self, client, oid):
        try:
            await client.call("free_objects", {"object_ids": [oid]}, retries=1)
        except Exception as e:
            logger.debug("oneway free_objects failed: %s", e)

    # ------------------------------------------------- streaming (owner side)
    def _new_stream(self, task_id: TaskID, spec: "TaskSpec" = None):
        if spec is not None and (
            spec.actor_id is not None or spec.max_retries <= 0
        ):
            # Actor method items can't be rebuilt by a stateless re-run;
            # non-retriable generators must not re-execute either.
            spec = None
        self._streams[task_id] = {
            "queue": asyncio.Queue(),
            "received": 0,
            "expected": None,  # set by the task reply ("streamed": n)
            "attempt": 0,
            "pending_error": None,  # delivered after in-flight items drain
            "spec": spec,  # lineage for reconstruction of item objects
        }

    def _reset_stream_for_retry(self, task_id: TaskID):
        """A retried streaming task replays from scratch: drop undelivered
        items from the dead attempt and ignore its stragglers.  The queue
        object is drained IN PLACE — a consumer may be blocked awaiting it."""
        state = self._streams.get(task_id)
        if state is not None:
            state["attempt"] += 1
            state["received"] = 0
            state["expected"] = None
            state["pending_error"] = None
            queue = state["queue"]
            while not queue.empty():
                try:
                    queue.get_nowait()
                except asyncio.QueueEmpty:
                    break

    def handle_stream_item(self, payload, conn):
        """Oneway push from the executing worker: one yielded item."""
        state = self._streams.get(payload["task_id"])
        if state is None:
            return  # stream finished/cancelled; drop
        if payload.get("attempt", 0) != state["attempt"]:
            return  # straggler from a dead attempt
        oid = ObjectID.for_task_return(payload["task_id"], payload["index"])
        replaying_old = (
            state.get("recovery_replay")
            and payload["index"] < state.get("replay_watermark", 0)
        )
        if replaying_old:
            # Lineage-reconstruction replay of an index the consumer was
            # already handed: repopulate the owned record in place — no new
            # ref, nothing enqueued, ``received`` already counted it.  An
            # index the consumer freed stays freed (the re-sealed shm copy
            # is orphaned and falls to arena LRU eviction).
            obj = self.owned.get(oid)
            if obj is None:
                return
            ret = payload["ret"]
            if ret[0] == "inline":
                obj.inline_payload = _inline_to_bytes(ret[1])
                obj.size = len(obj.inline_payload)
            else:
                obj.locations.add(ret[1])
                obj.size = ret[2]
            obj.state = READY
            obj.error = None
            obj.wake()
            self._maybe_terminate_stream(state)
            return
        obj = self.owned.get(oid)
        if obj is None:
            obj = self._new_owned(oid, lineage=state.get("spec"))
        ret = payload["ret"]
        if ret[0] == "inline":
            obj.inline_payload = _inline_to_bytes(ret[1])
            obj.size = len(obj.inline_payload)
        else:  # ("shm", agent_addr, size)
            obj.locations.add(ret[1])
            obj.size = ret[2]
        obj.state = READY
        obj.error = None
        obj.wake()
        state["received"] += 1
        # EVERY ObjectRef handed to the consumer carries one local ref —
        # a retry replay of an index the consumer still holds must not
        # alias two refs onto a single count (premature free).
        obj.local_refs += 1
        ref = ObjectRef.__new__(ObjectRef)
        ref.id = oid
        ref.owner_address = self.address
        ref._worker = self
        state["queue"].put_nowait(("item", ref))
        self._maybe_terminate_stream(state)

    @staticmethod
    def _maybe_terminate_stream(state: dict):
        if state["expected"] is not None and state["received"] >= state["expected"]:
            err = state.get("pending_error")
            state["queue"].put_nowait(
                ("err", err) if err is not None else ("end", None)
            )

    def _finish_stream(self, task_id: TaskID, streamed: Optional[int] = None,
                       error=None):
        """Terminal signal from the task reply.  Both ends (success AND
        error) wait for all ``streamed`` in-flight items first — the reply
        and the item notifies ride different sockets and may reorder."""
        state = self._streams.get(task_id)
        if state is None:
            return
        if error is not None:
            state["pending_error"] = error
            if streamed is None:
                # No count available (e.g. lease/connection failure):
                # nothing more is coming — fail now.
                state["queue"].put_nowait(("err", error))
                return
        state["expected"] = streamed if streamed is not None else state["received"]
        self._maybe_terminate_stream(state)

    async def _stream_next(self, task_id: TaskID):
        state = self._streams.get(task_id)
        if state is None:
            return ("end", None)
        kind, value = await state["queue"].get()
        if kind != "item":
            self._streams.pop(task_id, None)
        return (kind, value)

    def cancel_stream(self, task_id: TaskID):
        """Abandoned-generator cleanup (called from ObjectRefGenerator)."""
        if self.loop is not None and not self.loop.is_closed():
            self.loop.call_soon_threadsafe(self._streams.pop, task_id, None)

    def handle_incref(self, payload, conn):
        obj = self.owned.get(payload["object_id"])
        if obj is not None:
            obj.borrows += 1

    def handle_decref(self, payload, conn):
        obj = self.owned.get(payload["object_id"])
        if obj is not None:
            obj.borrows -= 1
            self._maybe_free(payload["object_id"])

    # ------------------------------------------------- owner serving objects
    def _serialize_inline_entry(self, value) -> dict:
        # Out-of-band inline reply: header + buffers ride the reply frame
        # as raw segments.  snapshot() detaches buffers aliasing the live
        # (mutable) memory-store value before the frame flushes.
        return {
            "kind": "inline",
            "payload": serialize_payload(
                value, prefer_plain=is_plain_data(value)
            ).snapshot(),
        }

    async def _get_object_entry(self, oid: ObjectID, lost=()) -> dict:
        """One owner-side resolution: the per-object body of both
        ``get_object`` and ``get_object_batch``.  Returns a reply entry —
        kind 'inline' (payload), 'shm' (locations, size) or 'error'
        (payload)."""
        obj = self.owned.get(oid)
        if obj is None:
            if self.memory_store.contains(oid):
                return self._serialize_inline_entry(self.memory_store.peek(oid))
            return {
                "kind": "error",
                "payload": serialize_to_bytes(
                    ObjectLostError(oid.hex(), "not owned by this worker")
                ),
            }
        await obj.event.wait()
        # Borrower-observed loss: prune the dead copies; reconstruct via
        # lineage if no copy remains (the borrower side of
        # object_recovery_manager.h recovery).
        if lost:
            obj.locations -= set(lost)
            if (
                not obj.locations
                and obj.inline_payload is None
                and obj.state == READY
                and not self.memory_store.contains(oid)
            ):
                if obj.lineage is not None:
                    try:
                        await self._reconstruct_object(oid, obj)
                    except Exception:  # raylint: waive[RTL003] surfaced below
                        pass
                else:
                    obj.state = ERROR
                    obj.error = ObjectLostError(
                        oid.hex(), "all copies lost and no lineage"
                    )
        if obj.state == ERROR:
            return {"kind": "error", "payload": serialize_to_bytes(obj.error)}
        if obj.inline_payload is not None:
            # Immutable flat bytes: ship them out of band, zero copies.
            return {"kind": "inline", "payload": oob_bytes(obj.inline_payload)}
        if obj.locations:
            return {"kind": "shm", "locations": sorted(obj.locations), "size": obj.size}
        # Value only in local memory store (e.g. small put): serialize now.
        if self.memory_store.contains(oid):
            return self._serialize_inline_entry(self.memory_store.peek(oid))
        return {
            "kind": "error",
            "payload": serialize_to_bytes(ObjectLostError(oid.hex(), "value missing")),
        }

    def _owner_entry_fast(self, oid: ObjectID):
        """Owner-side resolution of a READY object — pure reads against
        the sharded owner table + memory store, valid on any thread (the
        multi-lane fast path; also the no-task-allocation fast path on the
        primary loop).  Returns a reply entry, or None when the call needs
        the primary loop (event not yet set — the producing task is still
        running, or a reconstruction is in flight).

        Lane threads race primary-loop mutation (location pruning,
        reconstruction resets, frees): every ambiguous read punts to the
        primary instead of guessing.  The reconstruction reset writes
        ``state`` FIRST and swaps ``event`` LAST, so re-reading both after
        building the reply closes the torn-read window — a reset that
        cleared fields mid-read has already flipped ``state`` off READY
        by the time the post-check runs."""
        obj = self.owned.get(oid)
        if obj is None:
            if self.memory_store.contains(oid):
                try:
                    return self._serialize_inline_entry(
                        self.memory_store.peek(oid)
                    )
                except KeyError:  # contains/peek raced a free
                    return None
            return {
                "kind": "error",
                "payload": serialize_to_bytes(
                    ObjectLostError(oid.hex(), "not owned by this worker")
                ),
            }
        ev = obj.event
        state = obj.state
        if not ev.is_set() or state == PENDING:
            return None
        try:
            if state == ERROR:
                err = obj.error
                if err is None:  # reset raced between state/error writes
                    return None
                entry = {"kind": "error", "payload": serialize_to_bytes(err)}
            elif obj.inline_payload is not None:
                entry = {
                    "kind": "inline", "payload": oob_bytes(obj.inline_payload)
                }
            elif obj.locations:
                entry = {
                    "kind": "shm", "locations": sorted(obj.locations),
                    "size": obj.size,
                }
            elif self.memory_store.contains(oid):
                entry = self._serialize_inline_entry(self.memory_store.peek(oid))
            else:
                entry = {
                    "kind": "error",
                    "payload": serialize_to_bytes(
                        ObjectLostError(oid.hex(), "value missing")
                    ),
                }
        except (RuntimeError, KeyError):
            # Set/dict mutated mid-iteration or memo freed mid-peek by
            # the primary loop: resolve there instead.
            return None
        if obj.event is not ev or obj.state != state:
            return None  # reconstruction reset raced the reads above
        return entry

    def handle_get_object(self, payload, conn):
        oid = payload["object_id"]
        lost = payload.get("lost_locations") or ()
        if not lost:
            entry = self._owner_entry_fast(oid)
            if entry is not None:
                self._shard_fast_entries += 1  # raylint: waive[RTL007] 2026-08-07 lock-free telemetry; lost increments tolerated (flight-recorder gauge)
                return entry
        self._shard_forwarded_entries += 1  # raylint: waive[RTL007] 2026-08-07 lock-free telemetry; lost increments tolerated (flight-recorder gauge)
        return ForwardToPrimary(lambda: self._get_object_entry(oid, lost))

    def handle_get_object_batch(self, payload, conn):
        """Vectorized borrower resolution: one reply with an entry per
        requested object (mixed inline/shm/error).  READY entries resolve
        on the receiving lane (or inline on the primary) without a task
        allocation; only the unresolved remainder rides to the primary
        loop, where entries resolve concurrently — each may block on its
        still-running producing task without holding up the rest."""
        oids = payload["object_ids"]
        if not oids:
            return {"entries": []}
        lost = payload.get("lost_locations") or {}
        entries: List[Optional[dict]] = [None] * len(oids)
        missing: List[int] = []
        for i, oid in enumerate(oids):
            if lost.get(oid):
                missing.append(i)
                continue
            entry = self._owner_entry_fast(oid)
            if entry is None:
                missing.append(i)
            else:
                entries[i] = entry
        self._shard_fast_entries += len(oids) - len(missing)  # raylint: waive[RTL007] 2026-08-07 lock-free telemetry; lost increments tolerated (flight-recorder gauge)
        if not missing:
            return {"entries": entries}
        self._shard_forwarded_entries += len(missing)  # raylint: waive[RTL007] 2026-08-07 lock-free telemetry; lost increments tolerated (flight-recorder gauge)

        async def resolve_missing():
            resolved = await asyncio.gather(
                *(
                    self._get_object_entry(oids[i], lost.get(oids[i]) or ())
                    for i in missing
                )
            )
            for i, entry in zip(missing, resolved):
                entries[i] = entry
            return {"entries": entries}

        return ForwardToPrimary(resolve_missing)

    def handle_probe_object(self, payload, conn):
        obj = self.owned.get(payload["object_id"])
        if obj is None:
            return {"ready": self.memory_store.contains(payload["object_id"])}
        return {"ready": obj.event.is_set()}

    def handle_probe_object_batch(self, payload, conn):
        """Vectorized readiness probes for ray_tpu_torch.wait over many refs."""
        ready = []
        for oid in payload["object_ids"]:
            obj = self.owned.get(oid)
            ready.append(
                self.memory_store.contains(oid)
                if obj is None
                else obj.event.is_set()
            )
        return {"ready": ready}

    # ------------------------------------------------------------ cluster KV
    # Public façade over the control plane's KV table (the reference's
    # ``ray.experimental.internal_kv`` / GCS InternalKV, gcs_kv_manager.cc).
    def kv_put(self, namespace: str, key: str, value, overwrite: bool = True):
        return self._run_sync(
            self.cp.call(
                "kv_put",
                {"namespace": namespace, "key": key, "value": value,
                 "overwrite": overwrite},
            )
        )

    def kv_get(self, namespace: str, key: str):
        return self._run_sync(
            self.cp.call("kv_get", {"namespace": namespace, "key": key})
        )

    def kv_del(self, namespace: str, key: str) -> bool:
        return self._run_sync(
            self.cp.call("kv_del", {"namespace": namespace, "key": key})
        )

    def kv_keys(self, namespace: str, prefix: str = ""):
        return self._run_sync(
            self.cp.call(
                "kv_keys", {"namespace": namespace, "prefix": prefix}
            )
        )

    def kv_exists(self, namespace: str, key: str) -> bool:
        return self._run_sync(
            self.cp.call("kv_exists", {"namespace": namespace, "key": key})
        )

    # ------------------------------------------------------ task submission
    def _export_function(self, fn_or_cls, prefix="fn") -> str:
        pickled = dumps_function(fn_or_cls)
        key = prefix + ":" + function_key(pickled)
        if key not in self._exported_fns:
            self._run_sync(
                self.cp.call(
                    "kv_put",
                    {
                        "namespace": "functions",
                        "key": key,
                        "value": pickled,
                        "overwrite": False,
                    },
                )
            )
            self._exported_fns.add(key)
        return key

    async def _get_function(self, function_id: str):
        fn = self._fn_cache.get(function_id)
        if fn is None:
            data = await self.cp.call(
                "kv_get", {"namespace": "functions", "key": function_id}
            )
            if data is None:
                raise RuntimeError(f"function {function_id} not found in KV")
            fn = loads_function(data)
            self._fn_cache[function_id] = fn
        return fn

    _PLAIN_LEAF_TYPES = frozenset(
        (int, float, bool, str, bytes, bytearray, type(None))
    )

    def _prepare_args(self, args, kwargs) -> Tuple[bytes, List[ObjectRef]]:
        """Top-level ObjectRefs become resolve-markers (Ray semantics: task
        args are resolved to values; nested refs stay refs).  Returns the
        payload and the list of refs to hold until the task completes."""
        global _EMPTY_ARGS_PAYLOAD
        if not args and not kwargs:
            if _EMPTY_ARGS_PAYLOAD is None:
                _EMPTY_ARGS_PAYLOAD = serialize_to_bytes(([], {}))
            return _EMPTY_ARGS_PAYLOAD, []
        held: List[ObjectRef] = []

        def convert(v):
            if isinstance(v, ObjectRef):
                # scan() below records the hold; convert only rewrites.
                return _RefMarker(v.id, v.owner_address)
            return v

        conv_args = [convert(a) for a in args]
        conv_kwargs = {k: convert(v) for k, v in kwargs.items()}

        # One walk does two jobs: hold refs nested anywhere inside standard
        # containers so the owner keeps them alive while the task is in
        # flight (refs inside arbitrary user objects are still covered by
        # the worker's deserialize-time incref, with a small window — same
        # caveat as the reference's borrower protocol), and classify whether
        # every leaf is a plain-picklable builtin/ndarray so serialization
        # can skip cloudpickle (see serialize(prefer_plain=...)).
        import numpy as _np

        plain = True
        leaf_types = self._PLAIN_LEAF_TYPES

        def scan(v, depth=0):
            nonlocal plain
            t = type(v)
            if t in leaf_types:
                return
            if depth > 10:
                plain = False
                return
            if t is ObjectRef:
                held.append(v)
            elif t in (list, tuple, set, frozenset):
                for x in v:
                    scan(x, depth + 1)
            elif t is dict:
                for kk, x in v.items():
                    # Keys can't be refs (unhashable) but CAN be
                    # __main__-defined objects — they affect plainness.
                    kt = type(kk)
                    if kt not in leaf_types:
                        plain = False
                    scan(x, depth + 1)
            elif t is _np.ndarray:
                if v.dtype.hasobject:
                    plain = False
            else:
                plain = False
                # Subclassed containers/refs still get ref-hold semantics.
                if isinstance(v, ObjectRef):
                    held.append(v)
                elif isinstance(v, (list, tuple, set, frozenset)):
                    for x in v:
                        scan(x, depth + 1)
                elif isinstance(v, dict):
                    for x in v.values():
                        scan(x, depth + 1)

        for v in list(args) + list(kwargs.values()):
            scan(v, 1)
        # Out-of-band payload: the args pickle header and its buffers ride
        # the push frame as raw segments (rpc._encode_frame) instead of
        # being flattened into bytes and re-pickled — two fewer
        # full-payload copies per submission.  snapshot() preserves
        # capture-at-call-time semantics for mutable buffers (numpy args).
        payload = serialize_payload(
            (conv_args, conv_kwargs), prefer_plain=plain
        ).snapshot()
        return payload, held

    def _charge_submission(self, spec: TaskSpec, payload):
        """Charge this submission against the pending-task memory budget.
        Blocks (backpressure) only when called off the protocol loop — the
        loop itself must stay free to drain the completions that release
        charges."""
        n = payload_nbytes(payload) + _SubmitBudget.PER_TASK_OVERHEAD
        try:
            running = asyncio.get_running_loop()
        except RuntimeError:
            running = None
        # Only THIS worker's protocol loop is exempt from blocking (it
        # drains the completions that release charges).  A user's own
        # asyncio loop is an ordinary producer thread: its completions
        # arrive via our loop regardless, so blocking it is safe — and
        # exempting it would let an async producer bypass the cap.
        self.submit_budget.charge(n, may_block=running is not self.loop)
        spec._queue_charge = n  # type: ignore[attr-defined]

    def _release_queue_charge(self, spec: TaskSpec):
        # Idempotent: reply and failure paths may both fire for one spec.
        n = getattr(spec, "_queue_charge", 0)
        if n:
            spec._queue_charge = 0  # type: ignore[attr-defined]
            self.submit_budget.release(n)

    def _hold_args(self, held: List[ObjectRef]):
        for r in held:
            if r.owner_address == self.address:
                obj = self.owned.get(r.id)
                if obj is not None:
                    obj.args_holds += 1

    def _release_args(self, spec: TaskSpec):
        # Idempotent: the success path defers release to lineage GC while
        # the failure path releases immediately — both may fire.
        if getattr(spec, "_args_released", False):
            return
        spec._args_released = True  # type: ignore[attr-defined]
        for r in getattr(spec, "_held_refs", ()):  # type: ignore[attr-defined]
            if r.owner_address == self.address:
                obj = self.owned.get(r.id)
                if obj is not None:
                    obj.args_holds -= 1
                    self._maybe_free(r.id)

    # ------------------------------------------------- lineage bookkeeping
    # Lineage pinning (reference: task_manager.h:184 lineage pinning +
    # reference_counter.cc lineage ref counting): while any return object
    # of a task is still owned, the task's arg objects stay held so a
    # reconstruction can re-run it.  When the last return object is freed,
    # the args release — recursively freeing upstream lineage.

    def _lineage_attach(self, obj: "OwnedObject", spec: TaskSpec):
        obj.lineage = spec
        spec._lineage_outstanding = (  # type: ignore[attr-defined]
            getattr(spec, "_lineage_outstanding", 0) + 1
        )

    def _lineage_detach(self, obj: "OwnedObject"):
        spec = obj.lineage
        if spec is None:
            return
        obj.lineage = None
        n = getattr(spec, "_lineage_outstanding", 1) - 1
        spec._lineage_outstanding = n  # type: ignore[attr-defined]
        if n <= 0:
            self._release_args(spec)

    def submit_task(
        self,
        fn,
        args,
        kwargs,
        *,
        name: str = "",
        num_returns: int = 1,
        resources: Optional[Dict[str, float]] = None,
        strategy=None,
        max_retries: int = 0,
        placement_group_id=None,
        bundle_index: int = -1,
        env_vars: Optional[Dict[str, str]] = None,
        function_id: Optional[str] = None,
        pipeline_depth: int = 0,
    ) -> List[ObjectRef]:
        streaming = num_returns == "streaming"
        function_id = function_id or self._export_function(fn)
        payload, held = self._prepare_args(args, kwargs)
        spec = TaskSpec(
            task_id=new_task_id(),
            job_id=self.job_id,
            function_id=function_id,
            name=name or getattr(fn, "__name__", "task"),
            args_payload=payload,
            num_returns=0 if streaming else num_returns,
            streaming=streaming,
            resources=resources or {"CPU": 1},
            strategy=strategy,
            max_retries=max_retries,
            owner_address=self.address,
            placement_group_id=placement_group_id,
            bundle_index=bundle_index,
            env_vars=env_vars or {},
            trace_ctx=_tracing_context(),
            pipeline_depth=pipeline_depth,
        )
        spec._held_refs = held  # type: ignore[attr-defined]
        self._charge_submission(spec, payload)
        refs = []
        return_ids = spec.return_ids()

        # Return-object records are created HERE, on the calling thread,
        # so an immediate get() on the returned refs finds them and can
        # take the no-loop-roundtrip fast path (_try_get_sync).  Only
        # dict/obj mutations — safe under the GIL; the posted setup below
        # happens-before any reply that could touch them.
        # Reconstruction eligibility matches the reference: only
        # retriable tasks re-execute on object loss (a max_retries=0
        # task may have non-idempotent side effects).
        lineage = spec if spec.max_retries > 0 else None
        for oid in return_ids:
            obj = self._new_owned(oid, lineage=lineage)
            obj.local_refs += 1
            # Cancellation index (ray_tpu_torch.cancel maps a return ref back to
            # its producing task); pruned when the task reply lands.
            self._task_of_return[oid] = spec

        def setup():
            self._hold_args(held)
            self.task_events.record(
                spec.task_id.hex(),
                spec.name,
                "PENDING_SUBMISSION",
                job_id_hex=spec.job_id.hex(),
                resources=spec.resources,
            )
            if streaming:
                self._new_stream(spec.task_id, lineage)
            pool = self.lease_pools.get(spec.scheduling_class)
            if pool is None:
                pool = _LeasePool(self, spec.scheduling_class, spec)
                self.lease_pools[spec.scheduling_class] = pool
            pool.submit(spec)

        self._post(setup)
        if streaming:
            return ObjectRefGenerator(spec.task_id, self)
        for oid in return_ids:
            ref = ObjectRef.__new__(ObjectRef)
            ref.id = oid
            ref.owner_address = self.address
            ref._worker = self
            refs.append(ref)
        return refs

    def _handle_task_reply(self, spec: TaskSpec, reply: dict):
        for oid in spec.return_ids():
            self._task_of_return.pop(oid, None)
        self._release_queue_charge(spec)
        done = self._recovery_waiters.get(spec.task_id)
        if done is not None:
            done.set()
        if (
            not GlobalConfig.lineage_pinning
            or getattr(spec, "_lineage_outstanding", 0) <= 0
        ):
            # No return object pinned this task's lineage (actor tasks,
            # non-retriable tasks, zero-item streams): release args now.
            self._release_args(spec)
        if reply.get("error") is not None:
            exc = deserialize_from_bytes(reply["error"])
            if reply.get("streamed") is not None:
                # Mid-stream failure: deliver the items yielded before the
                # error, THEN the error.
                self._finish_stream(
                    spec.task_id, streamed=reply["streamed"], error=exc
                )
                return
            self._fail_task_returns(spec, exc)
            return
        if reply.get("streamed") is not None:
            self._finish_stream(spec.task_id, streamed=reply["streamed"])
            return
        for oid, ret in zip(spec.return_ids(), reply["returns"]):
            obj = self.owned.get(oid)
            if obj is None:
                obj = self._new_owned(oid)
            if ret[0] == "inline":
                obj.inline_payload = _inline_to_bytes(ret[1])
                obj.size = len(obj.inline_payload)
            else:  # ("shm", agent_addr, size)
                obj.locations.add(ret[1])
                obj.size = ret[2]
            obj.state = READY
            obj.wake()
            self._maybe_free(oid)

    def _fail_task_returns(self, spec: TaskSpec, exc: BaseException):
        for oid in spec.return_ids():
            self._task_of_return.pop(oid, None)
        self._release_queue_charge(spec)
        done = self._recovery_waiters.get(spec.task_id)
        if done is not None:
            done.set()
        if spec.task_id in self._streams:
            self._finish_stream(spec.task_id, error=exc)
        if spec.streaming:
            # Item records reset by a failed reconstruction would otherwise
            # stay PENDING forever and hang their getters.
            for obj in list(self.owned.values()):  # user threads insert (submit paths)
                if obj.lineage is spec and obj.state == PENDING:
                    obj.state = ERROR
                    obj.error = exc
                    obj.wake()
        for oid in spec.return_ids():
            obj = self.owned.get(oid)
            if obj is None:
                obj = self._new_owned(oid)
            self._lineage_detach(obj)  # an errored task is not re-runnable
            obj.state = ERROR
            obj.error = exc
            obj.wake()
        self._release_args(spec)

    # --------------------------------------------------------------- actors
    def create_actor(
        self,
        cls,
        args,
        kwargs,
        *,
        name=None,
        namespace="",
        resources=None,
        max_restarts=0,
        max_task_retries=0,
        max_concurrency=1,
        strategy=None,
        placement_group_id=None,
        bundle_index=-1,
        env_vars=None,
        detached=False,
        get_if_exists=False,
        tensor_transport="",
        priority=None,
    ) -> Tuple[ActorID, ActorSpec]:
        class_id = self._export_function(cls, prefix="cls")
        payload, held = self._prepare_args(args, kwargs)
        actor_id = ActorID.from_random()
        spec = ActorSpec(
            actor_id=actor_id,
            job_id=self.job_id,
            class_id=class_id,
            name=name,
            namespace=namespace,
            ctor_args_payload=payload,
            resources=resources or {"CPU": 1},
            max_restarts=max_restarts,
            max_task_retries=max_task_retries,
            max_concurrency=max_concurrency,
            strategy=strategy,
            placement_group_id=placement_group_id,
            bundle_index=bundle_index,
            env_vars=env_vars or {},
            detached=detached,
            owner_address=self.address,
            tensor_transport=tensor_transport,
            priority=priority,
        )

        async def register():
            state = self._actor_state(actor_id)
            await self._subscribe_actor(state)
            info = await self.cp.call(
                "register_actor", {"spec": spec, "get_if_exists": get_if_exists},
                timeout=GlobalConfig.worker_startup_timeout_s + 30,
            )
            self._apply_actor_info(info)
            return info

        info = self._run_sync(register())
        real_id = info["actor_id"]
        return real_id, spec

    def _actor_state(self, actor_id: ActorID) -> _ActorState:
        st = self.actors.get(actor_id)
        if st is None:
            # setdefault: submit paths now call this from user threads too,
            # so losing an insertion race must return the winner's state.
            st = self.actors.setdefault(actor_id, _ActorState(actor_id))
        return st

    async def _subscribe_actor(self, state: _ActorState):
        if not state.subscribed:
            state.subscribed = True
            await self.cp.call(
                "subscribe", {"channels": ["actor:" + state.actor_id.hex()]}
            )

    def _apply_actor_info(self, info: dict):
        state = self._actor_state(info["actor_id"])
        # seq_mutex: user-thread direct submits snapshot
        # (state, incarnation, next_seq) atomically against this update.
        with state.seq_mutex:
            state.state = info["state"]
            state.address = info["address"]
            if info.get("incarnation", 0) != state.incarnation:
                # New incarnation ⇒ the executor's per-caller sequence
                # restarts.
                state.next_seq = 0
            state.incarnation = info.get("incarnation", 0)
        state.death_cause = info.get("death_cause") or ""
        state.max_task_retries = info.get("max_task_retries", 0)
        state.changed.set()
        state.changed = asyncio.Event()

    def _on_push(self, method: str, payload):
        if method == "pub":
            channel = payload["channel"]
            if channel.startswith("actor:"):
                self._apply_actor_info(payload["message"])

    def get_actor_by_name(self, name: str, namespace: str = ""):
        async def lookup():
            return await self.cp.call(
                "get_named_actor", {"name": name, "namespace": namespace}
            )

        return self._run_sync(lookup())

    def submit_actor_task(
        self,
        actor_id: ActorID,
        method_name: str,
        args,
        kwargs,
        *,
        num_returns: int = 1,
        name: str = "",
    ) -> List[ObjectRef]:
        streaming = num_returns == "streaming"
        payload, held = self._prepare_args(args, kwargs)
        spec = TaskSpec(
            task_id=new_task_id(),
            job_id=self.job_id,
            function_id="",  # actor methods dispatch by name
            name=name or method_name,
            args_payload=payload,
            num_returns=0 if streaming else num_returns,
            streaming=streaming,
            owner_address=self.address,
            actor_id=actor_id,
            trace_ctx=_tracing_context(),
        )
        spec.method_name = method_name  # type: ignore[attr-defined]
        spec._held_refs = held  # type: ignore[attr-defined]
        self._charge_submission(spec, payload)
        return_ids = spec.return_ids()

        # Created on the calling thread so an immediate get() takes the
        # sync fast path (see submit_task).
        for oid in return_ids:
            obj = self._new_owned(oid)
            obj.local_refs += 1

        # Direct submit: the sync fast lane pickles and sends the push on
        # THIS thread (no loop wake, no submission task) when the actor is
        # alive, nothing is queued ahead, and the args pin no refs (the
        # loop-affine _hold_args step must not be skipped otherwise).
        if (
            GlobalConfig.rpc_direct_submit
            and not streaming
            and not held
            and self._direct_submit_actor_task(spec)
        ):
            refs = []
            for oid in return_ids:
                ref = ObjectRef.__new__(ObjectRef)
                ref.id = oid
                ref.owner_address = self.address
                ref._worker = self
                refs.append(ref)
            return refs

        # Loop path: count this submission until its seq is assigned so a
        # later direct submit cannot overtake it (program order).
        state = self._actor_state(actor_id)
        with state.seq_mutex:
            state.loop_submits += 1
        spec._loop_seq_pending = True  # type: ignore[attr-defined]

        def setup():
            self._hold_args(held)
            self.task_events.record(
                spec.task_id.hex(),
                spec.name,
                "PENDING_SUBMISSION",
                job_id_hex=spec.job_id.hex(),
                actor_id_hex=spec.actor_id.hex(),
            )
            if streaming:
                self._new_stream(spec.task_id, spec)
            t = asyncio.get_running_loop().create_task(
                self._submit_actor_task(spec)
            )
            # Tracked so shutdown can cancel in-flight submissions instead
            # of leaving "Task was destroyed but it is pending" noise.
            self._inflight_submits.add(t)
            t.add_done_callback(self._inflight_submits.discard)

        self._post(setup)
        if streaming:
            return ObjectRefGenerator(spec.task_id, self)
        refs = []
        for oid in return_ids:
            ref = ObjectRef.__new__(ObjectRef)
            ref.id = oid
            ref.owner_address = self.address
            ref._worker = self
            refs.append(ref)
        return refs

    def _loop_submit_done(self, state: _ActorState, spec) -> None:
        """A loop-path submission reached seq assignment (or died trying):
        stop blocking the direct fast lane on its account."""
        if getattr(spec, "_loop_seq_pending", False):
            spec._loop_seq_pending = False
            with state.seq_mutex:
                state.loop_submits -= 1

    async def _submit_actor_task(self, spec: TaskSpec, attempt: int = 0):
        state = self._actor_state(spec.actor_id)
        if state.state == "ALIVE" and state.waiters == 0 and state.subscribed:
            # Fast path: actor alive, nothing queued ahead of us — assign
            # the sequence number synchronously (no lock round trip) and
            # push; a burst of pushes coalesces into one multiplexed frame
            # at the transport (call(batch=True)).  Submission tasks start
            # in FIFO order on the loop, so order is preserved.  seq_mutex
            # orders the assignment against user-thread direct submits.
            with state.seq_mutex:
                incarnation = state.incarnation
                seq = state.next_seq
                state.next_seq += 1
                if getattr(spec, "_loop_seq_pending", False):
                    spec._loop_seq_pending = False
                    state.loop_submits -= 1
            await self._push_actor_task(spec, state, incarnation, seq, attempt)
            return
        try:
            ok = await self._submit_actor_task_slow(spec, state)
        except BaseException:
            self._loop_submit_done(state, spec)
            raise
        if ok is None:
            self._loop_submit_done(state, spec)
            return
        incarnation, seq = ok
        await self._push_actor_task(spec, state, incarnation, seq, attempt)

    async def _submit_actor_task_slow(self, spec: TaskSpec, state: _ActorState):
        """Wait-for-ALIVE path: seq assignment under a FIFO lock so two
        concurrent submissions can't swap order via the poll fallback.
        Returns (incarnation, seq) or None if the task was failed."""
        state.waiters += 1
        try:
            if not state.subscribed:
                await self._subscribe_actor(state)
            async with state.submit_lock:
                deadline = (
                    time.monotonic() + GlobalConfig.worker_startup_timeout_s * 2
                )
                while state.state in ("PENDING_CREATION", "RESTARTING"):
                    if time.monotonic() > deadline:
                        self._fail_task_returns(
                            spec,
                            ActorDiedError(
                                spec.actor_id.hex(), "creation timed out"
                            ),
                        )
                        return None
                    changed = state.changed
                    try:
                        await asyncio.wait_for(changed.wait(), timeout=1.0)
                    except asyncio.TimeoutError:
                        # Re-poll the control plane in case we missed a pub.
                        info = await self.cp.call(
                            "get_actor_info", {"actor_id": spec.actor_id}
                        )
                        if info is not None:
                            self._apply_actor_info(info)
                if state.state == "DEAD":
                    self._fail_task_returns(
                        spec, ActorDiedError(spec.actor_id.hex(), state.death_cause)
                    )
                    return None
                with state.seq_mutex:
                    seq = state.next_seq
                    state.next_seq += 1
                    incarnation = state.incarnation
                    if getattr(spec, "_loop_seq_pending", False):
                        spec._loop_seq_pending = False
                        state.loop_submits -= 1
                return incarnation, seq
        finally:
            state.waiters -= 1

    def _direct_submit_actor_task(self, spec: TaskSpec) -> bool:
        """Submit one actor push from the CALLING thread (sync fast lane).

        Eligibility (all checked, the decisive ones under ``seq_mutex``):
        the actor is ALIVE and subscribed, its worker client is already
        connected, no slow-path waiter is parked, and no loop-path
        submission is still awaiting a seq (``loop_submits == 0`` —
        program order), and no earlier direct push is still unanswered
        (``direct_inflight == 0`` — an async burst falls back to the
        batched loop path after its first call instead of degrading into
        one send() syscall per call).  Returns ``False`` → caller takes
        the loop path.
        Once the seq is consumed the push MUST converge on it (the
        executor's ordering gate admits seqs in order), so post-accept
        failures re-push the same seq via _recover_direct_push."""
        state = self.actors.get(spec.actor_id)
        if state is None or state.state != "ALIVE" or not state.subscribed:
            return False
        addr = state.address
        if addr is None:
            return False
        raw = getattr(self.worker_clients.peek(addr), "_client", None)
        if raw is None or not raw.connected:
            return False
        # Burst suppression, connection level: any outstanding reply or
        # buffered frame means loop-path traffic is in flight on this
        # connection — a direct send now would fragment its batch
        # containers for no latency win (nobody is blocked waiting).
        # Racy reads (GIL-atomic) — this only picks the lane, never
        # correctness.
        if raw._pending or raw._wsegs:
            return False
        handler = _DirectPushHandler(self, spec, state)
        with state.seq_mutex:
            if (
                state.state != "ALIVE"
                or not state.subscribed
                or state.address != addr
                or state.waiters != 0
                or state.loop_submits != 0
                or state.direct_inflight != 0
            ):
                return False
            handler.incarnation = state.incarnation
            handler.seq = state.next_seq
            if not raw.submit_direct(
                "actor_push_task",
                {
                    "spec": spec,
                    "caller": self.address,
                    "seq": handler.seq,
                    "incarnation": handler.incarnation,
                    "attempt": 0,
                },
                handler,
                timeout=GlobalConfig.task_push_keepalive_s,
            ):
                return False
            # Accepted: the handler owns completion now; consume the seq.
            state.next_seq += 1
            state.direct_inflight += 1
        # Safe from user threads (flat tuple append under the GIL).
        self.task_events.record(
            spec.task_id.hex(),
            spec.name,
            "PENDING_SUBMISSION",
            job_id_hex=spec.job_id.hex(),
            actor_id_hex=spec.actor_id.hex(),
        )
        return True

    def _recover_direct_push(self, h: _DirectPushHandler, exc: BaseException):
        """Loop-side recovery for a failed direct push (posted by
        _DirectPushHandler.on_error)."""
        if isinstance(exc, RpcRemoteError):
            self._fail_task_returns(h.spec, exc)
            return
        # Timeout or connection loss AFTER the seq was consumed: re-enter
        # the loop path's keepalive machinery with the SAME
        # (incarnation, seq) — resends dedup executor-side by
        # (task_id, attempt), and abandoning the seq would wedge the
        # actor's ordering gate.
        t = asyncio.get_running_loop().create_task(
            self._push_actor_task(h.spec, h.state, h.incarnation, h.seq, 0)
        )
        self._inflight_submits.add(t)
        t.add_done_callback(self._inflight_submits.discard)

    async def _push_actor_task(
        self, spec: TaskSpec, state: _ActorState, incarnation: int, seq: int,
        attempt: int,
    ):
        addr = state.address
        client = self.worker_clients.get(addr) if addr is not None else None
        try:
            if client is None:
                # Death already applied (address cleared) before we got
                # here — a direct push's on_error can arrive after
                # _apply_actor_info ran.  Treat it as the connection loss
                # it is: the branch below re-enters the normal submission
                # pipeline (new incarnation, new seq).
                raise RpcConnectionError(
                    f"actor {spec.actor_id.hex()} connection gone"
                )
            # Keepalive re-push (see _LeasePool._push): bounded waits +
            # dedup-safe resends instead of an unbounded reply wait.
            while True:
                try:
                    reply = await client.call(
                        "actor_push_task",
                        {
                            "spec": spec,
                            "caller": self.address,
                            "seq": seq,
                            "incarnation": incarnation,
                            "attempt": attempt,
                        },
                        timeout=GlobalConfig.task_push_keepalive_s,
                        retries=3,
                        batch=True,
                    )
                    break
                except RpcTimeoutError:
                    continue
            self._handle_task_reply(spec, reply)
        except (RpcConnectionError, RpcRemoteError) as e:
            if isinstance(e, RpcRemoteError):
                self._fail_task_returns(spec, e)
                return
            # Connection died: actor crashed or restarting.
            if addr is not None:
                await self.worker_clients.close(addr)
            if attempt < state.max_task_retries:
                await asyncio.sleep(0.2)
                if spec.streaming:
                    # The restarted actor replays the generator from
                    # scratch; drop the dead attempt's items/stragglers.
                    self._reset_stream_for_retry(spec.task_id)
                await self._submit_actor_task(spec, attempt + 1)
            else:
                self._fail_task_returns(
                    spec,
                    ActorDiedError(
                        spec.actor_id.hex(), f"connection lost during call: {e}"
                    ),
                )

    def kill_actor(self, actor_id: ActorID, no_restart: bool = True):
        self._run_sync(
            self.cp.call(
                "kill_actor", {"actor_id": actor_id, "no_restart": no_restart}
            )
        )

    # --------------------------------------------------------- cancellation
    def cancel_tasks(self, refs: List[ObjectRef]) -> None:
        """Best-effort cancel of the normal tasks producing ``refs``.

        A task still queued owner-side is dequeued and its returns fail
        with ``TaskCancelledError`` immediately.  A task already pushed
        gets a one-way cancel notify to its executor, which skips it if it
        has not started (exec-pipeline / lane queue wait) — the executor's
        cancelled reply then fails the returns.  A task that already
        finished (or an actor task / a ref from ``put``) is left alone.
        Fire-and-forget: completion is observed through the refs
        themselves.
        """
        ids = [ref.id for ref in refs]

        def do():
            n_accepted = 0
            by_addr: Dict[str, List[TaskID]] = {}
            for oid in ids:
                spec = self._task_of_return.get(oid)
                if spec is None or getattr(spec, "_cancelled", False):
                    continue  # finished, unknown, or already cancelled
                spec._cancelled = True  # type: ignore[attr-defined]
                n_accepted += 1
                addr = getattr(spec, "_pushed_addr", None)
                if addr is None:
                    # Still queued in a lease pool: fail returns now; the
                    # pool's dequeue skips cancelled specs.
                    self._fail_task_returns(
                        spec, TaskCancelledError(spec.name)
                    )
                else:
                    by_addr.setdefault(addr, []).append(spec.task_id)
            for addr, tids in by_addr.items():
                client = self.worker_clients.get(addr)
                self._spawn_inflight(
                    self._oneway(client, "cancel_task", {"task_ids": tids})
                )
            if n_accepted:
                self._tasks_cancelled += n_accepted
                _fr().counter(
                    _fr().TASKS_CANCELLED_TOTAL, float(n_accepted)
                )

        self._post(do)

    def _spawn_inflight(self, coro):
        """Track a fire-and-forget coroutine so shutdown can cancel it."""
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            coro.close()
            return
        t = loop.create_task(coro)
        self._inflight_submits.add(t)
        t.add_done_callback(self._inflight_submits.discard)

    def handle_cancel_task(self, payload, conn):
        """Executor side: mark tasks to be skipped if not yet started.

        Only PENDING tasks are recorded: the cancel rides the same ordered
        connection as the push, so an id absent from _pending_exec_tasks
        means the task already replied — recording it anyway would leave a
        stale entry that silently fails a later re-execution of the same
        task id (retry / lineage reconstruction) with TaskCancelledError.
        """
        for tid in payload["task_ids"]:
            if (
                tid in self._pending_exec_tasks
                and tid not in self._cancelled_tasks
            ):
                self._cancelled_tasks.add(tid)
                self._cancelled_order.append(tid)
        # Backstop bound (entries are normally dropped at task reply).
        while len(self._cancelled_order) > 4096:
            self._cancelled_tasks.discard(self._cancelled_order.popleft())
        return {"ok": True}

    # ------------------------------------------------------------ execution
    async def _resolve_args(self, payload):
        global _EMPTY_ARGS_PAYLOAD
        if _EMPTY_ARGS_PAYLOAD is None:
            _EMPTY_ARGS_PAYLOAD = serialize_to_bytes(([], {}))
        if type(payload) in (bytes, memoryview) and payload == _EMPTY_ARGS_PAYLOAD:
            return [], {}
        args, kwargs = deserialize_payload(payload)

        # Resolve all distinct markers CONCURRENTLY, one fetch per unique
        # object.  Sequentially awaiting each arg made a wide-args task
        # (the 10k-arg limit case) pay one full owner round trip per arg
        # — resolution wall time scaled with count x latency instead of
        # count / pipeline depth — and a ref passed N times fetched (and
        # increfed) N times.
        markers: Dict[tuple, _RefMarker] = {}
        for v in list(args) + list(kwargs.values()):
            if isinstance(v, _RefMarker):
                markers.setdefault((v.object_id, v.owner_address), v)
        resolved: Dict[tuple, Any] = {}
        fetch: Dict[tuple, _RefMarker] = {}
        for key, m in markers.items():
            # Memo short-circuit BEFORE creating a worker-bound ref: a
            # repeatedly-passed arg (n:n-with-arg pattern) resolves from
            # the local memo without the per-call incref/decref oneway
            # pair that a live ObjectRef costs (the value needs no borrow
            # — args_holds on the owner cover the in-flight task).
            if self.memory_store.contains(m.object_id):
                resolved[key] = self.memory_store.peek(m.object_id)
            else:
                fetch[key] = m
        if len(fetch) == 1:
            # Hot path (one ref arg): skip the gather machinery.
            ((key, m),) = fetch.items()
            resolved[key] = await self._get_one(
                ObjectRef(m.object_id, m.owner_address, _worker=self)
            )
        elif fetch:
            # Owner-grouped batch resolution: a wide-args task resolves
            # all refs of one owner with a single get_object_batch RPC.
            values = await self._get_many(
                [
                    ObjectRef(m.object_id, m.owner_address, _worker=self)
                    for m in fetch.values()
                ]
            )
            resolved.update(zip(fetch.keys(), values))

        def resolve(v):
            if isinstance(v, _RefMarker):
                return resolved[(v.object_id, v.owner_address)]
            return v

        args = [resolve(a) for a in args]
        kwargs = {k: resolve(v) for k, v in kwargs.items()}
        return args, kwargs

    async def _package_value(self, spec: TaskSpec, value, index: int) -> tuple:
        """Package one return/stream value: inline if small, else sealed
        zero-copy into the shm arena."""
        from .serialization import (
            is_plain_data,
            serialize,
            serialized_nbytes,
            write_serialized,
        )

        header, views = serialize(value, prefer_plain=is_plain_data(value))
        size = serialized_nbytes(header, views)
        if size <= GlobalConfig.max_inline_object_bytes:
            # Out-of-band reply payload: header + buffers ride the reply
            # frame as raw segments (no flat re-encoding, no frame-pickle
            # copy).  snapshot() detaches buffers that alias user-owned
            # values — an actor may mutate a returned array after we
            # queue the reply but before the transport flushes it.
            return ("inline", SerializedPayload(header, views).snapshot())
        oid = ObjectID.for_task_return(spec.task_id, index)
        loop = asyncio.get_running_loop()
        _, tier = await loop.run_in_executor(
            None, self.shm_store.create_serialized, oid, header, views
        )
        # Pipelined oneway (see _put_async): the arena entry is already
        # sealed natively; chunk reads fall back to the arena if the
        # directory seal hasn't landed yet.  An arena-oversized return
        # lands on the disk spill tier (tier == "spill") and is indexed
        # there by the agent; readers fall through shm to the spill file.
        await self.agent.notify(
            "seal_object", {"object_id": oid, "size": size, "tier": tier}
        )
        return ("shm", self.agent_address, size)

    # ------------------------------------------------- streaming generators
    async def _execute_streaming(self, spec: TaskSpec, fn, args, kwargs,
                                 ev_kw) -> dict:
        """Run a (sync or async) generator task, pushing each yielded item
        to the owner as it is produced (reference: streaming-generator
        returns, ray ``task_manager.h`` num_returns="streaming")."""
        caller = self.worker_clients.get(spec.owner_address)
        count = 0
        try:
            if inspect.isasyncgenfunction(fn):
                agen = fn(*args, **kwargs)
                async for item in agen:
                    ret = await self._package_value(spec, item, count)
                    await caller.notify(
                        "stream_item",
                        {"task_id": spec.task_id, "index": count,
                         "ret": ret, "attempt": getattr(spec, "_attempt", 0)},
                    )
                    count += 1
            else:
                gen = fn(*args, **kwargs)
                loop = asyncio.get_running_loop()
                sentinel = object()
                while True:
                    item = await loop.run_in_executor(
                        self._task_executor,
                        lambda: next(gen, sentinel),
                    )
                    if item is sentinel:
                        break
                    ret = await self._package_value(spec, item, count)
                    await caller.notify(
                        "stream_item",
                        {"task_id": spec.task_id, "index": count,
                         "ret": ret, "attempt": getattr(spec, "_attempt", 0)},
                    )
                    count += 1
            self.task_events.record(
                spec.task_id.hex(), spec.name, "FINISHED", **ev_kw
            )
            return {"returns": [], "error": None, "streamed": count}
        except BaseException as e:  # noqa: BLE001
            import traceback as tb

            self.task_events.record(
                spec.task_id.hex(), spec.name, "FAILED", error=repr(e), **ev_kw
            )
            err = TaskError(e, tb.format_exc(), spec.name)
            return {
                "returns": None,
                "error": serialize_to_bytes(err),
                "streamed": count,
            }

    async def _package_returns(self, spec: TaskSpec, result) -> List[tuple]:
        if spec.num_returns == 1:
            values = [result]
        else:
            values = list(result)
            if len(values) != spec.num_returns:
                raise ValueError(
                    f"task {spec.name} declared {spec.num_returns} returns "
                    f"but produced {len(values)}"
                )
        return [
            await self._package_value(spec, value, i)
            for i, value in enumerate(values)
        ]

    def _device_transport_active(self) -> bool:
        return bool(
            self.actor_spec is not None
            and getattr(self.actor_spec, "tensor_transport", "") == "device"
        )

    async def _device_unwrap(self, value):
        """DeviceRefs anywhere in the arg pytree resolve to their resident
        tensors (RDT analog).  Runs ON the worker event loop, so remote
        fetches await the RPC directly — blocking here would deadlock the
        loop.  A fetched tensor lands on this process's card when its owner
        kept it on one."""
        from torch.utils import _pytree as pytree

        from ..collective.device_objects import (
            DeviceRef,
            array_from_fetch_reply,
            device_object_store,
        )

        store = device_object_store()
        leaves, treedef = pytree.tree_flatten(value)
        out = []
        for v in leaves:
            if not isinstance(v, DeviceRef):
                out.append(v)
            elif store.contains(v):
                out.append(store.get_local(v))
                store.last_transfer_path = "local"
            elif v.owner_address:
                client = self.worker_clients.get(v.owner_address)
                reply = await client.call(
                    "device_fetch", {"object_id": v.object_id}
                )
                out.append(array_from_fetch_reply(v, reply))
                store.last_transfer_path = "p2p_rpc"
            else:  # collective-group fallback (owner must serve_fetch)
                out.append(store.fetch(v))
        return pytree.tree_unflatten(out, treedef)

    @staticmethod
    def _device_wrap(value):
        """Tensors anywhere in the return pytree stay on the card;
        DeviceRefs travel instead."""
        import torch
        from torch.utils import _pytree as pytree

        from ..collective.device_objects import device_object_store

        store = device_object_store()
        return pytree.tree_map(
            lambda v: store.put(v) if isinstance(v, torch.Tensor) else v,
            value,
        )

    async def _execute(self, spec: TaskSpec, fn, ticket=None) -> dict:
        from ray_tpu_torch.util.tracing import task_execution_span

        ev_kw = {
            "job_id_hex": spec.job_id.hex(),
            "actor_id_hex": spec.actor_id.hex() if spec.actor_id else "",
        }
        self.task_events.record(spec.task_id.hex(), spec.name, "RUNNING", **ev_kw)
        try:
            with task_execution_span(spec):
                return await self._execute_inner(spec, fn, ev_kw, ticket)
        finally:
            # A wedged pipeline cursor would stall every later call: any
            # path that didn't consume the ticket (coroutine fn, streaming,
            # early error) must release it.
            if ticket is not None:
                self._exec_pipeline.abandon(ticket)

    async def _execute_inner(self, spec: TaskSpec, fn, ev_kw, ticket=None) -> dict:
        # Flight-recorder phase boundaries (each timestamp closes the
        # previous phase): push arrival -> here = queue wait (function
        # fetch + pipeline sequencing), then arg resolution, execution,
        # return packaging.  Recorded only on success — error paths must
        # stay lean, and a failed task's phases would skew the envelope.
        fr_on = GlobalConfig.enable_flight_recorder
        t_start = time.time()
        if spec.actor_id is None and spec.task_id in self._cancelled_tasks:
            # Owner cancelled while this task sat in the executor queue:
            # skip the run, reply with the cancellation (serialized bare —
            # get() raises TaskCancelledError, not a TaskError wrapper).
            self._cancelled_tasks.discard(spec.task_id)
            self.task_events.record(
                spec.task_id.hex(), spec.name, "FAILED",
                error="cancelled", **ev_kw,
            )
            return {
                "returns": None,
                "error": serialize_to_bytes(TaskCancelledError(spec.name)),
            }
        try:
            args, kwargs = await self._resolve_args(spec.args_payload)
            if self._device_transport_active():
                args = await self._device_unwrap(list(args))
                kwargs = await self._device_unwrap(kwargs)
            t_args = time.time()
            self._current_task_name = spec.name
            if spec.streaming:
                if inspect.isgeneratorfunction(fn) or inspect.isasyncgenfunction(fn):
                    reply = await self._execute_streaming(
                        spec, fn, args, kwargs, ev_kw
                    )
                    if fr_on and reply.get("error") is None:
                        t_end = time.time()
                        _fr().record_task_phases(self, spec, (
                            ("queue_wait",
                             getattr(spec, "_recv_ts", t_start), t_start),
                            ("arg_resolution", t_start, t_args),
                            ("execute", t_args, t_end),
                        ))
                    return reply
                # Loud failure beats a consumer hung on a stream that no
                # code path would ever terminate.
                err = TaskError(
                    TypeError(
                        f"{spec.name!r} requested num_returns='streaming' "
                        f"but is not a generator function"
                    ),
                    "",
                    spec.name,
                )
                self.task_events.record(
                    spec.task_id.hex(), spec.name, "FAILED",
                    error="not a generator", **ev_kw,
                )
                return {
                    "returns": None,
                    "error": serialize_to_bytes(err),
                    "streamed": 0,
                }
            loop = asyncio.get_running_loop()
            if asyncio.iscoroutinefunction(fn):
                result = await fn(*args, **kwargs)
            else:
                # copy_context does double duty: the tracing contextvar
                # (and any other context) follows user code into the
                # executor thread, AND each task runs in its own context so
                # contextvars set by user code die with the task instead of
                # leaking into later tasks on the reused pool thread.
                import contextvars as _cv

                _ctx = _cv.copy_context()

                def _guarded_run(*a, **kw):
                    # Re-checked at actual execution start: a cancel that
                    # landed while this task waited behind others in the
                    # pipeline/lane queue still skips the user function.
                    if (
                        spec.actor_id is None
                        and spec.task_id in self._cancelled_tasks
                    ):
                        self._cancelled_tasks.discard(spec.task_id)
                        raise TaskCancelledError(spec.name)
                    return _ctx.run(fn, *a, **kw)

                if ticket is not None:
                    result = await self._exec_pipeline.run_sync(
                        ticket, _guarded_run, *args, **kwargs
                    )
                elif self._lane_pool is not None:
                    # Concurrency lanes: sticky threads + batched
                    # completion flushes (one loop wakeup per burst, not
                    # per call).
                    result = await self._lane_pool.run(
                        _guarded_run, *args, **kwargs
                    )
                else:
                    result = await loop.run_in_executor(
                        self._task_executor,
                        lambda: _guarded_run(*args, **kwargs),
                    )
            if self._device_transport_active():
                result = self._device_wrap(result)
            t_exec = time.time()
            returns = await self._package_returns(spec, result)
            self.task_events.record(
                spec.task_id.hex(), spec.name, "FINISHED", **ev_kw
            )
            if fr_on:
                _fr().record_task_phases(self, spec, (
                    ("queue_wait",
                     getattr(spec, "_recv_ts", t_start), t_start),
                    ("arg_resolution", t_start, t_args),
                    ("execute", t_args, t_exec),
                    ("return_put", t_exec, time.time()),
                ))
            return {"returns": returns, "error": None}
        except BaseException as e:  # noqa: BLE001
            import traceback as tb

            self.task_events.record(
                spec.task_id.hex(), spec.name, "FAILED", error=repr(e), **ev_kw
            )
            if isinstance(e, TaskCancelledError):
                # Not a user-code failure: ship bare so get() raises
                # TaskCancelledError, not a TaskError wrapper.
                return {"returns": None, "error": serialize_to_bytes(e)}
            err = TaskError(e, tb.format_exc(), spec.name)
            return {"returns": None, "error": serialize_to_bytes(err)}

    async def handle_push_task(self, payload, conn):
        spec: TaskSpec = payload["spec"]
        spec._attempt = payload.get("attempt", 0)  # stream notify tagging
        spec._recv_ts = time.time()  # queue-wait phase start
        # At-least-once delivery, exactly-once execution: a transport
        # retry of the same (task, attempt) awaits the original run.
        key = (spec.task_id, spec._attempt)
        fut, owner = self._inflight_replies.claim(
            key, asyncio.get_running_loop()
        )
        if not owner:
            return await asyncio.shield(fut)
        self._pending_exec_tasks.add(spec.task_id)
        try:
            reply = await self._handle_push_task_once(spec)
        except BaseException as e:  # noqa: BLE001
            if not fut.done():
                fut.set_exception(e)
                fut.exception()  # consumed here; mark retrieved
            raise
        finally:
            # Reply (or failure) ends this execution: clear the pending
            # mark AND any unconsumed cancel mark so a re-push of the same
            # task id starts from a clean slate.
            self._pending_exec_tasks.discard(spec.task_id)
            self._cancelled_tasks.discard(spec.task_id)
        if not fut.done():
            fut.set_result(reply)
        return reply

    async def _handle_push_task_once(self, spec: TaskSpec):
        # The ticket MUST be issued before ANY await: ticket order is the
        # pipeline's execution order, so it has to equal push-arrival
        # order.  Allocating it after the function fetch deadlocked a
        # pipelined pair once the LATER task's function was already cached
        # (cache-hit task got the earlier ticket, then suspended forever
        # in _resolve_args waiting for the cache-miss task's output, which
        # sat behind it in the pipeline).
        ticket = self._exec_pipeline.ticket()
        try:
            fn = await self._get_function(spec.function_id)
            if spec.streaming or asyncio.iscoroutinefunction(fn):
                return await self._exec_pipeline.run_coro(
                    ticket, lambda: self._execute(spec, fn)
                )
            return await self._execute(spec, fn, ticket=ticket)
        finally:
            # Idempotent: covers _get_function failures and every
            # non-consuming path so the cursor can never wedge.
            self._exec_pipeline.abandon(ticket)

    async def handle_actor_init(self, payload, conn):
        spec: ActorSpec = payload["spec"]
        try:
            cls = await self._get_function(spec.class_id)
            args, kwargs = await self._resolve_args(spec.ctor_args_payload)
            loop = asyncio.get_running_loop()
            instance = await loop.run_in_executor(
                self._task_executor, lambda: cls(*args, **kwargs)
            )
            self.actor_instance = instance
            self.actor_spec = spec
            self.actor_incarnation = payload.get("incarnation", 0)
            self._actor_exec_lock = asyncio.Semaphore(max(1, spec.max_concurrency))
            if spec.max_concurrency > 1:
                # Overlapping sync methods run on the lane pool (sticky
                # threads, batched completion flushes); the small default
                # _task_executor stays for ctor/streaming/one-off
                # run_in_executor uses — resizing it to max_concurrency
                # would just park N idle threads next to the N lanes.
                self._lane_pool = LanePool(loop, spec.max_concurrency)
            return {"ok": True}
        except BaseException as e:  # noqa: BLE001
            import traceback as tb

            logger.error("actor init failed: %s\n%s", e, tb.format_exc())
            return {"ok": False, "error": f"{e!r}\n{tb.format_exc()}"}

    async def handle_actor_push_task(self, payload, conn):
        spec: TaskSpec = payload["spec"]
        spec._attempt = payload.get("attempt", 0)  # stream notify tagging
        spec._recv_ts = time.time()  # queue-wait phase start
        # Dedup BEFORE the sequence gate: a duplicate push's seq has
        # already been consumed, so re-entering the gate would hang (or,
        # worse, re-execute); it simply awaits the original run's reply.
        key = (spec.task_id, spec._attempt)
        fut, owner = self._inflight_replies.claim(
            key, asyncio.get_running_loop()
        )
        if not owner:
            return await asyncio.shield(fut)
        try:
            reply = await self._handle_actor_push_once(payload, spec)
        except BaseException as e:  # noqa: BLE001
            if not fut.done():
                fut.set_exception(e)
                fut.exception()  # consumed here; mark retrieved
            raise
        if not fut.done():
            fut.set_result(reply)
        return reply

    async def _handle_actor_push_once(self, payload, spec: TaskSpec):
        caller = payload["caller"]
        seq = payload["seq"]
        key = (caller, payload.get("incarnation", 0))
        st = self._actor_seq_state.setdefault(
            key, {"expected": 0, "waiters": {}}
        )
        # In-order execution per caller: wait for our turn.
        while st["expected"] < seq:
            ev = st["waiters"].setdefault(seq, asyncio.Event())
            await ev.wait()

        def advance():
            # Always advance the sequence, even on lookup errors — a wedged
            # sequence would hang every later call from this caller.
            if st["expected"] <= seq:
                st["expected"] = seq + 1
                ev = st["waiters"].pop(seq + 1, None)
                if ev:
                    ev.set()

        try:
            if self.actor_instance is None:
                raise RuntimeError("actor not initialized")
            method_name = getattr(spec, "method_name", spec.name)
            if method_name == "__rtpu_dag_exec_loop__":
                # Compiled-graph execution loop (ray dag/compiled_dag_node.py
                # analog): a long-lived task that reads/writes shm channels
                # instead of per-call RPC.  Dispatched to the dag module with
                # the actor instance bound.
                import functools

                from ..dag.worker_loop import dag_exec_loop

                method = functools.partial(dag_exec_loop, self.actor_instance)
            elif method_name == "__rtpu_exec__":
                # Generic in-actor execution (ray's ``__ray_call__`` analog):
                # first arg is a pickled callable invoked with the actor
                # instance — how out-of-band protocols (collective group
                # init, device-object hooks) run inside user actors without
                # requiring methods on the user class.
                import functools

                from .serialization import loads_function

                def _exec(fn_payload, *a, **kw):
                    return loads_function(fn_payload)(
                        self.actor_instance, *a, **kw
                    )

                method = _exec
            else:
                method = getattr(self.actor_instance, method_name)
            if self.actor_spec is not None and self.actor_spec.max_concurrency > 1:
                # Overlapping execution: the semaphore bounds concurrency,
                # the thread pool provides the parallel lanes.
                async with self._actor_exec_lock:
                    # Advance as soon as execution begins so overlap is
                    # possible.
                    advance()
                    return await self._execute(spec, method)
            # max_concurrency == 1: the exec pipeline IS the exclusion.
            # Ticket before advance() so the next call (released by
            # advance) cannot overtake this one in execution order.
            ticket = self._exec_pipeline.ticket()
            advance()
            if spec.streaming or asyncio.iscoroutinefunction(method):
                try:
                    return await self._exec_pipeline.run_coro(
                        ticket, lambda: self._execute(spec, method)
                    )
                finally:
                    self._exec_pipeline.abandon(ticket)
            return await self._execute(spec, method, ticket=ticket)
        except BaseException as e:  # noqa: BLE001 - report as task error
            from .serialization import serialize_to_bytes as _ser

            return {"returns": None,
                    "error": _ser(TaskError.from_exception(e, spec.name))}
        finally:
            advance()

    def handle_worker_debug(self, payload, conn):
        """Introspection: exec-pipeline cursor + dedup table state."""
        pipe = self._exec_pipeline
        infl = self._inflight_replies
        return {
            "pipeline_next_ticket": pipe._next_ticket if pipe else None,
            "pipeline_next_exec": pipe._next_exec if pipe else None,
            "pipeline_queued": sorted(pipe._items) if pipe else None,
            "inflight_total": len(infl._futs) if infl else None,
            "inflight_pending": (
                [str(k) for k, f in infl._futs.items() if not f.done()]
                if infl else None
            ),
        }

    def handle_obs_pull(self, payload, conn):
        """Node-agent observability pull (heartbeat cadence): drain this
        worker's task-event/span buffers and snapshot its metrics
        registry.  The agent forwards the merged batches to the control
        plane as ONE ``obs_report`` per beat — so per-worker telemetry
        reaches the cluster store without each worker keeping its own
        fast flush timer against the control plane.

        At-least-once: the reply is STAGED here until the agent acks its
        batch_id on a later pull (it acks only after a successful
        obs_report), so a lost reply or failed report re-delivers
        instead of silently dropping the drained events.  Sustained
        delivery failure degrades into oldest-first shedding with the
        normal drop accounting — loss stays explicit."""
        from ..util import metrics as _metrics

        te = self.task_events
        pending = self._obs_pending
        if pending is not None and payload.get("ack") == pending["batch_id"]:
            pending = self._obs_pending = None
        events, profiles = te.drain() if te is not None else ([], [])
        metrics_payload = _metrics.payload_snapshot(only_dirty=True)
        new_content = bool(events or profiles or metrics_payload is not None)
        if pending is not None:
            events = pending["events"] + events
            profiles = pending["profile_events"] + profiles
            if metrics_payload is None:
                metrics_payload = pending["metrics"]
        if te is not None:
            cap = 2 * GlobalConfig.task_events_max_buffer
            if len(events) > cap:
                shed = len(events) - cap
                del events[:shed]
                te._count_dropped(shed)
            if len(profiles) > cap:
                shed = len(profiles) - cap
                shed_rows = profiles[:shed]
                del profiles[:shed]
                te._count_dropped(shed, spans=te._count_spans(shed_rows))
        span_drops = te.num_span_dropped if te is not None else 0
        if not events and not profiles and metrics_payload is None:
            return {"worker_id": self.worker_id.hex(), "batch_id": None,
                    "span_drops": span_drops}
        if pending is not None and not new_content:
            # Pure re-delivery: keep the id so the control plane can
            # drop the duplicate if the first report DID land.
            batch_id = pending["batch_id"]
        else:
            self._obs_batch_seq += 1
            batch_id = self._obs_batch_seq
        self._obs_pending = {
            "batch_id": batch_id,
            "events": events,
            "profile_events": profiles,
            "metrics": metrics_payload,
        }
        return {
            "worker_id": self.worker_id.hex(),
            "batch_id": batch_id,
            "events": events,
            "profile_events": profiles,
            "span_drops": span_drops,
            "metrics_key": f"worker:{self.worker_id.hex()}",
            "metrics": metrics_payload,
        }

    def handle_remediate(self, payload, conn):
        """Remediation directive fan-in (node-agent broadcast): apply
        each directive against THIS process's local actuators — e.g. a
        ``collective_reprobe`` arms the process-wide tuner so every
        group member re-probes in lockstep (util/remediation.py)."""
        from ..util import remediation

        return {
            "worker_id": self.worker_id.hex(),
            "results": [
                remediation.apply_local_directive(d)
                for d in payload.get("directives", ())
            ],
        }

    async def handle_prepare_evict(self, payload, conn):
        """Checkpoint-then-evict fan-in: the node agent warns this worker
        that its placement-group bundle is about to be reclaimed.  Two
        checkpoint channels, both best-effort: process-local eviction
        hooks (``core.eviction``, for non-actor workloads), and the
        hosted actor's ``prepare_evict()`` method — if it returns bytes
        they are parked in the cluster KV under the actor's id, where the
        next incarnation (or the driver's restart machinery) can pick
        them up.  Failures never block the eviction; the workload then
        falls back to its last driver-side checkpoint."""
        from . import eviction

        cause = payload.get("cause", "")
        hooks = eviction.run_eviction_hooks(cause)
        checkpointed = hooks > 0
        inst = getattr(self, "actor_instance", None)
        prepare = getattr(inst, "prepare_evict", None) if inst else None
        if callable(prepare):
            try:
                blob = prepare()
                if isinstance(blob, (bytes, bytearray)):
                    await self.cp.call(
                        "kv_put",
                        {
                            "namespace": "eviction",
                            "key": self.actor_spec.actor_id.hex(),
                            "value": bytes(blob),
                        },
                    )
                checkpointed = True
            except Exception as e:  # noqa: BLE001 — evict proceeds anyway
                logger.warning("prepare_evict checkpoint failed: %s", e)
        return {"checkpointed": checkpointed, "hooks": hooks}

    def handle_pipeline_push(self, payload, conn):
        """Stage-boundary p2p delivery (train.pipeline activations/grads):
        park the still-serialized payload in the local mailbox for the
        consuming actor thread.  Lane-safe — one dict insert + notify."""
        from ..collective.p2p import deposit_push

        deposit_push(payload["edge"], payload["seq"], payload["data"],
                     payload.get("trace"))
        return True

    def handle_device_fetch(self, payload, conn):
        """Point-to-point DeviceRef resolution (RDT analog): serialize the
        resident tensor to the requester (one host hop; a CUDA tensor is
        copied to the host here and to the requester's card there).  The
        reply rides the zero-copy path: the host bytes go out as an
        out-of-band frame segment (no flat copy), and the requester reads
        them straight from the receive buffer — this is the prefill→decode
        KV-cache handoff, so the copies this saves are per KV block."""
        from ..collective.device_objects import device_object_store
        from .serialization import tensor_host_bytes

        store = device_object_store()
        tensor = store._objects.get(payload["object_id"])
        if tensor is None:
            return {"found": False}
        raw = memoryview(tensor_host_bytes(tensor))
        return {"found": True, "data": oob_bytes(raw),
                "device": tensor.device.type}

    def handle_device_free(self, payload, conn):
        """Owner-side release of one reference (refcounted residency)."""
        from ..collective.device_objects import device_object_store

        store = device_object_store()
        oid = payload["object_id"]
        with store._lock:
            if oid not in store._objects:
                return False
            store._refcounts[oid] -= 1
            if store._refcounts[oid] <= 0:
                del store._objects[oid]
                del store._refcounts[oid]
                return True
            return False

    def handle_device_retain(self, payload, conn):
        from ..collective.device_objects import device_object_store

        store = device_object_store()
        oid = payload["object_id"]
        with store._lock:
            if oid not in store._objects:
                raise KeyError(f"device object {oid} not resident")
            store._refcounts[oid] += 1
            return store._refcounts[oid]

    def handle_device_refcount(self, payload, conn):
        from ..collective.device_objects import device_object_store

        store = device_object_store()
        with store._lock:
            return store._refcounts.get(payload["object_id"], 0)

    def handle_ping(self, payload, conn):
        return "pong"

    def handle_exit_worker(self, payload, conn):
        logger.info("worker exiting on request")

        async def _graceful_exit():
            # Flush the final task-event/metrics window before dying — a
            # short-lived worker must not take its last counters with it.
            try:
                await asyncio.wait_for(self._flush_observability(), timeout=2)
            except BaseException:  # raylint: waive[RTL003] exit must proceed regardless
                pass
            os._exit(0)

        loop = asyncio.get_running_loop()
        # 50 ms grace so this RPC's reply reaches the wire first; the 3 s
        # backstop timer preserves the old guarantee that exit_worker
        # ALWAYS kills the process — even if the flush task is cancelled
        # or the loop stops mid-flush, a timer callback still fires.
        threading.Timer(3.0, os._exit, args=(0,)).start()
        loop.call_later(0.05, lambda: loop.create_task(_graceful_exit()))
        return True

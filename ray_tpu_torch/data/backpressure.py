"""Per-operator resource budgets and backpressure policies.

Reference: ray ``python/ray/data/_internal/execution/resource_manager.py:47``
(per-operator memory budgets from the shared object-store budget) and
``backpressure_policy/backpressure_policy.py:14`` (pluggable launch gates).

Here each streaming operator node consults its ``OpResourceState`` before
launching a task: the concurrency-cap policy is the round-1 behavior, and
the memory-budget policy bounds *estimated object-store bytes in flight*
(average completed output size × outstanding tasks) so a stage producing
huge blocks throttles instead of flooding /dev/shm — which matters more
here than in the reference because the node arena is a fixed-size mmap.

Under the operator-graph scheduler (``streaming.py``),
``on_output_consumed`` fires at task COMPLETION (harvest), not at
downstream consume: RUNNING tasks are the memory model's in-flight set,
while completed-but-unconsumed blocks are bounded separately by the
per-op output queue depth (``data_output_queue_depth``).
"""

from __future__ import annotations

from typing import List, Optional

from ..core.config import GlobalConfig


class OpResourceState:
    """Live accounting for one operator (ResourceManager per-op slice)."""

    def __init__(self, name: str):
        self.name = name
        self.outstanding = 0  # launched, not yet consumed downstream
        self.completed_tasks = 0
        # The size average only counts outputs whose size was actually
        # observed — unknown-size completions must not dilute it toward 0
        # (which would disable the memory policy exactly when it matters).
        self.sized_tasks = 0
        self.completed_bytes = 0

    @property
    def avg_output_bytes(self) -> float:
        if self.sized_tasks == 0:
            return 0.0
        return self.completed_bytes / self.sized_tasks

    @property
    def estimated_inflight_bytes(self) -> float:
        return self.avg_output_bytes * self.outstanding

    def on_launch(self):
        self.outstanding += 1

    def on_output_consumed(self, nbytes: Optional[int]):
        self.outstanding -= 1
        self.completed_tasks += 1
        if nbytes:
            self.sized_tasks += 1
            self.completed_bytes += nbytes


class BackpressurePolicy:
    """Gate for launching one more task of an operator."""

    def can_launch(self, op: OpResourceState) -> bool:  # pragma: no cover
        raise NotImplementedError


class ConcurrencyCapPolicy(BackpressurePolicy):
    def __init__(self, cap: Optional[int] = None):
        self.cap = cap

    def can_launch(self, op: OpResourceState) -> bool:
        cap = self.cap if self.cap is not None else GlobalConfig.data_max_tasks_per_op
        return op.outstanding < cap


class MemoryBudgetPolicy(BackpressurePolicy):
    """Throttle when estimated in-flight output bytes exceed the op budget.
    Always admits at least one task (liveness) and only engages once an
    average output size is known."""

    def __init__(self, budget_bytes: Optional[int] = None):
        self.budget_bytes = budget_bytes

    def can_launch(self, op: OpResourceState) -> bool:
        budget = (
            self.budget_bytes
            if self.budget_bytes is not None
            else GlobalConfig.data_memory_budget_per_op_bytes
        )
        if budget <= 0 or op.outstanding == 0 or op.avg_output_bytes == 0:
            return True
        return op.estimated_inflight_bytes + op.avg_output_bytes <= budget


def default_policies() -> List[BackpressurePolicy]:
    return [ConcurrencyCapPolicy(), MemoryBudgetPolicy()]


class ResourceManager:
    """Pipeline-level budget divider (reference
    ``resource_manager.py:47``): one shared object-store budget split
    evenly across the plan's concurrently-running operators, so a deep
    pipeline cannot claim N × the per-op default.  (The reference also
    re-reserves dynamically by op demand; the even split is its starting
    allocation and the behavior here.)"""

    def __init__(self, n_ops: int, total_bytes: Optional[int] = None):
        if total_bytes is None:
            total_bytes = GlobalConfig.data_memory_budget_total_bytes
        if total_bytes <= 0:  # derive from the node's shm arena budget
            total_bytes = int(
                GlobalConfig.object_store_memory_bytes
                * GlobalConfig.data_memory_budget_fraction
            )
        self.total_bytes = total_bytes
        self.per_op_bytes = max(1, total_bytes // max(1, n_ops))

    def policies_for_op(self) -> List[BackpressurePolicy]:
        # The explicit per-op knob stays authoritative when tighter than
        # this pipeline's even split — the shared budget only ever
        # SHRINKS an op's allowance (deep plan), never relaxes it.
        per_op = self.per_op_bytes
        knob = GlobalConfig.data_memory_budget_per_op_bytes
        if knob > 0:
            per_op = min(per_op, knob)
        return [
            ConcurrencyCapPolicy(),
            MemoryBudgetPolicy(per_op),
        ]


def can_launch(op: OpResourceState, policies: List[BackpressurePolicy]) -> bool:
    return all(p.can_launch(op) for p in policies)


def ref_size_if_known(ref) -> Optional[int]:
    """Owner-side size of a completed object (no data fetch)."""
    try:
        worker = ref._worker
        obj = worker.owned.get(ref.id)
        return obj.size if obj is not None else None
    except Exception:
        return None

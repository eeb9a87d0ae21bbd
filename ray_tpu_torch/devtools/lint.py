"""raylint — runtime-invariant static analysis for the ray_tpu_torch codebase.

The runtime is a multi-threaded Python system whose concurrency and
error-handling invariants (no blocking under a lock, no silent exception
swallowing, bounded waits so overload degradation can engage) were
previously enforced only by convention.  This analyzer makes them
mergeable-or-not, the role TSAN/clang-tidy wiring plays for the reference
runtime's C++ core.

v2 grows the file-local checks into a package-wide analysis: every lint
run builds a module-resolved call graph plus per-function effect
summaries (attribute write-sets, lock-acquisition context, blocking-call
sets, collective-call sets) and propagates them transitively, so the
contracts the multi-lane RPC service, the collective autotuner and the
RPC wire format rest on are *checked*, not prose:

  RTL001 no-blocking-under-lock   blocking calls inside ``with <lock>:``
  RTL002 thread-hygiene           Thread() must pass daemon= and name=
  RTL003 swallowed-exception      ``except Exception: pass`` must justify
  RTL004 metric-name-registry     ray_tpu_* names declared once + documented
  RTL005 async-blocking           no time.sleep / blocking get in async def
  RTL006 untimed-wait             Condition/Event.wait() & queue get need
                                  timeouts on runtime paths
  RTL007 lane-safety              a ``LANE_SAFE_METHODS`` handler — and
                                  everything it transitively calls — may
                                  mutate state only under a lock /
                                  ``shard_lock`` accessor, through the
                                  OwnerTable contract, or inside a
                                  ``ForwardToPrimary`` punt
  RTL008 spmd-lockstep            collective ops / tuner observe-commit
                                  calls must not sit under control flow
                                  conditioned on per-member state
                                  (rank, hostname, env, time, random)
  RTL009 rpc-wire-contract        string method names at ``.call``/
                                  ``.notify`` sites must resolve to a real
                                  ``handle_*`` on the matching service;
                                  ``LANE_SAFE_METHODS`` entries must name
                                  existing sync handlers; notify-only
                                  (oneway) handlers must not return values
  RTL010 async-blocking-transitive RTL005 through the call graph: a
                                  blocking call N frames below an async
                                  handler still stalls the event loop

Meta diagnostics (never waivable): RTL000 parse-error, RTL011
waiver-expired (a waiver whose ``expires`` date has passed is a lint
error, and it stops suppressing its site).

Usage::

    python -m ray_tpu_torch.devtools.lint [paths...]
    python -m ray_tpu_torch.devtools.lint --changed     # mtime+hash cache
    python -m ray_tpu_torch.devtools.lint --json
    python -m ray_tpu_torch.devtools.lint --list-rules

With no paths, lints the ``ray_tpu_torch`` package this module was imported
from.  Exit status: 0 clean, 1 unwaived violations, 2 usage/parse error.

Waivers: a checked-in ``lint_waivers.toml`` next to this module
grandfathers specific sites (each entry carries a reason and date, and
optionally an ``expires = "YYYY-MM-DD"`` deadline), and an inline
``# raylint: waive[RTL00X] why`` comment on the flagged line waives one
site in place.  Unwaived violations fail the run; unused waiver entries
are reported so the file stays minimal.

Soundness notes (documented limits, see docs/lint.md): call edges into
``getattr``-style dynamic dispatch, nested ``def``/``lambda`` bodies and
unresolvable imports fall back to *unknown* and are not traversed;
RTL008 flags collectives lexically under a per-member condition, not
divergence via early return.  The dynamic companion
(``RAY_TPU_TORCH_DEBUG_LANES=1``, ``ray_tpu_torch/util/debug_lanes.py``) covers the
same lane contract from the runtime side.
"""

from __future__ import annotations

import argparse
import ast
import hashlib
import json
import os
import re
import sys
import time
from typing import Dict, List, Optional, Sequence, Set, Tuple

RULES: Dict[str, str] = {
    "RTL000": "parse-error",  # not waivable: an unparseable file is never OK
    "RTL001": "no-blocking-under-lock",
    "RTL002": "thread-hygiene",
    "RTL003": "swallowed-exception",
    "RTL004": "metric-name-registry",
    "RTL005": "async-blocking",
    "RTL006": "untimed-wait",
    "RTL007": "lane-safety",
    "RTL008": "spmd-lockstep",
    "RTL009": "rpc-wire-contract",
    "RTL010": "async-blocking-transitive",
    "RTL011": "waiver-expired",  # not waivable: meta-rule about the waiver file
}

UNWAIVABLE = frozenset({"RTL000", "RTL011"})

# Rules whose scope is "runtime paths": the concurrency-sensitive layers.
# Files outside a ray_tpu_torch package (e.g. test fixture snippets) are treated
# as runtime scope so every rule is exercisable on a standalone file.
RUNTIME_SCOPE_PREFIXES = (
    "core/", "serve/", "util/", "dag/", "collective/", "autoscaler/",
)
RUNTIME_SCOPE_FILES = ("dashboard.py",)

_LOCK_NAME_RE = re.compile(
    r"(^|_)(lock|locks|cv|cond|condition|mutex)(_|$)|lock$", re.IGNORECASE
)
_QUEUE_NAME_RE = re.compile(
    r"(^|_)(q|queue|queues|chan|channel|inbox|mailbox)(_|$)|queue$",
    re.IGNORECASE,
)
# The package's own name is no metric: ``ray_tpu_torch`` alone (a module
# path, a log directory) is skipped, while ``ray_tpu_torch_*`` is checked.
_METRIC_NAME_RE = re.compile(r"ray_tpu_(?!torch\b)[a-z0-9_]+")
_WAIVE_COMMENT_RE = re.compile(
    r"#\s*raylint:\s*waive\[([A-Z0-9,\s]+)\]"
)
_DATE_RE = re.compile(r"^\d{4}-\d{2}-\d{2}$")

# --- interprocedural-rule knobs ------------------------------------------
# Modules that ARE the mutation contract: lane-side writes inside them are
# by-design (OwnerTable's per-shard locks / documented GIL-atomic
# telemetry), so RTL007 traversal stops at their boundary.
CONTRACT_MODULES = frozenset({"core.owner_table"})
# Attribute types whose mutating methods are the contract (per-shard locks
# live inside): `self.owned.pop(...)` is sanctioned, `self.owned[k] = v`
# still must hold shard_lock.
CONTRACT_TYPES = frozenset({"OwnerTable"})
# RPC-internal frame names that are not handler-dispatched methods.
PROTOCOL_METHODS = frozenset({"__hello__", "__goodbye__", "__batch__",
                              "R", "E"})
# Container-mutating method names treated as writes for RTL007.
_MUTATOR_METHODS = frozenset({
    "append", "appendleft", "add", "pop", "popleft", "update", "setdefault",
    "remove", "discard", "clear", "extend", "insert",
})
# Collective operations (SPMD lockstep contract, RTL008).
_COLLECTIVE_ATTRS = frozenset({
    "allreduce", "all_reduce", "allgather", "all_gather", "reducescatter",
    "reduce_scatter", "alltoall", "all_to_all", "psum", "pmean",
})
# Lockstep-sensitive tuner methods (selection depends ONLY on the
# per-bucket call sequence — a skipped observe() desynchronizes the
# replicated decision table).
_TUNER_METHODS = frozenset({"observe", "select", "commit", "_commit",
                            "force_reprobe", "select_for_group"})
_MEMBER_NAME_RE = re.compile(
    r"rank|host_?name|member|process_index|world_rank", re.IGNORECASE
)
_MEMBER_CALLS = frozenset({
    "os.getenv", "socket.gethostname", "platform.node",
    "time.time", "time.monotonic", "time.perf_counter", "time.time_ns",
})
_MEMBER_CALL_PREFIXES = ("random.", "uuid.", "secrets.")


class Violation:
    __slots__ = ("rule", "path", "line", "col", "message", "waived",
                 "waive_source")

    def __init__(self, rule: str, path: str, line: int, col: int,
                 message: str):
        self.rule = rule
        self.path = path
        self.line = line
        self.col = col
        self.message = message
        self.waived = False
        self.waive_source = ""

    def render(self) -> str:
        tag = f" [waived: {self.waive_source}]" if self.waived else ""
        return (f"{self.path}:{self.line}:{self.col}: {self.rule} "
                f"{RULES[self.rule]}: {self.message}{tag}")

    def to_dict(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "col": self.col, "message": self.message,
                "waived": self.waived, "waive_source": self.waive_source}

    @classmethod
    def from_dict(cls, d: dict) -> "Violation":
        v = cls(d["rule"], d["path"], d["line"], d["col"], d["message"])
        v.waived = bool(d.get("waived"))
        v.waive_source = d.get("waive_source", "")
        return v


# --------------------------------------------------------------- waivers
class WaiverError(Exception):
    pass


class Waiver:
    __slots__ = ("rules", "path", "contains", "line", "reason", "date",
                 "expires", "used", "srcline")

    def __init__(self, rules: Sequence[str], path: str,
                 contains: Optional[str], line: Optional[int],
                 reason: str, date: str, expires: Optional[str] = None,
                 srcline: int = 0):
        self.rules = tuple(rules)
        self.path = path.replace(os.sep, "/")
        self.contains = contains
        self.line = line
        self.reason = reason
        self.date = date
        self.expires = expires
        self.used = False
        self.srcline = srcline

    def expired(self, today: Optional[str] = None) -> bool:
        if self.expires is None:
            return False
        # ISO dates compare correctly as strings.
        return self.expires <= (today or time.strftime("%Y-%m-%d"))

    def matches(self, v: Violation, source_line: str) -> bool:
        if v.rule not in self.rules:
            return False
        # Suffix match with a path-component boundary: a waiver for
        # "core/rpc.py" must not also cover "score/rpc.py".
        vpath = v.path.replace(os.sep, "/")
        if vpath != self.path and not vpath.endswith("/" + self.path):
            return False
        if self.line is not None and self.line != v.line:
            return False
        if self.contains is not None and self.contains not in source_line:
            return False
        return True


def parse_waivers(path: str) -> List[Waiver]:
    """Parse the waiver file: a TOML subset (``[[waiver]]`` tables of
    string/int assignments) — parsed by hand because the runtime targets
    interpreters without ``tomllib`` and must not grow dependencies."""
    waivers: List[Waiver] = []
    current: Optional[dict] = None
    current_start = 0

    def finish(entry: Optional[dict], at_line: int):
        if entry is None:
            return
        missing = [k for k in ("rule", "path", "reason", "date")
                   if k not in entry]
        if missing:
            raise WaiverError(
                f"{path}: waiver ending at line {at_line} is missing "
                f"required field(s): {', '.join(missing)}"
            )
        rules = [r.strip() for r in entry["rule"].split(",") if r.strip()]
        unknown = [r for r in rules if r not in RULES]
        if unknown:
            raise WaiverError(
                f"{path}: waiver ending at line {at_line} names unknown "
                f"rule(s): {', '.join(unknown)}"
            )
        line_no = entry.get("line")
        if line_no is not None:
            line_no = int(line_no)
        expires = entry.get("expires")
        if expires is not None and not _DATE_RE.match(str(expires)):
            raise WaiverError(
                f"{path}: waiver ending at line {at_line} has malformed "
                f"expires date {expires!r} (want YYYY-MM-DD)"
            )
        waivers.append(Waiver(rules, entry["path"], entry.get("contains"),
                              line_no, entry["reason"], entry["date"],
                              expires, current_start))

    with open(path, encoding="utf-8") as f:
        i = 0
        for i, raw in enumerate(f, start=1):
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            if line == "[[waiver]]":
                finish(current, i)
                current = {}
                current_start = i
                continue
            m = re.match(
                r'^([A-Za-z_]+)\s*=\s*(?:"((?:[^"\\]|\\.)*)"|(\d+))\s*'
                r"(?:#.*)?$", line,
            )
            if m is None or current is None:
                raise WaiverError(
                    f"{path}:{i}: unparseable waiver line: {line!r} "
                    "(expected [[waiver]] tables of key = \"string\" or "
                    "key = integer assignments)"
                )
            key, s_val, i_val = m.group(1), m.group(2), m.group(3)
            current[key] = (
                int(i_val) if i_val is not None
                else s_val.encode().decode("unicode_escape")
            )
        finish(current, i if waivers or current else 0)
    return waivers


# ------------------------------------------------------------ AST helpers
def _terminal_name(node: ast.AST) -> Optional[str]:
    """`self._tier_lock` -> "_tier_lock", `lock` -> "lock"."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _dotted(node: ast.AST) -> Optional[str]:
    """`time.sleep` -> "time.sleep"; gives up on non-trivial bases."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return f"{base}.{node.attr}" if base else None
    return None


def _is_lock_expr(node: ast.AST) -> bool:
    name = _terminal_name(node)
    if name is None:
        if isinstance(node, ast.Call):
            dn = _dotted(node.func) or ""
            last = dn.split(".")[-1]
            # threading.Lock() acquired inline, and lock-returning
            # accessors (`with self.owned.shard_lock(oid):` — the
            # OwnerTable lane-side mutation contract).
            return (last in ("Lock", "RLock", "Condition")
                    or bool(_LOCK_NAME_RE.search(last)))
        return False
    return bool(_LOCK_NAME_RE.search(name))


def _has_kw(call: ast.Call, name: str) -> bool:
    return any(kw.arg == name for kw in call.keywords)


def _body_nodes_no_nested_defs(body: Sequence[ast.stmt]):
    """Yield every node in ``body`` without descending into nested
    function/class definitions (their execution escapes the lock/async
    context being analyzed)."""
    stack: List[ast.AST] = list(body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _blocking_call_reason(node: ast.Call) -> Optional[str]:
    """If ``node`` is one of the calls RTL001/RTL005 forbid, say why."""
    dn = _dotted(node.func)
    if dn == "time.sleep":
        return "time.sleep() blocks the holder"
    if dn is not None and (dn.startswith("subprocess.")):
        return f"{dn}() forks/blocks on a child process"
    if dn in ("ray_tpu_torch.get", "ray.get"):
        return f"{dn}() is a distributed blocking get"
    if isinstance(node.func, ast.Attribute) and node.func.attr == "result":
        return ".result() blocks on a future"
    return None


def _is_untimed_wait(node: ast.Call) -> bool:
    if not isinstance(node.func, ast.Attribute) or _has_kw(node, "timeout"):
        return False
    if node.func.attr == "wait":
        return not node.args
    if node.func.attr == "wait_for":
        # Condition.wait_for(predicate) loops an untimed wait() inside;
        # asyncio.wait_for(aw, t) carries its timeout as 2nd positional.
        return len(node.args) <= 1
    return False


def _is_untimed_queue_get(node: ast.Call) -> bool:
    if not (isinstance(node.func, ast.Attribute)
            and node.func.attr == "get"):
        return False
    recv = _terminal_name(node.func.value)
    if recv is None or not _QUEUE_NAME_RE.search(recv):
        return False
    if _has_kw(node, "timeout"):
        return False
    # Non-blocking try-gets raise Empty immediately — bounded by nature.
    for kw in node.keywords:
        if (kw.arg == "block" and isinstance(kw.value, ast.Constant)
                and kw.value.value is False):
            return False
    if (node.args and isinstance(node.args[0], ast.Constant)
            and node.args[0].value is False):
        return False
    # q.get() / q.get(True) / q.get(block=True) — all unbounded.
    positional_timeout = len(node.args) >= 2
    return not positional_timeout


def _member_cond_desc(test: ast.AST) -> Optional[str]:
    """If a control-flow test depends on per-member state (rank/hostname/
    env/time/random), describe the dependency; else None (RTL008)."""
    for node in ast.walk(test):
        if isinstance(node, (ast.Name, ast.Attribute)):
            name = _terminal_name(node)
            if name == "environ":
                return "os.environ"
            if name and _MEMBER_NAME_RE.search(name):
                return name
        elif isinstance(node, ast.Call):
            dn = _dotted(node.func) or ""
            if dn in _MEMBER_CALLS:
                return f"{dn}()"
            if dn.startswith(_MEMBER_CALL_PREFIXES):
                return f"{dn}()"
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr in ("gethostname", "getenv"):
                return f"{node.func.attr}()"
    return None


def _collective_desc(node: ast.Call) -> Optional[str]:
    """Name of the collective / tuner-lockstep operation, or None."""
    if isinstance(node.func, ast.Attribute):
        attr = node.func.attr
        recv = _terminal_name(node.func.value) or ""
        if attr in _COLLECTIVE_ATTRS:
            # pubsub/event "broadcast"-style fan-outs are not SPMD
            # collectives; only comm-group receivers count for ambiguous
            # names, while unambiguous op names always count.
            return f"{recv}.{attr}" if recv else attr
        if attr == "broadcast" and ("group" in recv or "comm" in recv
                                    or "mesh" in recv):
            return f"{recv}.{attr}"
        if attr in _TUNER_METHODS and "tuner" in recv.lower():
            return f"{recv}.{attr}"
        if attr == "select_for_group":
            return attr
    elif isinstance(node.func, ast.Name):
        if node.func.id in _COLLECTIVE_ATTRS \
                or node.func.id == "select_for_group":
            return node.func.id
    return None


# ------------------------------------------------------------- the checker
class FileChecker(ast.NodeVisitor):
    def __init__(self, path: str, source: str, runtime_scope: bool,
                 declared_metrics: Set[str], registry_file: bool):
        self.path = path
        self.source_lines = source.splitlines()
        self.runtime_scope = runtime_scope
        self.declared_metrics = declared_metrics
        self.registry_file = registry_file
        self.violations: List[Violation] = []
        self._awaited: Set[int] = set()
        self._async_depth = 0
        self._thread_ctors: Set[str] = {"threading.Thread", "Thread"}

    # -- plumbing ---------------------------------------------------------
    def check(self, tree: Optional[ast.AST] = None) -> List[Violation]:
        if tree is None:
            try:
                tree = ast.parse("\n".join(self.source_lines),
                                 filename=self.path)
            except SyntaxError as e:
                self._add("RTL000", e.lineno or 1, 0,
                          f"file does not parse: {e.msg}")
                return self.violations
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                # `import threading as _t` -> match `_t.Thread(...)` too.
                for alias in node.names:
                    if alias.name == "threading" and alias.asname:
                        self._thread_ctors.add(f"{alias.asname}.Thread")
            elif isinstance(node, ast.ImportFrom):
                # `from threading import Thread as Thr` -> match `Thr(...)`.
                if node.module == "threading":
                    for alias in node.names:
                        if alias.name == "Thread":
                            self._thread_ctors.add(
                                alias.asname or alias.name
                            )
            elif isinstance(node, ast.Await):
                self._awaited.add(id(node.value))
            elif isinstance(node, ast.Call):
                # `asyncio.wait_for(ev.wait(), timeout)` bounds the inner
                # wait — exempt its arguments from the untimed-wait rule.
                dn = _dotted(node.func) or ""
                if dn.split(".")[-1] == "wait_for":
                    for arg in node.args:
                        self._awaited.add(id(arg))
        self.visit(tree)
        return self.violations

    def _add(self, rule: str, line: int, col: int, message: str):
        self.violations.append(Violation(rule, self.path, line, col, message))

    def source_line(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.source_lines):
            return self.source_lines[lineno - 1]
        return ""

    # -- RTL001 -----------------------------------------------------------
    def _check_with(self, node):
        if not self.runtime_scope:
            return
        lock_items = [
            item for item in node.items
            if _is_lock_expr(item.context_expr)
        ]
        if not lock_items:
            return
        lock_desc = _terminal_name(lock_items[0].context_expr) or "lock"
        for inner in _body_nodes_no_nested_defs(node.body):
            if not isinstance(inner, ast.Call):
                continue
            reason = _blocking_call_reason(inner)
            if reason is None and _is_untimed_wait(inner):
                reason = "untimed .wait() parks the thread with the lock" \
                         " context in scope"
            if reason is not None:
                self._add(
                    "RTL001", inner.lineno, inner.col_offset,
                    f"blocking call inside `with {lock_desc}:` — {reason}; "
                    "move it outside the critical section",
                )

    def visit_With(self, node: ast.With):
        self._check_with(node)
        self.generic_visit(node)

    # -- RTL002 -----------------------------------------------------------
    def visit_Call(self, node: ast.Call):
        dn = _dotted(node.func) or ""
        if dn in self._thread_ctors:
            missing = [kw for kw in ("daemon", "name")
                       if not _has_kw(node, kw)]
            if missing:
                self._add(
                    "RTL002", node.lineno, node.col_offset,
                    "threading.Thread(...) must set "
                    f"{' and '.join(m + '=' for m in missing)} explicitly "
                    "(unnamed/implicit-daemon threads are undebuggable "
                    "and can block interpreter exit)",
                )
        # -- RTL005 / RTL006 (call-shaped rules) --------------------------
        if self.runtime_scope:
            if self._async_depth > 0:
                reason = _blocking_call_reason(node)
                if reason is not None and not dn.startswith("subprocess."):
                    # subprocess is RTL001's concern; async bodies care
                    # about anything that parks the event loop thread.
                    self._add(
                        "RTL005", node.lineno, node.col_offset,
                        f"blocking call in async def — {reason}; the event "
                        "loop (and every coroutine on it) stalls. Use the "
                        "async equivalent or run_in_executor",
                    )
            if id(node) not in self._awaited:
                if _is_untimed_wait(node):
                    self._add(
                        "RTL006", node.lineno, node.col_offset,
                        "untimed .wait(): a lost notify or wedged peer "
                        "hangs this thread forever — pass a timeout and "
                        "re-check the predicate",
                    )
                elif _is_untimed_queue_get(node):
                    self._add(
                        "RTL006", node.lineno, node.col_offset,
                        "unbounded queue get(): pass timeout= so overload "
                        "degrades into a timeout error instead of a hang",
                    )
        self.generic_visit(node)

    # -- RTL003 -----------------------------------------------------------
    def visit_ExceptHandler(self, node: ast.ExceptHandler):
        if self.runtime_scope and self._is_broad_handler(node):
            body = [
                stmt for stmt in node.body
                if not (isinstance(stmt, ast.Expr)
                        and isinstance(stmt.value, ast.Constant)
                        and isinstance(stmt.value.value, str))
            ]
            if len(body) == 1 and isinstance(body[0], ast.Pass):
                self._add(
                    "RTL003", node.lineno, node.col_offset,
                    "broad except with a pass-only body swallows every "
                    "failure silently — log it, count it via "
                    "util/metrics.py, or waive with a justification",
                )
        self.generic_visit(node)

    @staticmethod
    def _is_broad_handler(node: ast.ExceptHandler) -> bool:
        if node.type is None:
            return True
        types = (node.type.elts if isinstance(node.type, ast.Tuple)
                 else [node.type])
        for t in types:
            name = _terminal_name(t)
            if name in ("Exception", "BaseException"):
                return True
        return False

    # -- RTL004 -----------------------------------------------------------
    def visit_Constant(self, node: ast.Constant):
        if (isinstance(node.value, str)
                and not self.registry_file
                and _METRIC_NAME_RE.fullmatch(node.value)
                and node.value not in self.declared_metrics):
            self._add(
                "RTL004", node.lineno, node.col_offset,
                f"metric name {node.value!r} is not declared in "
                "ray_tpu_torch/util/metric_registry.py — declare it there (and "
                "document it in docs/observability.md), then import the "
                "constant",
            )
        self.generic_visit(node)

    # -- async tracking (RTL005) ------------------------------------------
    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef):
        self._async_depth += 1
        self.generic_visit(node)
        self._async_depth -= 1

    def visit_FunctionDef(self, node: ast.FunctionDef):
        # A sync def nested in an async def runs on its own thread/stack.
        saved, self._async_depth = self._async_depth, 0
        self.generic_visit(node)
        self._async_depth = saved

    def visit_Lambda(self, node: ast.Lambda):
        # Same: a lambda handed to run_in_executor executes off-loop.
        saved, self._async_depth = self._async_depth, 0
        self.generic_visit(node)
        self._async_depth = saved

    def visit_AsyncWith(self, node: ast.AsyncWith):
        # `async with lock:` is an asyncio lock — blocking calls under it
        # stall the loop, which RTL005 already reports per call site.
        self.generic_visit(node)


# =================================================================
# v2: per-function effect summaries + module-resolved call graph
# =================================================================
def _module_name(path: str) -> str:
    rel = _package_relative(path)
    if rel is None:
        return os.path.splitext(os.path.basename(path))[0]
    return os.path.splitext(rel)[0].replace("/", ".")


class _FunctionScanner:
    """Collects one function's effect summary: call edges, attribute
    write-sites (with lock / ForwardToPrimary context), blocking calls and
    collective calls — without descending into nested defs/lambdas, whose
    execution escapes the context being analyzed (a ``ForwardToPrimary``
    factory runs on the primary loop; a ``run_in_executor`` lambda runs
    off-loop)."""

    def __init__(self, module: str, cls: Optional[str], path: str,
                 call_sites: List[dict]):
        self.module = module
        self.cls = cls
        self.path = path
        self.call_sites = call_sites  # module-level RTL009 site list
        self.lock_depth = 0
        self.forward_depth = 0
        self.cond_stack: List[Optional[str]] = []
        self.aliases: Dict[str, str] = {}  # local name -> self attr it views

    def scan(self, node) -> dict:
        self.info = {
            "name": node.name,
            "cls": self.cls,
            "module": self.module,
            "path": self.path,
            "lineno": node.lineno,
            "is_async": isinstance(node, ast.AsyncFunctionDef),
            "calls": [],
            "writes": [],
            "blocking": [],
            "collectives": [],
            "value_returns": [],
            "dynamic_calls": 0,
        }
        for stmt in node.body:
            self._stmt(stmt)
        return self.info

    # -- context helpers --------------------------------------------------
    def _member_cond(self) -> Optional[str]:
        for cond in reversed(self.cond_stack):
            if cond is not None:
                return cond
        return None

    def _self_root(self, node) -> Optional[str]:
        """First attribute above ``self`` in an access chain, following
        one level of local aliasing (`job = self.jobs.get(..)` makes
        writes through `job` writes to `self.jobs`)."""
        cur = node
        for _ in range(32):
            if isinstance(cur, ast.Attribute):
                base = cur.value
                if isinstance(base, ast.Name):
                    if base.id == "self":
                        return cur.attr
                    return self.aliases.get(base.id)
                cur = base
            elif isinstance(cur, ast.Subscript):
                cur = cur.value
            elif isinstance(cur, ast.Call):
                f = cur.func
                # Only accessor methods return *views* into the shared
                # container; anything else (public_info(), copy(), ...)
                # hands back a fresh object mutating which is private.
                if isinstance(f, ast.Attribute) and f.attr in (
                        "get", "setdefault", "values", "items", "keys"):
                    cur = f.value
                else:
                    return None
            elif isinstance(cur, ast.Name):
                return self.aliases.get(cur.id)
            else:
                return None
        return None

    def _record_write(self, attr: str, desc: str, node,
                      mutator: Optional[str] = None):
        self.info["writes"].append({
            "attr": attr, "desc": desc,
            "lineno": node.lineno, "col": node.col_offset,
            "locked": self.lock_depth > 0,
            "in_forward": self.forward_depth > 0,
            "mutator": mutator,
        })

    def _write_target(self, tgt):
        if isinstance(tgt, (ast.Tuple, ast.List)):
            for e in tgt.elts:
                self._write_target(e)
        elif isinstance(tgt, ast.Attribute):
            if isinstance(tgt.value, ast.Name) and tgt.value.id == "self":
                self._record_write(tgt.attr, f"self.{tgt.attr}", tgt)
            else:
                root = self._self_root(tgt.value)
                if root is not None:
                    self._record_write(
                        root, f"self.{root}…{_terminal_name(tgt) or ''}", tgt
                    )
        elif isinstance(tgt, ast.Subscript):
            root = self._self_root(tgt.value)
            if root is not None:
                self._record_write(root, f"self.{root}[…]", tgt)
        elif isinstance(tgt, ast.Name):
            root = self.aliases.get(tgt.id)
            # Plain rebinding of a local is not a write; only aug-assigns
            # route here (handled by caller).
        elif isinstance(tgt, ast.Starred):
            self._write_target(tgt.value)

    # -- statements -------------------------------------------------------
    def _stmt(self, node):
        t = type(node)
        if t in (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef):
            return  # nested definitions execute elsewhere
        if t is ast.Assign:
            self._expr(node.value)
            for tgt in node.targets:
                self._write_target(tgt)
            if len(node.targets) == 1 and isinstance(node.targets[0],
                                                     ast.Name):
                name = node.targets[0].id
                root = self._self_root(node.value)
                if root is not None:
                    self.aliases[name] = root
                else:
                    self.aliases.pop(name, None)
        elif t is ast.AugAssign:
            self._expr(node.value)
            tgt = node.target
            if isinstance(tgt, ast.Name):
                root = self.aliases.get(tgt.id)
                if root is not None:
                    self._record_write(root, f"self.{root} (via {tgt.id})",
                                       tgt)
            else:
                self._write_target(tgt)
        elif t is ast.AnnAssign:
            if node.value is not None:
                self._expr(node.value)
                self._write_target(node.target)
        elif t is ast.Delete:
            for tgt in node.targets:
                self._write_target(tgt)
        elif t is ast.Expr:
            self._expr(node.value)
        elif t is ast.Return:
            if node.value is not None:
                self._expr(node.value)
                if not (isinstance(node.value, ast.Constant)
                        and node.value.value is None):
                    self.info["value_returns"].append(node.lineno)
        elif t in (ast.If, ast.While):
            self._expr(node.test)
            self.cond_stack.append(_member_cond_desc(node.test))
            for s in node.body:
                self._stmt(s)
            for s in node.orelse:
                self._stmt(s)
            self.cond_stack.pop()
        elif t in (ast.For, ast.AsyncFor):
            self._expr(node.iter)
            if isinstance(node.target, ast.Name):
                root = self._self_root(node.iter)
                if root is not None:
                    self.aliases[node.target.id] = root
            for s in node.body:
                self._stmt(s)
            for s in node.orelse:
                self._stmt(s)
        elif t in (ast.With, ast.AsyncWith):
            locked = False
            for item in node.items:
                self._expr(item.context_expr)
                if t is ast.With and _is_lock_expr(item.context_expr):
                    locked = True
                if item.optional_vars is not None and \
                        isinstance(item.optional_vars, ast.Name):
                    self.aliases.pop(item.optional_vars.id, None)
            if locked:
                self.lock_depth += 1
            for s in node.body:
                self._stmt(s)
            if locked:
                self.lock_depth -= 1
        elif t is ast.Try:
            for s in node.body:
                self._stmt(s)
            for h in node.handlers:
                for s in h.body:
                    self._stmt(s)
            for s in node.orelse:
                self._stmt(s)
            for s in node.finalbody:
                self._stmt(s)
        else:
            # Raise / Assert / match / etc: walk children generically.
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.stmt):
                    self._stmt(child)
                elif isinstance(child, ast.expr):
                    self._expr(child)
                elif isinstance(child, (ast.match_case,)):
                    for s in child.body:
                        self._stmt(s)

    # -- expressions ------------------------------------------------------
    def _expr(self, node):
        if node is None:
            return
        t = type(node)
        if t is ast.Lambda:
            return  # executes elsewhere
        if t is ast.Call:
            self._call(node)
            return
        if t is ast.IfExp:
            self._expr(node.test)
            self.cond_stack.append(_member_cond_desc(node.test))
            self._expr(node.body)
            self._expr(node.orelse)
            self.cond_stack.pop()
            return
        if t is ast.BoolOp and len(node.values) > 1:
            # `rank == 0 and group.allreduce(x)`: later operands only
            # evaluate when the first holds.
            self._expr(node.values[0])
            self.cond_stack.append(_member_cond_desc(node.values[0]))
            for v in node.values[1:]:
                self._expr(v)
            self.cond_stack.pop()
            return
        if t in (ast.ListComp, ast.SetComp, ast.GeneratorExp, ast.DictComp):
            conds = 0
            for gen in node.generators:
                self._expr(gen.iter)
                for if_ in gen.ifs:
                    self._expr(if_)
                    self.cond_stack.append(_member_cond_desc(if_))
                    conds += 1
            if t is ast.DictComp:
                self._expr(node.key)
                self._expr(node.value)
            else:
                self._expr(node.elt)
            for _ in range(conds):
                self.cond_stack.pop()
            return
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.expr):
                self._expr(child)

    def _call(self, node: ast.Call):
        f = node.func
        edge = None
        if isinstance(f, ast.Name):
            edge = ("bare", f.id)
        elif isinstance(f, ast.Attribute):
            if isinstance(f.value, ast.Name) and f.value.id == "self":
                edge = ("self", f.attr)
            else:
                dn = _dotted(f)
                if dn and dn.startswith("self.") and dn.count(".") == 2:
                    edge = ("attr", dn[5:])  # "owned.get"
                elif dn:
                    edge = ("dotted", dn)
                else:
                    # x[i].m(), getattr(h, n)(...), chained calls:
                    # dynamic dispatch falls back to unknown.
                    self.info["dynamic_calls"] += 1
        else:
            self.info["dynamic_calls"] += 1

        if edge is not None:
            self.info["calls"].append({
                "kind": edge[0], "name": edge[1],
                "lineno": node.lineno, "col": node.col_offset,
                "in_forward": self.forward_depth > 0,
                "member_cond": self._member_cond(),
            })

        reason = _blocking_call_reason(node)
        if reason is not None:
            self.info["blocking"].append({
                "reason": reason, "lineno": node.lineno,
                "col": node.col_offset,
                "in_forward": self.forward_depth > 0,
            })
        coll = _collective_desc(node)
        if coll is not None:
            self.info["collectives"].append({
                "name": coll, "lineno": node.lineno, "col": node.col_offset,
                "member_cond": self._member_cond(),
                "in_forward": self.forward_depth > 0,
            })

        if isinstance(f, ast.Attribute):
            # Container-mutating method on shared state (RTL007).
            if f.attr in _MUTATOR_METHODS:
                root = self._self_root(f.value)
                recv = _terminal_name(f.value) or ""
                if root is not None and not _QUEUE_NAME_RE.search(recv):
                    self._record_write(
                        root, f"self.{root}.{f.attr}(…)", node,
                        mutator=f.attr,
                    )
            # RPC wire call site (RTL009).
            if f.attr in ("call", "notify"):
                method = None
                if node.args and isinstance(node.args[0], ast.Constant) \
                        and isinstance(node.args[0].value, str):
                    method = node.args[0].value
                self.call_sites.append({
                    "recv": self._recv_hint(f.value), "kind": f.attr,
                    "method": method, "lineno": node.lineno,
                    "col": node.col_offset,
                })

        # Descend: a ForwardToPrimary factory's contents run on the
        # primary loop, outside the lane contract being checked.
        is_forward = isinstance(f, ast.Name) and f.id == "ForwardToPrimary"
        if not is_forward and isinstance(f, ast.Attribute):
            is_forward = f.attr == "ForwardToPrimary"
        if is_forward:
            self.forward_depth += 1
        self._expr(f) if isinstance(f, ast.Attribute) and not \
            isinstance(f.value, ast.Name) else None
        for arg in node.args:
            self._expr(arg)
        for kw in node.keywords:
            self._expr(kw.value)
        if is_forward:
            self.forward_depth -= 1

    @staticmethod
    def _recv_hint(node) -> str:
        """Best-effort receiver name for an RPC call site: the deepest
        non-generic attribute in the chain (`self.worker_clients.get(a)`
        -> "worker_clients")."""
        tokens: List[str] = []
        cur = node
        for _ in range(16):
            if isinstance(cur, ast.Attribute):
                tokens.append(cur.attr)
                cur = cur.value
            elif isinstance(cur, ast.Name):
                tokens.append(cur.id)
                break
            elif isinstance(cur, ast.Call):
                cur = (cur.func.value if isinstance(cur.func, ast.Attribute)
                       else cur.func)
            elif isinstance(cur, ast.Subscript):
                cur = cur.value
            else:
                break
        for tok in tokens:
            if tok not in ("get", "self", "cls"):
                return tok
        return tokens[0] if tokens else ""


def _literal_strings(node) -> Optional[List[str]]:
    """String entries of a frozenset({...}) / {...} / (...) literal."""
    if isinstance(node, ast.Call) and _terminal_name(node.func) in (
            "frozenset", "set", "tuple", "list"):
        if not node.args:
            return []
        node = node.args[0]
    if isinstance(node, (ast.Set, ast.Tuple, ast.List)):
        out = []
        for e in node.elts:
            if isinstance(e, ast.Constant) and isinstance(e.value, str):
                out.append(e.value)
            else:
                return None
        return out
    return None


def summarize_module(tree: ast.AST, path: str, runtime_scope: bool) -> dict:
    """Extract the per-module summary the interprocedural rules run on.
    Pure data (JSON-serializable) so ``--changed`` can cache it."""
    module = _module_name(path)
    summary = {
        "path": path, "module": module, "runtime_scope": runtime_scope,
        "imports": {}, "classes": {}, "functions": [], "call_sites": [],
    }
    pkg_parts = module.split(".")[:-1]

    def add_import_module(local: str, dotted: str):
        if dotted.startswith("ray_tpu_torch."):
            dotted = dotted[len("ray_tpu_torch."):]
        summary["imports"][local] = [dotted, None]

    def add_import_symbol(local: str, mod: str, symbol: str):
        if mod.startswith("ray_tpu_torch."):
            mod = mod[len("ray_tpu_torch."):]
        summary["imports"][local] = [mod, symbol]

    for node in tree.body if hasattr(tree, "body") else []:
        if isinstance(node, ast.Import):
            for alias in node.names:
                local = alias.asname or alias.name.split(".")[0]
                add_import_module(local, alias.name)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = pkg_parts[:len(pkg_parts) - (node.level - 1)] \
                    if node.level > 1 else list(pkg_parts)
                mod = ".".join(base + (node.module.split(".")
                                       if node.module else []))
            else:
                mod = node.module or ""
            for alias in node.names:
                if alias.name == "*":
                    continue
                add_import_symbol(alias.asname or alias.name, mod,
                                  alias.name)

    def scan_function(fn, cls_name):
        scanner = _FunctionScanner(module, cls_name, path,
                                   summary["call_sites"])
        summary["functions"].append(scanner.scan(fn))

    for node in getattr(tree, "body", []):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            scan_function(node, None)
        elif isinstance(node, ast.ClassDef):
            cls = {
                "lineno": node.lineno,
                "bases": [b for b in (_terminal_name(x) for x in node.bases)
                          if b],
                "lane_safe": None, "lane_safe_line": node.lineno,
                "attr_types": {}, "methods": [],
            }
            summary["classes"][node.name] = cls
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    cls["methods"].append(item.name)
                    scan_function(item, node.name)
                    # `self.x = ClassName(...)` / `self.x: T = ...` type
                    # hints feed attr-receiver call resolution.
                    for sub in ast.walk(item):
                        if isinstance(sub, ast.Assign) and \
                                len(sub.targets) == 1 and \
                                isinstance(sub.targets[0], ast.Attribute) \
                                and isinstance(sub.targets[0].value,
                                               ast.Name) \
                                and sub.targets[0].value.id == "self" \
                                and isinstance(sub.value, ast.Call):
                            tname = _terminal_name(sub.value.func)
                            if tname and tname[:1].isupper():
                                cls["attr_types"].setdefault(
                                    sub.targets[0].attr, tname)
                        elif isinstance(sub, ast.AnnAssign) and \
                                isinstance(sub.target, ast.Attribute) and \
                                isinstance(sub.target.value, ast.Name) and \
                                sub.target.value.id == "self":
                            tname = _terminal_name(sub.annotation)
                            if tname and tname[:1].isupper():
                                cls["attr_types"].setdefault(
                                    sub.target.attr, tname)
                elif isinstance(item, (ast.Assign, ast.AnnAssign)):
                    tgt = (item.targets[0] if isinstance(item, ast.Assign)
                           else item.target)
                    if isinstance(tgt, ast.Name) and \
                            tgt.id == "LANE_SAFE_METHODS" and \
                            item.value is not None:
                        entries = _literal_strings(item.value)
                        if entries is not None:
                            cls["lane_safe"] = entries
                            cls["lane_safe_line"] = item.lineno
    return summary


class _Program:
    """Whole-batch index over module summaries: function lookup, class
    hierarchy walk, call-edge resolution."""

    def __init__(self, summaries: Sequence[dict]):
        self.summaries = list(summaries)
        self.modsum: Dict[str, dict] = {}
        self.by_key: Dict[Tuple[str, Optional[str], str], dict] = {}
        self.classes: Dict[Tuple[str, str], dict] = {}
        self.class_sites: Dict[str, List[Tuple[str, dict]]] = {}
        self.call_sites: List[dict] = []
        for s in self.summaries:
            self.modsum[s["module"]] = s
            for f in s["functions"]:
                self.by_key[(s["module"], f["cls"], f["name"])] = f
            for cname, c in s["classes"].items():
                self.classes[(s["module"], cname)] = c
                self.class_sites.setdefault(cname, []).append(
                    (s["module"], c))
            for site in s["call_sites"]:
                site = dict(site)
                site["path"] = s["path"]
                self.call_sites.append(site)
        self._resolve_memo: Dict[tuple, Optional[tuple]] = {}
        self._handler_memo: Dict[Tuple[str, str], Set[str]] = {}

    # -- class/method resolution ------------------------------------------
    def _find_class(self, module: str, name: str) -> Optional[Tuple[str, dict]]:
        c = self.classes.get((module, name))
        if c is not None:
            return module, c
        s = self.modsum.get(module)
        if s is not None:
            imp = s["imports"].get(name)
            if imp is not None and imp[1] is not None:
                c = self.classes.get((imp[0], imp[1]))
                if c is not None:
                    return imp[0], c
        sites = self.class_sites.get(name)
        if sites and len(sites) == 1:
            return sites[0]
        return None

    def resolve_method(self, module: str, cls: str, name: str,
                       _depth: int = 0) -> Optional[tuple]:
        if _depth > 8:
            return None
        found = self._find_class(module, cls)
        if found is None:
            return None
        cmod, cdict = found
        if name in cdict["methods"]:
            return (cmod, cls, name)
        for base in cdict["bases"]:
            r = self.resolve_method(cmod, base, name, _depth + 1)
            if r is not None:
                return r
        return None

    def attr_type(self, module: str, cls: Optional[str],
                  attr: str) -> Optional[str]:
        seen = set()
        while cls is not None and cls not in seen:
            seen.add(cls)
            found = self._find_class(module, cls)
            if found is None:
                return None
            module, cdict = found
            t = cdict["attr_types"].get(attr)
            if t is not None:
                return t
            cls = cdict["bases"][0] if cdict["bases"] else None
        return None

    def class_handlers(self, module: str, cls: str) -> Set[str]:
        """handle_* method names (sans prefix) on a class incl. bases."""
        memo = self._handler_memo.get((module, cls))
        if memo is not None:
            return memo
        out: Set[str] = set()
        self._handler_memo[(module, cls)] = out  # cycle guard
        found = self._find_class(module, cls)
        if found is not None:
            cmod, cdict = found
            for m in cdict["methods"]:
                if m.startswith("handle_"):
                    out.add(m[len("handle_"):])
            for base in cdict["bases"]:
                out |= self.class_handlers(cmod, base)
        return out

    # -- call-edge resolution ---------------------------------------------
    def resolve(self, finfo: dict, edge: dict) -> Optional[tuple]:
        key = (finfo["module"], finfo["cls"], edge["kind"], edge["name"])
        if key in self._resolve_memo:
            return self._resolve_memo[key]
        r = self._resolve_uncached(finfo, edge)
        self._resolve_memo[key] = r
        return r

    def _resolve_uncached(self, finfo, edge) -> Optional[tuple]:
        mod = finfo["module"]
        kind, name = edge["kind"], edge["name"]
        s = self.modsum.get(mod, {})
        imports = s.get("imports", {})
        if kind == "self":
            if finfo["cls"] is None:
                return None
            return self.resolve_method(mod, finfo["cls"], name)
        if kind == "bare":
            if (mod, None, name) in self.by_key:
                return (mod, None, name)
            imp = imports.get(name)
            if imp is not None and imp[1] is not None \
                    and (imp[0], None, imp[1]) in self.by_key:
                return (imp[0], None, imp[1])
            return None
        if kind == "attr":
            attr, meth = name.split(".", 1)
            t = self.attr_type(mod, finfo["cls"], attr)
            if t is None:
                return None
            found = self._find_class(mod, t)
            if found is None:
                return None
            return self.resolve_method(found[0], t, meth)
        if kind == "dotted":
            parts = name.split(".")
            imp = imports.get(parts[0])
            if imp is None:
                return None
            m2, sym = imp
            if sym is None:
                # `import x.y as z; z.f(...)`
                if len(parts) == 2 and (m2, None, parts[1]) in self.by_key:
                    return (m2, None, parts[1])
                return None
            # `from m import sub; sub.f(...)` — sub is a module or class.
            cand_mod = f"{m2}.{sym}" if m2 else sym
            if len(parts) == 2:
                if (cand_mod, None, parts[1]) in self.by_key:
                    return (cand_mod, None, parts[1])
                return self.resolve_method(m2, sym, parts[1])
        return None

    def module_of(self, key: tuple) -> str:
        return key[0]

    def finfo(self, key: tuple) -> dict:
        return self.by_key[key]


def _short(key: tuple) -> str:
    mod, cls, name = key
    return f"{cls}.{name}" if cls else name


def _service_group(prog: _Program, hint: str) -> Optional[List[Tuple[str, str]]]:
    """Map an RPC call-site receiver hint to the (module, class) service
    group it addresses; None means unknown (check against the union)."""
    h = (hint or "").lower()
    if "cp" in h or "control" in h:
        pat = "controlplane"
    elif "agent" in h:
        pat = "agent"
    elif "worker" in h or "owner" in h or "caller" in h:
        pat = "worker"
    else:
        return None
    out = [
        (mod, cname) for (mod, cname), c in prog.classes.items()
        if pat in cname.lower()
        and any(m.startswith("handle_") for m in c["methods"])
    ]
    return out or None


# -------------------------------------------------- interprocedural rules
def _rtl007(prog: _Program) -> List[Violation]:
    findings: Dict[tuple, tuple] = {}
    for (mod, cname), cdict in sorted(prog.classes.items()):
        entries = cdict.get("lane_safe")
        if not entries:
            continue
        for entry in sorted(entries):
            hkey = prog.resolve_method(mod, cname, "handle_" + entry)
            if hkey is None:
                continue  # RTL009 reports the missing handler
            seen: Set[tuple] = set()
            stack = [(hkey, (f"handle_{entry}",))]
            while stack:
                key, chain = stack.pop()
                if key in seen:
                    continue
                seen.add(key)
                fi = prog.finfo(key)
                for w in fi["writes"]:
                    if w["locked"] or w["in_forward"]:
                        continue
                    if w["mutator"] is not None and prog.attr_type(
                            fi["module"], fi["cls"], w["attr"]
                    ) in CONTRACT_TYPES:
                        continue
                    fkey = (fi["path"], w["lineno"], w["attr"])
                    findings.setdefault(
                        fkey, (cname, entry, chain, w, fi))
                for e in fi["calls"]:
                    if e["in_forward"] or len(chain) > 12:
                        continue
                    ck = prog.resolve(fi, e)
                    if ck is None:
                        continue
                    if prog.module_of(ck) in CONTRACT_MODULES:
                        continue
                    cfi = prog.finfo(ck)
                    if cfi["cls"] in CONTRACT_TYPES:
                        continue
                    stack.append((ck, chain + (_short(ck),)))
    out = []
    for (path, lineno, attr), (cname, entry, chain, w, fi) in \
            sorted(findings.items()):
        via = " -> ".join(chain)
        out.append(Violation(
            "RTL007", path, lineno, w["col"],
            f"lane-safe method {entry!r} ({cname}) reaches a mutation of "
            f"{w['desc']} outside the shard-lock contract [{via}] — lane "
            "threads may race the primary loop here; hold a lock/"
            "shard_lock, punt via ForwardToPrimary, or waive with a "
            "justification",
        ))
    return out


def _collective_reps(prog: _Program) -> Dict[tuple, tuple]:
    rep: Dict[tuple, tuple] = {}
    for key, f in prog.by_key.items():
        for c in f["collectives"]:
            if not c["in_forward"]:
                rep[key] = (c["name"], ())
                break
    changed = True
    while changed:
        changed = False
        for key, f in prog.by_key.items():
            if key in rep:
                continue
            for e in f["calls"]:
                if e["in_forward"]:
                    continue
                ck = prog.resolve(f, e)
                if ck is not None and ck in rep:
                    name, chain = rep[ck]
                    rep[key] = (name, (_short(ck),) + chain)
                    changed = True
                    break
    return rep


def _rtl008(prog: _Program) -> List[Violation]:
    rep = _collective_reps(prog)
    out, seen = [], set()

    def add(path, lineno, col, msg):
        if (path, lineno) in seen:
            return
        seen.add((path, lineno))
        out.append(Violation("RTL008", path, lineno, col, msg))

    for key, f in sorted(prog.by_key.items(),
                         key=lambda kv: (kv[0][0], kv[0][1] or "",
                                         kv[0][2])):
        if not prog.modsum.get(f["module"], {}).get("runtime_scope", True):
            continue
        for c in f["collectives"]:
            if c["member_cond"] and not c["in_forward"]:
                add(f["path"], c["lineno"], c["col"],
                    f"collective/tuner call {c['name']}() under control "
                    f"flow conditioned on per-member state "
                    f"({c['member_cond']}) — members that branch "
                    "differently desynchronize the SPMD call sequence "
                    "(tuner decision tables replicate by call order)")
        for e in f["calls"]:
            if not e["member_cond"] or e["in_forward"]:
                continue
            ck = prog.resolve(f, e)
            if ck is None or ck not in rep:
                continue
            name, chain = rep[ck]
            via = " -> ".join((_short(ck),) + chain)
            add(f["path"], e["lineno"], e["col"],
                f"call under per-member condition ({e['member_cond']}) "
                f"transitively performs collective/tuner op {name}() "
                f"[{via}] — SPMD lockstep divergence risk")
    return out


def _rtl009(prog: _Program) -> List[Violation]:
    out: List[Violation] = []
    handler_classes = [
        (mod, cname) for (mod, cname), c in sorted(prog.classes.items())
        if any(m.startswith("handle_") for m in c["methods"])
    ]
    all_known: Set[str] = set()
    for mod, cname in handler_classes:
        all_known |= prog.class_handlers(mod, cname)

    # (a) every literal method string at a call/notify site must resolve
    # to a real handler on the matching service class.
    if all_known:
        for site in prog.call_sites:
            m = site["method"]
            if m is None or m in PROTOCOL_METHODS:
                continue
            group = _service_group(prog, site["recv"])
            if group:
                known = set()
                for gmod, gcls in group:
                    known |= prog.class_handlers(gmod, gcls)
                desc = "/".join(sorted({c for _, c in group}))
            else:
                known, desc = all_known, "any known service"
            if m not in known:
                out.append(Violation(
                    "RTL009", site["path"], site["lineno"], site["col"],
                    f".{site['kind']}({m!r}, …): no handler 'handle_{m}' "
                    f"on {desc} — the server will answer with an RpcError "
                    "(or silently drop the oneway frame); stale string "
                    "method name?",
                ))

    # (b) LANE_SAFE_METHODS entries must name existing *sync* handlers.
    for (mod, cname), cdict in sorted(prog.classes.items()):
        entries = cdict.get("lane_safe")
        if not entries:
            continue
        spath = prog.modsum[mod]["path"]
        for entry in sorted(entries):
            hkey = prog.resolve_method(mod, cname, "handle_" + entry)
            if hkey is None:
                out.append(Violation(
                    "RTL009", spath, cdict["lane_safe_line"], 0,
                    f"LANE_SAFE_METHODS entry {entry!r} ({cname}) names no "
                    f"existing handler 'handle_{entry}' — lane dispatch "
                    "will forward every such call (or error)",
                ))
            elif prog.finfo(hkey)["is_async"]:
                out.append(Violation(
                    "RTL009", spath, cdict["lane_safe_line"], 0,
                    f"LANE_SAFE_METHODS entry {entry!r} ({cname}): "
                    f"'handle_{entry}' is async — lane dispatch requires a "
                    "sync handler, so this entry silently never runs on a "
                    "lane",
                ))

    # (c) notify-only (oneway) methods must not return values: msg_id 0
    # frames get no reply, so the return is dead code that reads like a
    # meaningful acknowledgement.
    notified = {s["method"] for s in prog.call_sites
                if s["kind"] == "notify" and s["method"]}
    called = {s["method"] for s in prog.call_sites
              if s["kind"] == "call" and s["method"]}
    for m in sorted(notified - called):
        for (mod, cname), cdict in sorted(prog.classes.items()):
            if "handle_" + m not in cdict["methods"]:
                continue
            fi = prog.by_key.get((mod, cname, "handle_" + m))
            if fi is None:
                continue
            for lineno in fi["value_returns"]:
                out.append(Violation(
                    "RTL009", fi["path"], lineno, 0,
                    f"'handle_{m}' ({cname}) returns a value, but "
                    f"{m!r} is only ever sent oneway (.notify) — the "
                    "value is silently dropped; use a bare return (or "
                    "promote the client sites to .call)",
                ))
    return out


def _blocking_reps(prog: _Program) -> Dict[tuple, tuple]:
    rep: Dict[tuple, tuple] = {}
    for key, f in prog.by_key.items():
        if f["is_async"]:
            continue
        for b in f["blocking"]:
            if b["reason"].startswith("subprocess"):
                continue  # RTL001's concern, mirrors RTL005's carve-out
            rep[key] = (b["reason"], ())
            break
    changed = True
    while changed:
        changed = False
        for key, f in prog.by_key.items():
            if f["is_async"] or key in rep:
                continue
            for e in f["calls"]:
                if _nonblocking_by_convention(e["name"]):
                    continue
                ck = prog.resolve(f, e)
                if ck is not None and ck in rep \
                        and not prog.finfo(ck)["is_async"]:
                    reason, chain = rep[ck]
                    rep[key] = (reason, (_short(ck),) + chain)
                    changed = True
                    break
    return rep


def _nonblocking_by_convention(edge_name: str) -> bool:
    """`*_nowait` variants gate their blocking branch on block=False
    internally; the path-insensitive propagation would otherwise drag
    their callers into the blocking set."""
    return edge_name.split(".")[-1].endswith("_nowait")


def _rtl010(prog: _Program) -> List[Violation]:
    rep = _blocking_reps(prog)
    out, seen = [], set()
    for key, f in sorted(prog.by_key.items(),
                         key=lambda kv: (kv[0][0], kv[0][1] or "",
                                         kv[0][2])):
        if not f["is_async"]:
            continue
        for e in f["calls"]:
            if e["in_forward"] or _nonblocking_by_convention(e["name"]):
                continue
            ck = prog.resolve(f, e)
            if ck is None or ck not in rep or prog.finfo(ck)["is_async"]:
                continue
            if (f["path"], e["lineno"]) in seen:
                continue
            seen.add((f["path"], e["lineno"]))
            reason, chain = rep[ck]
            via = " -> ".join((_short(ck),) + chain)
            out.append(Violation(
                "RTL010", f["path"], e["lineno"], e["col"],
                f"async def {_short(key)} calls into a sync path that "
                f"blocks [{via}: {reason}] — the event loop stalls "
                "exactly as if the blocking call were inline (RTL005 "
                "through the call graph); use the async equivalent or "
                "run_in_executor",
            ))
    return out


def run_global_rules(summaries: Sequence[dict]) -> List[Violation]:
    prog = _Program(summaries)
    out: List[Violation] = []
    out.extend(_rtl007(prog))
    out.extend(_rtl008(prog))
    out.extend(_rtl009(prog))
    out.extend(_rtl010(prog))
    return out


# ---------------------------------------------------------- file discovery
def _iter_python_files(paths: Sequence[str]):
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                yield p
        elif os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = [d for d in dirs
                           if d not in ("__pycache__", ".git", "build")]
                for f in sorted(files):
                    if f.endswith(".py"):
                        yield os.path.join(root, f)
        else:
            raise FileNotFoundError(p)


def _package_relative(path: str) -> Optional[str]:
    """Path inside the ray_tpu_torch package ('core/foo.py'), or None if the
    file is not under a ray_tpu_torch directory."""
    parts = os.path.abspath(path).replace(os.sep, "/").split("/")
    if "ray_tpu_torch" not in parts:
        return None
    idx = len(parts) - 1 - parts[::-1].index("ray_tpu_torch")
    rel = "/".join(parts[idx + 1:])
    return rel or None


def _in_runtime_scope(path: str) -> bool:
    rel = _package_relative(path)
    if rel is None:
        return True  # standalone snippet (fixtures): all rules apply
    return (rel.startswith(RUNTIME_SCOPE_PREFIXES)
            or rel in RUNTIME_SCOPE_FILES)


def _registry_path() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "util", "metric_registry.py")


def load_declared_metrics(registry_path: Optional[str] = None) -> Set[str]:
    """Metric names declared in the registry module — parsed from its AST
    so linting never imports runtime code."""
    registry_path = registry_path or _registry_path()
    declared: Set[str] = set()
    try:
        with open(registry_path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), filename=registry_path)
    except (OSError, SyntaxError):
        return declared
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and _METRIC_NAME_RE.fullmatch(node.value)):
            declared.add(node.value)
    return declared


def check_docs_coverage(declared: Set[str],
                        doc_path: Optional[str] = None) -> List[Violation]:
    """RTL004 second half: every registered name must appear in
    docs/observability.md (skipped silently when the docs tree is not
    present, e.g. an installed wheel)."""
    registry = _registry_path()
    if doc_path is None:
        repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        doc_path = os.path.join(repo_root, "docs", "observability.md")
    if not os.path.isfile(doc_path):
        return []
    with open(doc_path, encoding="utf-8") as f:
        doc_text = f.read()
    out = []
    for name in sorted(declared):
        if name not in doc_text:
            out.append(Violation(
                "RTL004", registry, 1, 0,
                f"metric {name!r} is registered but undocumented — add it "
                f"to {os.path.relpath(doc_path)}",
            ))
    return out


# -------------------------------------------------------- incremental cache
CACHE_VERSION = 2


def default_cache_file() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        ".lint_cache.json")


def _load_cache(path: str) -> dict:
    try:
        with open(path, encoding="utf-8") as f:
            cache = json.load(f)
        if cache.get("version") == CACHE_VERSION:
            return cache
    except (OSError, ValueError):
        pass
    return {"version": CACHE_VERSION, "files": {}}


def _save_cache(path: str, cache: dict):
    try:
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(cache, f, separators=(",", ":"))
        os.replace(tmp, path)
    except OSError:
        pass  # a cache that can't persist just means a cold next run


def _cache_entry_fresh(entry: dict, path: str) -> bool:
    """mtime+size first (cheap), content hash as the tiebreaker — a
    touch without an edit re-hashes but does not re-analyze."""
    try:
        st = os.stat(path)
    except OSError:
        return False
    key = entry.get("key") or [None, None, None]
    if key[0] == st.st_mtime_ns and key[1] == st.st_size:
        return True
    if key[1] != st.st_size:
        return False
    sha = _file_sha(path)
    if sha == key[2]:
        entry["key"] = [st.st_mtime_ns, st.st_size, sha]
        return True
    return False


def _file_sha(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 16), b""):
            h.update(chunk)
    return h.hexdigest()


def _cache_key(path: str, data: bytes) -> list:
    st = os.stat(path)
    return [st.st_mtime_ns, st.st_size, hashlib.sha256(data).hexdigest()]


# -------------------------------------------------------------------- run
def _inline_waive_rules(line_text: str) -> Set[str]:
    m = _WAIVE_COMMENT_RE.search(line_text)
    if not m:
        return set()
    return {r.strip() for r in m.group(1).split(",") if r.strip()}


class _SourceLines:
    """Lazy source-line access for waiver matching: files analyzed this
    run are already in memory; cached files load on first need."""

    def __init__(self):
        self._lines: Dict[str, List[str]] = {}

    def put(self, path: str, lines: List[str]):
        self._lines[path] = lines

    def line(self, path: str, lineno: int) -> str:
        lines = self._lines.get(path)
        if lines is None:
            try:
                with open(path, encoding="utf-8") as f:
                    lines = f.read().splitlines()
            except OSError:
                lines = []
            self._lines[path] = lines
        if 1 <= lineno <= len(lines):
            return lines[lineno - 1]
        return ""


def run(paths: Sequence[str], waiver_file: Optional[str],
        check_docs: bool = True, changed_only: bool = False,
        cache_file: Optional[str] = None
        ) -> Tuple[List[Violation], List[Waiver]]:
    declared = load_declared_metrics()
    registry = _registry_path()
    waivers = parse_waivers(waiver_file) if waiver_file else []
    violations: List[Violation] = []
    summaries: List[dict] = []
    sources = _SourceLines()

    cache = None
    if changed_only:
        cache_file = cache_file or default_cache_file()
        cache = _load_cache(cache_file)

    for path in _iter_python_files(paths):
        apath = os.path.abspath(path)
        if cache is not None:
            entry = cache["files"].get(apath)
            if entry is not None and _cache_entry_fresh(entry, apath):
                violations.extend(
                    Violation.from_dict(d) for d in entry["violations"])
                if entry.get("summary") is not None:
                    summaries.append(entry["summary"])
                continue
        with open(path, "rb") as f:
            data = f.read()
        source = data.decode("utf-8")
        sources.put(path, source.splitlines())
        runtime_scope = _in_runtime_scope(path)
        checker = FileChecker(
            path, source, runtime_scope, declared,
            registry_file=apath == registry,
        )
        summary = None
        try:
            tree = ast.parse(source, filename=path)
        except SyntaxError as e:
            checker._add("RTL000", e.lineno or 1, 0,
                         f"file does not parse: {e.msg}")
            local = checker.violations
        else:
            local = checker.check(tree)
            summary = summarize_module(tree, path, runtime_scope)
            summaries.append(summary)
        violations.extend(local)
        if cache is not None:
            cache["files"][apath] = {
                "key": _cache_key(apath, data),
                "violations": [v.to_dict() for v in local],
                "summary": summary,
            }

    violations.extend(run_global_rules(summaries))

    if check_docs:
        violations.extend(check_docs_coverage(declared))

    # Expired waivers are lint errors AND stop suppressing their sites.
    today = time.strftime("%Y-%m-%d")
    live_waivers = []
    for w in waivers:
        if w.expired(today):
            w.used = True  # don't double-report as unused
            violations.append(Violation(
                "RTL011", waiver_file or "<waivers>", w.srcline, 0,
                f"waiver ({','.join(w.rules)} {w.path}) expired on "
                f"{w.expires} — re-justify with a new expiry or fix the "
                "site (its violations resurface below)",
            ))
        else:
            live_waivers.append(w)

    for v in violations:
        if v.rule in UNWAIVABLE:
            continue  # parse failures / expired waivers are never waivable
        line_text = sources.line(v.path, v.line)
        if v.rule in _inline_waive_rules(line_text):
            v.waived = True
            v.waive_source = "inline comment"
            continue
        for w in live_waivers:
            if w.matches(v, line_text):
                v.waived = True
                v.waive_source = f"waiver file ({w.date}: {w.reason})"
                w.used = True
                break

    if cache is not None and cache_file:
        _save_cache(cache_file, cache)
    return violations, waivers


def default_waiver_file() -> Optional[str]:
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "lint_waivers.toml")
    return path if os.path.isfile(path) else None


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m ray_tpu_torch.devtools.lint",
        description="raylint: runtime-invariant static analysis "
                    "(RTL001-RTL010)",
    )
    parser.add_argument("paths", nargs="*",
                        help="files/directories to lint (default: the "
                             "ray_tpu_torch package)")
    parser.add_argument("--waivers", default=None,
                        help="waiver file (default: lint_waivers.toml "
                             "next to this module)")
    parser.add_argument("--no-waivers", action="store_true",
                        help="ignore the waiver file (show everything)")
    parser.add_argument("--no-docs-check", action="store_true",
                        help="skip the RTL004 docs-coverage pass")
    parser.add_argument("--changed", action="store_true",
                        help="incremental mode: reuse per-file results "
                             "from the mtime+hash cache, re-analyzing "
                             "only files whose content changed "
                             "(interprocedural rules always re-run over "
                             "all cached summaries)")
    parser.add_argument("--cache", default=None,
                        help="cache file for --changed (default: "
                             ".lint_cache.json next to this module)")
    parser.add_argument("--json", action="store_true", dest="as_json",
                        help="emit violations as JSON on stdout")
    parser.add_argument("--list-rules", action="store_true")
    parser.add_argument("--show-waived", action="store_true",
                        help="also print waived violations")
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule_id, slug in RULES.items():
            print(f"{rule_id}  {slug}")
        return 0

    paths = args.paths or [os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))]
    waiver_file = None if args.no_waivers else (
        args.waivers or default_waiver_file()
    )
    try:
        violations, waivers = run(
            paths, waiver_file, check_docs=not args.no_docs_check,
            changed_only=args.changed, cache_file=args.cache,
        )
    except (WaiverError, FileNotFoundError) as e:
        print(f"raylint: error: {e}", file=sys.stderr)
        return 2

    unwaived = [v for v in violations if not v.waived]
    shown = violations if (args.show_waived or args.as_json) else unwaived
    shown = sorted(shown, key=lambda v: (v.path, v.line, v.rule))
    n_waived = sum(1 for v in violations if v.waived)
    if args.as_json:
        print(json.dumps({
            "violations": [v.to_dict() for v in shown],
            "unwaived": len(unwaived),
            "waived": n_waived,
        }, indent=2))
    else:
        for v in shown:
            print(v.render())
    # Unused-waiver nagging only makes sense for a whole-package run — a
    # subset lint legitimately never exercises most entries.
    if not args.paths:
        for w in waivers:
            if not w.used:
                print(f"raylint: warning: unused waiver "
                      f"({','.join(w.rules)} {w.path}) — remove it",
                      file=sys.stderr)
    if not args.as_json:
        print(f"raylint: {len(unwaived)} violation(s), {n_waived} waived",
              file=sys.stderr)
    return 1 if unwaived else 0


if __name__ == "__main__":
    sys.exit(main())

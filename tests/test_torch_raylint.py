"""raylint on the port (ray_tpu_torch.devtools.lint) + DebugLock tests.

The twin of ``tests/test_raylint.py``, case for case, with the two name
moves (``ray_tpu`` → ``ray_tpu_torch``, ``RAY_TPU_`` → ``RAY_TPU_TORCH_``):
per rule RTL001-RTL006 one known-bad fixture proving the rule fires and
one known-good fixture proving it stays quiet, waiver parsing, inline
waive comments, the DebugLock lock-inversion cycle detector, and the
gate: the whole ``ray_tpu_torch`` package must lint clean against the
port's waiver file.  Then what only the port has: every snippet of the
JAX lint tests linted by both packages' lints gives the same findings,
and the port's ``data/`` lints clean (the twin of
``tests/test_data_streaming_scheduler.py::TestRaylintClean``).
"""

import os
import textwrap
import threading

import pytest

from ray_tpu_torch.devtools import lint
from ray_tpu_torch.util import debug_locks


def run_lint(tmp_path, source, name="snippet.py", waiver_file=None):
    path = tmp_path / name
    path.write_text(textwrap.dedent(source))
    violations, _ = lint.run([str(path)], waiver_file, check_docs=False)
    return violations


def rules_fired(violations, only_unwaived=True):
    return sorted({
        v.rule for v in violations if not (only_unwaived and v.waived)
    })


# --------------------------------------------------------------- fixtures
class TestRTL001NoBlockingUnderLock:
    def test_bad(self, tmp_path):
        vs = run_lint(tmp_path, """
            import time

            def f(self):
                with self._tier_lock:
                    time.sleep(1.0)
        """)
        assert "RTL001" in rules_fired(vs)

    def test_bad_result_and_get(self, tmp_path):
        vs = run_lint(tmp_path, """
            import ray_tpu_torch

            def f(self, fut):
                with self._lock:
                    ray_tpu_torch.get(self.ref)
                    fut.result()
        """)
        assert sum(1 for v in vs if v.rule == "RTL001") == 2

    def test_good_outside_lock(self, tmp_path):
        vs = run_lint(tmp_path, """
            import time

            def f(self):
                with self._tier_lock:
                    snapshot = dict(self._objects)
                time.sleep(1.0)
        """)
        assert "RTL001" not in rules_fired(vs)

    def test_good_nested_def_escapes(self, tmp_path):
        # A function *defined* under the lock runs later, off the lock.
        vs = run_lint(tmp_path, """
            import time

            def f(self):
                with self._lock:
                    def later():
                        time.sleep(1.0)
                    self.cb = later
        """)
        assert "RTL001" not in rules_fired(vs)


class TestRTL002ThreadHygiene:
    def test_bad_missing_both(self, tmp_path):
        vs = run_lint(tmp_path, """
            import threading
            t = threading.Thread(target=print)
        """)
        assert "RTL002" in rules_fired(vs)

    def test_bad_missing_name(self, tmp_path):
        vs = run_lint(tmp_path, """
            import threading
            t = threading.Thread(target=print, daemon=True)
        """)
        [v] = [v for v in vs if v.rule == "RTL002"]
        assert "name=" in v.message and "daemon=" not in v.message

    def test_good(self, tmp_path):
        vs = run_lint(tmp_path, """
            import threading
            t = threading.Thread(target=print, daemon=True, name="worker")
        """)
        assert "RTL002" not in rules_fired(vs)

    def test_bad_aliased_imports(self, tmp_path):
        vs = run_lint(tmp_path, """
            import threading as _t
            from threading import Thread as Thr
            a = _t.Thread(target=print)
            b = Thr(target=print)
        """)
        assert sum(1 for v in vs if v.rule == "RTL002") == 2


class TestRTL003SwallowedException:
    def test_bad(self, tmp_path):
        vs = run_lint(tmp_path, """
            def f():
                try:
                    g()
                except Exception:
                    pass
        """)
        assert "RTL003" in rules_fired(vs)

    def test_bad_bare_except(self, tmp_path):
        vs = run_lint(tmp_path, """
            def f():
                try:
                    g()
                except:
                    pass
        """)
        assert "RTL003" in rules_fired(vs)

    def test_good_logged(self, tmp_path):
        vs = run_lint(tmp_path, """
            import logging

            def f():
                try:
                    g()
                except Exception as e:
                    logging.getLogger(__name__).debug("g failed: %s", e)
        """)
        assert "RTL003" not in rules_fired(vs)

    def test_good_narrow_except(self, tmp_path):
        vs = run_lint(tmp_path, """
            def f():
                try:
                    g()
                except ValueError:
                    pass
        """)
        assert "RTL003" not in rules_fired(vs)

    def test_inline_waive_comment(self, tmp_path):
        vs = run_lint(tmp_path, """
            def f():
                try:
                    g()
                except Exception:  # raylint: waive[RTL003] gc-time teardown
                    pass
        """)
        waived = [v for v in vs if v.rule == "RTL003"]
        assert waived and all(v.waived for v in waived)


class TestRTL004MetricRegistry:
    def test_bad_unregistered_name(self, tmp_path):
        vs = run_lint(tmp_path, """
            SOME_METRIC = "ray_tpu_not_a_registered_metric_total"
        """)
        assert "RTL004" in rules_fired(vs)

    def test_good_registered_name(self, tmp_path):
        # Names declared in util/metric_registry.py pass anywhere.
        vs = run_lint(tmp_path, """
            NAME = "ray_tpu_task_phase_s"
        """)
        assert "RTL004" not in rules_fired(vs)

    def test_docs_coverage(self):
        # Every registered name must appear in docs/observability.md.
        declared = lint.load_declared_metrics()
        assert declared, "registry parse returned nothing"
        assert lint.check_docs_coverage(declared) == []


class TestRTL005AsyncBlocking:
    def test_bad_sleep_in_async(self, tmp_path):
        vs = run_lint(tmp_path, """
            import time

            async def handler():
                time.sleep(0.5)
        """)
        assert "RTL005" in rules_fired(vs)

    def test_bad_blocking_get_in_async(self, tmp_path):
        vs = run_lint(tmp_path, """
            import ray_tpu_torch

            async def handler(ref):
                return ray_tpu_torch.get(ref)
        """)
        assert "RTL005" in rules_fired(vs)

    def test_good_asyncio_sleep(self, tmp_path):
        vs = run_lint(tmp_path, """
            import asyncio

            async def handler():
                await asyncio.sleep(0.5)
        """)
        assert "RTL005" not in rules_fired(vs)

    def test_good_lambda_runs_off_loop(self, tmp_path):
        vs = run_lint(tmp_path, """
            import asyncio

            async def handler(response):
                loop = asyncio.get_running_loop()
                return await loop.run_in_executor(
                    None, lambda: response.result(timeout=60)
                )
        """)
        assert "RTL005" not in rules_fired(vs)


class TestRTL006UntimedWait:
    def test_bad_untimed_condition_wait(self, tmp_path):
        vs = run_lint(tmp_path, """
            def f(cond):
                cond.wait()
        """)
        assert "RTL006" in rules_fired(vs)

    def test_bad_unbounded_queue_get(self, tmp_path):
        vs = run_lint(tmp_path, """
            def f(self):
                return self._q.get()
        """)
        assert "RTL006" in rules_fired(vs)

    def test_good_timed_wait(self, tmp_path):
        vs = run_lint(tmp_path, """
            def f(cond, q):
                cond.wait(1.0)
                q.get(timeout=2.0)
        """)
        assert "RTL006" not in rules_fired(vs)

    def test_good_nonblocking_get(self, tmp_path):
        vs = run_lint(tmp_path, """
            def f(q):
                a = q.get(False)
                b = q.get(block=False)
                return a, b
        """)
        assert "RTL006" not in rules_fired(vs)

    def test_good_asyncio_wait_for_bounds_it(self, tmp_path):
        vs = run_lint(tmp_path, """
            import asyncio

            async def f(ev):
                await asyncio.wait_for(ev.wait(), timeout=1.0)
        """)
        assert "RTL006" not in rules_fired(vs)

    def test_bad_untimed_wait_for(self, tmp_path):
        # Condition.wait_for(pred) loops an untimed wait() internally.
        vs = run_lint(tmp_path, """
            def f(cv):
                with cv:
                    cv.wait_for(lambda: False)
        """)
        assert "RTL006" in rules_fired(vs)

    def test_good_timed_wait_for(self, tmp_path):
        vs = run_lint(tmp_path, """
            def f(cv):
                with cv:
                    cv.wait_for(lambda: False, timeout=1.0)
        """)
        assert "RTL006" not in rules_fired(vs)


class TestRTL000ParseError:
    def test_syntax_error_reported_and_unwaivable(self, tmp_path):
        path = tmp_path / "broken.py"
        path.write_text("def f(:\n    pass\n")
        # Even an inline-looking waive comment or waiver file entry must
        # not suppress a parse failure.
        wf = tmp_path / "w.toml"
        wf.write_text(textwrap.dedent("""
            [[waiver]]
            rule = "RTL000"
            path = "broken.py"
            reason = "nice try"
            date = "2026-08-03"
        """))
        violations, _ = lint.run([str(path)], str(wf), check_docs=False)
        flagged = [v for v in violations if v.rule == "RTL000"]
        assert flagged and not any(v.waived for v in flagged)


# ---------------------------------------------------------------- waivers
class TestWaivers:
    def test_parse_and_match(self, tmp_path):
        wf = tmp_path / "waivers.toml"
        wf.write_text(textwrap.dedent("""
            # grandfathered
            [[waiver]]
            rule = "RTL006"
            path = "snippet.py"
            contains = "cond.wait()"
            reason = "notifier is guaranteed by the stop protocol"
            date = "2026-08-03"
        """))
        vs = run_lint(tmp_path, """
            def f(cond):
                cond.wait()
        """, waiver_file=str(wf))
        flagged = [v for v in vs if v.rule == "RTL006"]
        assert flagged and all(v.waived for v in flagged)

    def test_multi_rule_entry(self, tmp_path):
        wf = tmp_path / "waivers.toml"
        wf.write_text(textwrap.dedent("""
            [[waiver]]
            rule = "RTL001,RTL006"
            path = "snippet.py"
            contains = "self._cv.wait()"
            reason = "exclusive drainer loop"
            date = "2026-08-03"
        """))
        vs = run_lint(tmp_path, """
            def f(self):
                with self._cv:
                    self._cv.wait()
        """, waiver_file=str(wf))
        assert vs and all(v.waived for v in vs)

    def test_missing_reason_rejected(self, tmp_path):
        wf = tmp_path / "w.toml"
        wf.write_text('[[waiver]]\nrule = "RTL001"\npath = "x.py"\n'
                      'date = "2026-08-03"\n')
        with pytest.raises(lint.WaiverError, match="reason"):
            lint.parse_waivers(str(wf))

    def test_unknown_rule_rejected(self, tmp_path):
        wf = tmp_path / "w.toml"
        wf.write_text('[[waiver]]\nrule = "RTL999"\npath = "x.py"\n'
                      'reason = "r"\ndate = "2026-08-03"\n')
        with pytest.raises(lint.WaiverError, match="RTL999"):
            lint.parse_waivers(str(wf))

    def test_garbage_rejected(self, tmp_path):
        wf = tmp_path / "w.toml"
        wf.write_text("not = [toml, at, all\n")
        with pytest.raises(lint.WaiverError):
            lint.parse_waivers(str(wf))

    def test_path_match_respects_component_boundary(self, tmp_path):
        # A waiver for "core/rpc.py" must not cover "score/rpc.py".
        (tmp_path / "score").mkdir()
        wf = tmp_path / "w.toml"
        wf.write_text(textwrap.dedent("""
            [[waiver]]
            rule = "RTL006"
            path = "core/rpc.py"
            reason = "grandfathered"
            date = "2026-08-03"
        """))
        vs = run_lint(tmp_path / "score", """
            def f(cond):
                cond.wait()
        """, name="rpc.py", waiver_file=str(wf))
        flagged = [v for v in vs if v.rule == "RTL006"]
        assert flagged and not any(v.waived for v in flagged)


# --------------------------------------------------------------- DebugLock
@pytest.fixture()
def clean_lock_graph():
    debug_locks.reset()
    yield
    debug_locks.reset()


class TestDebugLock:
    def test_factories_honor_env_knob(self, monkeypatch):
        monkeypatch.delenv("RAY_TPU_TORCH_DEBUG_LOCKS", raising=False)
        assert isinstance(debug_locks.make_lock("x"), type(threading.Lock()))
        monkeypatch.setenv("RAY_TPU_TORCH_DEBUG_LOCKS", "1")
        assert isinstance(debug_locks.make_lock("x"), debug_locks.DebugLock)
        assert isinstance(debug_locks.make_condition("x"),
                          debug_locks.DebugCondition)

    def test_lock_inversion_cycle_reported(self, clean_lock_graph):
        a = debug_locks.DebugLock("A")
        b = debug_locks.DebugLock("B")
        # Thread 1 order: A -> B.
        with a:
            with b:
                pass
        assert debug_locks.detected_cycles() == []
        # Thread 2 order: B -> A — the classic inversion.  Sequential
        # execution keeps the test deterministic; the GRAPH still gains
        # the B->A edge that closes the cycle.
        done = []

        def thread2():
            with b:
                with a:
                    done.append(True)

        t = threading.Thread(target=thread2, daemon=True, name="inverter")
        t.start()
        t.join(timeout=10)
        assert done == [True]
        cycles = debug_locks.detected_cycles()
        assert len(cycles) == 1
        assert set(cycles[0]) == {"A", "B"}
        report = debug_locks.lock_order_report()
        assert "B" in report["edges"].get("A", [])
        assert "A" in report["edges"].get("B", [])

    def test_no_cycle_for_consistent_order(self, clean_lock_graph):
        a = debug_locks.DebugLock("A")
        b = debug_locks.DebugLock("B")
        for _ in range(3):
            with a:
                with b:
                    pass
        assert debug_locks.detected_cycles() == []

    def test_try_acquire_records_no_edge(self, clean_lock_graph):
        # blocking=False cannot deadlock (it fails instead of waiting),
        # so the deadlock-avoidance try-lock pattern must not produce a
        # false cycle report.
        a = debug_locks.DebugLock("A")
        b = debug_locks.DebugLock("B")
        with a:
            with b:
                pass
        with b:
            assert a.acquire(blocking=False)
            a.release()
        assert debug_locks.detected_cycles() == []
        assert "A" not in debug_locks.lock_order_report()["edges"].get(
            "B", []
        )

    def test_untimed_condition_wait_reported(self, clean_lock_graph):
        cond = debug_locks.DebugCondition("C")
        waited = threading.Event()

        def waiter():
            with cond:
                waited.set()
                cond.wait()  # untimed on purpose

        t = threading.Thread(target=waiter, daemon=True, name="waiter")
        t.start()
        assert waited.wait(5)
        with cond:
            cond.notify_all()
        t.join(timeout=5)
        assert not t.is_alive()
        assert "C" in debug_locks.lock_order_report()["untimed_wait_sites"]

    def test_timed_wait_not_reported(self, clean_lock_graph):
        cond = debug_locks.DebugCondition("D")
        with cond:
            cond.wait(0.01)
        assert debug_locks.lock_order_report()["untimed_wait_sites"] == []

    def test_contended_acquire_does_not_self_deadlock(self, clean_lock_graph):
        """Regression: DebugLock's contended-acquire path records a
        histogram through metrics._record -> `with metrics._lock:`.  If the
        metrics registry lock were itself a DebugLock, that push would
        re-enter the lock the thread just acquired and hang forever — so
        metrics._lock must stay a raw threading.Lock."""
        from ray_tpu_torch.util import metrics

        assert isinstance(metrics._lock, type(threading.Lock())), (
            "metrics._lock must be a raw lock (see metrics.py comment)"
        )
        outer = debug_locks.DebugLock("outer")
        inner = debug_locks.DebugLock("inner")
        release_inner = threading.Event()
        inner_held = threading.Event()

        def holder():
            with inner:
                inner_held.set()
                release_inner.wait(10)

        def victim():
            # Holds `outer` while contending on `inner` — the exact path
            # that records ray_tpu_debug_lock_held_blocked_wait_s.
            with outer:
                with inner:
                    pass

        h = threading.Thread(target=holder, daemon=True, name="holder")
        v = threading.Thread(target=victim, daemon=True, name="victim")
        h.start()
        assert inner_held.wait(5)
        v.start()
        import time as _time

        _time.sleep(0.2)  # let the victim enter the contended acquire
        release_inner.set()
        v.join(timeout=10)
        h.join(timeout=10)
        assert not v.is_alive(), "contended DebugLock acquire deadlocked"


# ------------------------------------------------------------ tier-1 gate
class TestPackageClean:
    def test_package_clean(self):
        """The whole ray_tpu_torch package lints clean against the checked-in
        waiver file — the gate every later change runs under."""
        pkg = os.path.dirname(os.path.dirname(os.path.abspath(lint.__file__)))
        violations, waivers = lint.run(
            [pkg], lint.default_waiver_file(), check_docs=True
        )
        unwaived = [v for v in violations if not v.waived]
        assert unwaived == [], "\n" + "\n".join(
            v.render() for v in unwaived
        )
        unused = [w for w in waivers if not w.used]
        assert unused == [], (
            "unused waiver entries (delete them): "
            + ", ".join(f"{','.join(w.rules)} {w.path}" for w in unused)
        )

    def test_cli_exit_zero_on_package(self, capsys):
        pkg = os.path.dirname(os.path.dirname(os.path.abspath(lint.__file__)))
        assert lint.main([pkg]) == 0

    def test_cli_exit_one_on_violation(self, tmp_path, capsys):
        bad = tmp_path / "bad.py"
        bad.write_text("import threading\nt = threading.Thread()\n")
        assert lint.main(["--no-waivers", str(bad)]) == 1
        out = capsys.readouterr().out
        assert "RTL002" in out

    def test_list_rules(self, capsys):
        assert lint.main(["--list-rules"]) == 0
        out = capsys.readouterr().out
        for rule_id in lint.RULES:
            assert rule_id in out


# ---------------------------------------------- parity with the JAX lint
def _jax_test_snippets():
    """The fixture sources of the JAX lint tests, by test: every constant
    source given to ``run_lint`` (``tests/test_raylint.py``) and each
    test's constant ``write`` calls (``tests/test_raylint_v2.py``), as
    ``{test id: [(file name, source)]}``."""
    import ast

    here = os.path.dirname(os.path.abspath(__file__))
    found = {}
    for mod, fn, name_at, src_at in (("test_raylint.py", "run_lint", None, 1),
                                     ("test_raylint_v2.py", "write", 1, 2)):
        tree = ast.parse(open(os.path.join(here, mod)).read())
        for test in ast.walk(tree):
            if not (isinstance(test, ast.FunctionDef)
                    and test.name.startswith("test_")):
                continue
            files = []
            for call in ast.walk(test):
                if not (isinstance(call, ast.Call)
                        and getattr(call.func, "id", None) == fn
                        and len(call.args) > src_at
                        and isinstance(call.args[src_at], ast.Constant)):
                    continue
                name = ("snippet.py" if name_at is None
                        else call.args[name_at].value)
                files.append((name, call.args[src_at].value))
            if not files:
                continue
            key = f"{mod}::{test.name}"
            if fn == "run_lint":
                found.update({f"{key}[{i}]": [f]
                              for i, f in enumerate(files)})
            else:
                found[key] = files
    return found


SNIPPETS = _jax_test_snippets()


def test_snippets_cover_every_rule_file():
    assert len(SNIPPETS) >= 40
    assert any(k.startswith("test_raylint_v2.py") for k in SNIPPETS)


@pytest.mark.parametrize("test_id", sorted(SNIPPETS))
def test_same_findings_as_the_jax_lint(tmp_path, test_id):
    """The JAX lint on the snippet under ``ray_tpu/core/`` and the port's on
    its name-moved copy under ``ray_tpu_torch/core/`` flag the same rules
    at the same lines."""
    import re

    from ray_tpu.devtools import lint as jax_lint

    def findings(linter, pkg, move):
        root = tmp_path / pkg / "core"
        for name, source in SNIPPETS[test_id]:
            path = root / name
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(move(textwrap.dedent(source)))
        violations, _ = linter.run([str(root)], None, check_docs=False)
        return sorted((os.path.relpath(v.path, root), v.line, v.rule)
                      for v in violations)

    want = findings(jax_lint, "ray_tpu", lambda s: s)
    got = findings(lint, "ray_tpu_torch",
                   lambda s: re.sub(r"\bray_tpu\b", "ray_tpu_torch", s))
    assert got == want


def test_package_name_is_no_metric(tmp_path):
    """The one pinned divergence: the package's own name is not taken for
    a metric name, and a ``ray_tpu_torch_*`` name still is."""
    vs = run_lint(tmp_path, """
        LOG_DIR = "ray_tpu_torch"
        METRIC = "ray_tpu_torch_not_a_registered_metric_total"
    """)
    assert [(v.rule, v.line) for v in vs] == [("RTL004", 3)]


# --------------------------------------------------- data/ lints clean
class TestRaylintClean:
    def test_streaming_module_lints_clean(self):
        """The port's streaming module carries zero waivers, as the JAX
        module does."""
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        target = os.path.join(root, "ray_tpu_torch", "data", "streaming.py")
        violations, _ = lint.run(
            [target], lint.default_waiver_file(), check_docs=False
        )
        assert [v for v in violations if not v.waived] == []
        assert [v for v in violations if v.waived] == []  # zero waivers

    def test_data_package_lints_clean(self):
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        violations, _ = lint.run(
            [os.path.join(root, "ray_tpu_torch", "data")],
            lint.default_waiver_file(), check_docs=False,
        )
        assert [v.render() for v in violations if not v.waived] == []

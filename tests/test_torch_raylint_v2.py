"""raylint v2 (interprocedural) on the port: the twin of
``tests/test_raylint_v2.py``, case for case, with the two name moves
(``ray_tpu`` → ``ray_tpu_torch``, ``RAY_TPU_`` → ``RAY_TPU_TORCH_``):
RTL007-RTL011, the call-graph / effect-inference machinery, the --changed
cache, --json output, and the wire-contract mutation test against the
port's real core/ tree.

Per rule: one known-bad fixture proving it fires, one known-good fixture
proving it stays quiet — plus the inference edge cases (call cycles,
decorated methods, getattr dispatch falling back to unknown instead of
guessing).
"""

import json
import os
import shutil
import textwrap
import time

import pytest

from ray_tpu_torch.devtools import lint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def write(tmp_path, name, source):
    path = tmp_path / name
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(source))
    return str(path)


def run_dir(tmp_path, waiver_file=None, **kw):
    violations, _ = lint.run([str(tmp_path)], waiver_file,
                             check_docs=False, **kw)
    return violations


def rules_fired(violations, only_unwaived=True):
    return sorted({
        v.rule for v in violations if not (only_unwaived and v.waived)
    })


# ---------------------------------------------------------------- RTL007
class TestRTL007LaneSafety:
    def test_bad_direct_mutation(self, tmp_path):
        write(tmp_path, "svc.py", """
            class Svc:
                LANE_SAFE_METHODS = frozenset({"probe"})

                def handle_probe(self, payload, conn):
                    self.stats[payload["k"]] = 1
                    return True
        """)
        vs = run_dir(tmp_path)
        assert "RTL007" in rules_fired(vs)

    def test_bad_transitive_mutation(self, tmp_path):
        write(tmp_path, "svc.py", """
            class Svc:
                LANE_SAFE_METHODS = frozenset({"probe"})

                def handle_probe(self, payload, conn):
                    return self._lookup(payload)

                def _lookup(self, payload):
                    return self._bump(payload)

                def _bump(self, payload):
                    self.hits += 1
                    return self.table.get(payload["k"])
        """)
        vs = run_dir(tmp_path)
        hits = [v for v in vs if v.rule == "RTL007"]
        assert hits, "mutation two calls deep must be reached"
        assert "handle_probe" in hits[0].message
        assert "_bump" in hits[0].message  # chain is reported

    def test_bad_alias_mutation(self, tmp_path):
        # `job = self.jobs.get(...)`: writes through the alias are writes
        # to the shared dict (the real control_plane finding).
        write(tmp_path, "svc.py", """
            import time

            class Svc:
                LANE_SAFE_METHODS = frozenset({"beat"})

                def handle_beat(self, payload, conn):
                    job = self.jobs.get(payload["job_id"])
                    if job is None:
                        return {"ok": False}
                    job["t"] = time.monotonic()
                    return {"ok": True}
        """)
        vs = run_dir(tmp_path)
        assert "RTL007" in rules_fired(vs)

    def test_good_fresh_object_not_aliased(self, tmp_path):
        # Only accessor methods return views; info() hands back a fresh
        # dict, so mutating it is private (the get_named_actor shape).
        write(tmp_path, "svc.py", """
            class Svc:
                LANE_SAFE_METHODS = frozenset({"lookup"})

                def handle_lookup(self, payload, conn):
                    entry = self.actors.get(payload["k"])
                    info = entry.info()
                    info["spec"] = entry.spec
                    return info
        """)
        vs = run_dir(tmp_path)
        assert "RTL007" not in rules_fired(vs)

    def test_good_locked_mutation(self, tmp_path):
        write(tmp_path, "svc.py", """
            class Svc:
                LANE_SAFE_METHODS = frozenset({"probe"})

                def handle_probe(self, payload, conn):
                    with self._stats_lock:
                        self.stats[payload["k"]] = 1
                    return True
        """)
        vs = run_dir(tmp_path)
        assert "RTL007" not in rules_fired(vs)

    def test_good_shard_lock_accessor(self, tmp_path):
        # `with self.owned.shard_lock(oid):` — the OwnerTable contract.
        write(tmp_path, "svc.py", """
            class Svc:
                LANE_SAFE_METHODS = frozenset({"adopt"})

                def handle_adopt(self, payload, conn):
                    oid = payload["oid"]
                    with self.owned.shard_lock(oid):
                        self.owned[oid] = payload["entry"]
                    return True
        """)
        vs = run_dir(tmp_path)
        assert "RTL007" not in rules_fired(vs)

    def test_good_forward_to_primary(self, tmp_path):
        write(tmp_path, "svc.py", """
            class Svc:
                LANE_SAFE_METHODS = frozenset({"probe"})

                def handle_probe(self, payload, conn):
                    fast = self.table.get(payload["k"])
                    if fast is not None:
                        return fast
                    return ForwardToPrimary(lambda: self._slow(payload))

                def _slow(self, payload):
                    self.stats[payload["k"]] = 1
        """)
        vs = run_dir(tmp_path)
        # The mutation lives in _slow, reached only through the forward
        # factory — which runs on the primary loop, outside the contract.
        assert "RTL007" not in rules_fired(vs)

    def test_non_lane_safe_methods_unconstrained(self, tmp_path):
        write(tmp_path, "svc.py", """
            class Svc:
                LANE_SAFE_METHODS = frozenset({"probe"})

                def handle_probe(self, payload, conn):
                    return self.table.get(payload["k"])

                def handle_mutate(self, payload, conn):
                    self.table[payload["k"]] = payload["v"]
                    return True
        """)
        vs = run_dir(tmp_path)
        assert "RTL007" not in rules_fired(vs)


# ---------------------------------------------------------------- RTL008
class TestRTL008SpmdLockstep:
    def test_bad_rank_gated_collective(self, tmp_path):
        write(tmp_path, "coll.py", """
            class Worker:
                def step(self, x):
                    if self.rank == 0:
                        return self.group.allreduce(x)
                    return x
        """)
        vs = run_dir(tmp_path)
        assert "RTL008" in rules_fired(vs)

    def test_bad_env_gated_tuner_observe(self, tmp_path):
        write(tmp_path, "coll.py", """
            import os

            class Worker:
                def step(self, bucket, us):
                    if os.environ.get("FAST_HOST"):
                        self.tuner.observe(bucket, us)
        """)
        vs = run_dir(tmp_path)
        assert "RTL008" in rules_fired(vs)

    def test_bad_transitive_through_helper(self, tmp_path):
        write(tmp_path, "coll.py", """
            import time

            class Worker:
                def step(self, x):
                    if time.monotonic() > self.deadline:
                        self._sync(x)

                def _sync(self, x):
                    self.group.allreduce(x)
        """)
        vs = run_dir(tmp_path)
        hits = [v for v in vs if v.rule == "RTL008"]
        assert hits
        assert "_sync" in hits[0].message

    def test_good_unconditional(self, tmp_path):
        write(tmp_path, "coll.py", """
            class Worker:
                def step(self, x):
                    self.tuner.observe("b0", 12.5)
                    return self.group.allreduce(x)
        """)
        vs = run_dir(tmp_path)
        assert "RTL008" not in rules_fired(vs)

    def test_good_replicated_condition(self, tmp_path):
        # Conditioned on replicated state (same on every member): fine.
        write(tmp_path, "coll.py", """
            class Worker:
                def step(self, x, n_items):
                    if n_items > 0:
                        return self.group.allreduce(x)
                    return x
        """)
        vs = run_dir(tmp_path)
        assert "RTL008" not in rules_fired(vs)


# ---------------------------------------------------------------- RTL009
CLIENT_AND_SERVICE = """
    class FakeControlPlane:
        LANE_SAFE_METHODS = frozenset({%(lane_safe)s})

        def handle_kv_put(self, payload, conn):
            return True

        %(async_kw)sdef handle_kv_get(self, payload, conn):
            return self.kv.get(payload["k"])

    class Client:
        async def put(self, k, v):
            return await self.cp.call(%(method)r, {"k": k, "v": v})
"""


def client_service(lane_safe='"kv_get"', method="kv_put", async_kw=""):
    return textwrap.dedent(CLIENT_AND_SERVICE) % {
        "lane_safe": lane_safe, "method": method, "async_kw": async_kw,
    }


class TestRTL009WireContract:
    def test_good_known_method(self, tmp_path):
        write(tmp_path, "wire.py", client_service())
        assert "RTL009" not in rules_fired(run_dir(tmp_path))

    def test_bad_stale_method_name(self, tmp_path):
        write(tmp_path, "wire.py", client_service(method="kv_putt"))
        vs = run_dir(tmp_path)
        hits = [v for v in vs if v.rule == "RTL009"]
        assert hits
        assert "kv_putt" in hits[0].message

    def test_bad_lane_safe_entry_without_handler(self, tmp_path):
        write(tmp_path, "wire.py", client_service(lane_safe='"kv_getz"'))
        vs = run_dir(tmp_path)
        assert any(v.rule == "RTL009" and "kv_getz" in v.message
                   for v in vs)

    def test_bad_async_lane_safe_handler(self, tmp_path):
        write(tmp_path, "wire.py", client_service(async_kw="async "))
        vs = run_dir(tmp_path)
        assert any(v.rule == "RTL009" and "async" in v.message
                   for v in vs)

    def test_bad_oneway_handler_returns_value(self, tmp_path):
        write(tmp_path, "wire.py", """
            class FakeAgent:
                def handle_seal(self, payload, conn):
                    self.log(payload)
                    return True

            class Client:
                def fire(self, agent):
                    agent.notify("seal", {})
        """)
        vs = run_dir(tmp_path)
        assert any(v.rule == "RTL009" and "oneway" in v.message
                   for v in vs)

    def test_good_oneway_bare_return(self, tmp_path):
        write(tmp_path, "wire.py", """
            class FakeAgent:
                def handle_seal(self, payload, conn):
                    if not payload:
                        return
                    self.log(payload)

            class Client:
                def fire(self, agent):
                    agent.notify("seal", {})
        """)
        assert "RTL009" not in rules_fired(run_dir(tmp_path))

    def test_good_two_way_method_may_return(self, tmp_path):
        # Called via .call somewhere -> the return is meaningful even if
        # other sites notify the same method.
        write(tmp_path, "wire.py", """
            class FakeAgent:
                def handle_seal(self, payload, conn):
                    return True

            class Client:
                def fire(self, agent):
                    agent.notify("seal", {})

                async def fire_sync(self, agent):
                    return await agent.call("seal", {})
        """)
        assert "RTL009" not in rules_fired(run_dir(tmp_path))

    def test_protocol_methods_exempt(self, tmp_path):
        write(tmp_path, "wire.py", """
            class FakeAgent:
                def handle_ping(self, payload, conn):
                    return True

            class Client:
                def hello(self, agent):
                    agent.notify("__hello__", {})
        """)
        assert "RTL009" not in rules_fired(run_dir(tmp_path))

    def test_no_handlers_in_batch_no_checks(self, tmp_path):
        # A lone client file (subset lint) has no service classes to
        # check against: stay quiet instead of guessing.
        write(tmp_path, "client.py", """
            class Client:
                async def put(self, k):
                    return await self.cp.call("kv_put", {"k": k})
        """)
        assert "RTL009" not in rules_fired(run_dir(tmp_path))


# ---------------------------------------------------------------- RTL010
class TestRTL010AsyncBlockingTransitive:
    def test_bad_blocking_two_frames_down(self, tmp_path):
        write(tmp_path, "srv.py", """
            import time

            class Srv:
                async def handle_pull(self, payload, conn):
                    return self._fetch(payload["k"])

                def _fetch(self, k):
                    return self._wait_for(k)

                def _wait_for(self, k):
                    time.sleep(0.5)
                    return self.table[k]
        """)
        vs = run_dir(tmp_path)
        hits = [v for v in vs if v.rule == "RTL010"]
        assert hits
        assert "_wait_for" in hits[0].message

    def test_bad_cross_module(self, tmp_path):
        write(tmp_path, "helper.py", """
            import time

            def fetch_slow(k):
                time.sleep(0.5)
                return k
        """)
        write(tmp_path, "srv.py", """
            from helper import fetch_slow

            class Srv:
                async def handle_pull(self, payload, conn):
                    return fetch_slow(payload["k"])
        """)
        assert "RTL010" in rules_fired(run_dir(tmp_path))

    def test_good_nonblocking_chain(self, tmp_path):
        write(tmp_path, "srv.py", """
            class Srv:
                async def handle_pull(self, payload, conn):
                    return self._fetch(payload["k"])

                def _fetch(self, k):
                    return self.table.get(k)
        """)
        assert "RTL010" not in rules_fired(run_dir(tmp_path))

    def test_good_nowait_variant(self, tmp_path):
        # queue.get_nowait() internally gates its blocking branch off;
        # the path-insensitive propagation must not drag it in.
        write(tmp_path, "q.py", """
            import time

            class Queue:
                def get(self, block=True):
                    if block:
                        time.sleep(0.01)
                    return self.items.pop()

                def get_nowait(self):
                    return self.get(block=False)

            class Srv:
                def __init__(self):
                    self.q = Queue()

                async def handle_poll(self, payload, conn):
                    return self.q.get_nowait()
        """)
        assert "RTL010" not in rules_fired(run_dir(tmp_path))

    def test_good_sync_caller_not_flagged(self, tmp_path):
        write(tmp_path, "srv.py", """
            import time

            class Srv:
                def pull(self, k):
                    return self._wait_for(k)

                def _wait_for(self, k):
                    time.sleep(0.5)
                    return k
        """)
        assert "RTL010" not in rules_fired(run_dir(tmp_path))


# ------------------------------------------- call graph / effect inference
class TestCallGraphInference:
    def test_call_cycle_terminates(self, tmp_path):
        write(tmp_path, "cyc.py", """
            import time

            def ping(n):
                if n:
                    return pong(n - 1)
                time.sleep(0.1)

            def pong(n):
                return ping(n)

            class Srv:
                async def handle_spin(self, payload, conn):
                    return ping(3)
        """)
        vs = run_dir(tmp_path)  # must not loop forever
        assert "RTL010" in rules_fired(vs)

    def test_decorated_methods_still_resolve(self, tmp_path):
        write(tmp_path, "deco.py", """
            import functools

            def logged(fn):
                @functools.wraps(fn)
                def inner(*a, **k):
                    return fn(*a, **k)
                return inner

            class Svc:
                LANE_SAFE_METHODS = frozenset({"probe"})

                def handle_probe(self, payload, conn):
                    return self._bump()

                @logged
                def _bump(self):
                    self.hits += 1
        """)
        assert "RTL007" in rules_fired(run_dir(tmp_path))

    def test_getattr_dispatch_falls_back_to_unknown(self, tmp_path):
        # Dynamic dispatch produces NO edge: the analysis neither guesses
        # (false positives) nor crashes — it degrades to unknown.
        write(tmp_path, "dyn.py", """
            class Svc:
                LANE_SAFE_METHODS = frozenset({"probe"})

                def handle_probe(self, payload, conn):
                    fn = getattr(self, "helper_" + payload["kind"])
                    return fn(payload)

                def helper_write(self, payload):
                    self.stats[payload["k"]] = 1
        """)
        vs = run_dir(tmp_path)
        assert "RTL007" not in rules_fired(vs)

    def test_attr_receiver_resolution_via_ctor_type(self, tmp_path):
        # `self.store = Store()` types the attribute; `self.store.put()`
        # resolves to Store.put.
        write(tmp_path, "attr.py", """
            import time

            class Store:
                def put(self, k, v):
                    time.sleep(0.01)
                    self.d[k] = v

            class Srv:
                def __init__(self):
                    self.store = Store()

                async def handle_put(self, payload, conn):
                    self.store.put(payload["k"], payload["v"])
        """)
        assert "RTL010" in rules_fired(run_dir(tmp_path))

    def test_inherited_handler_found(self, tmp_path):
        write(tmp_path, "inh.py", """
            class Base:
                def handle_ping(self, payload, conn):
                    return True

            class FakeAgent(Base):
                LANE_SAFE_METHODS = frozenset({"ping"})

            class Client:
                def go(self, agent):
                    agent.notify("ping", {})
        """)
        vs = run_dir(tmp_path)
        assert not [v for v in vs if v.rule == "RTL009"
                    and "names no existing handler" in v.message]


# ------------------------------------------------------- RTL011 / expiry
class TestWaiverExpiry:
    BAD = """
        import time

        def f(self):
            with self._lock:
                time.sleep(1.0)
    """

    def waiver(self, tmp_path, expires):
        wf = tmp_path / "waivers.toml"
        wf.write_text(textwrap.dedent(f"""
            [[waiver]]
            rule = "RTL001"
            path = "snippet.py"
            contains = "time.sleep"
            reason = "fixture"
            date = "2026-08-07"
            expires = "{expires}"
        """))
        return str(wf)

    def test_unexpired_waiver_suppresses(self, tmp_path):
        write(tmp_path, "snippet.py", self.BAD)
        wf = self.waiver(tmp_path, "2099-01-01")
        vs = run_dir(tmp_path, waiver_file=wf)
        assert rules_fired(vs) == []
        assert any(v.rule == "RTL001" and v.waived for v in vs)

    def test_expired_waiver_errors_and_resurfaces(self, tmp_path):
        write(tmp_path, "snippet.py", self.BAD)
        wf = self.waiver(tmp_path, "2020-01-01")
        vs = run_dir(tmp_path, waiver_file=wf)
        fired = rules_fired(vs)
        assert "RTL011" in fired      # the expiry itself is an error
        assert "RTL001" in fired      # and the site resurfaces

    def test_rtl011_not_waivable(self, tmp_path):
        write(tmp_path, "snippet.py", self.BAD)
        wf = tmp_path / "waivers.toml"
        wf.write_text(textwrap.dedent("""
            [[waiver]]
            rule = "RTL001"
            path = "snippet.py"
            contains = "time.sleep"
            reason = "fixture"
            date = "2026-08-07"
            expires = "2020-01-01"

            [[waiver]]
            rule = "RTL011"
            path = "waivers.toml"
            reason = "nope"
            date = "2026-08-07"
        """))
        vs = run_dir(tmp_path, waiver_file=str(wf))
        assert "RTL011" in rules_fired(vs)

    def test_malformed_expires_rejected(self, tmp_path):
        wf = tmp_path / "waivers.toml"
        wf.write_text(textwrap.dedent("""
            [[waiver]]
            rule = "RTL001"
            path = "x.py"
            reason = "r"
            date = "2026-08-07"
            expires = "soon"
        """))
        with pytest.raises(lint.WaiverError, match="expires"):
            lint.parse_waivers(str(wf))


# ----------------------------------------------------- cache / CLI modes
class TestIncrementalCache:
    BAD = """
        import time

        def f(self):
            with self._lock:
                time.sleep(1.0)
    """
    GOOD = """
        import time

        def f(self):
            time.sleep(1.0)
    """

    def test_changed_mode_reuses_and_invalidate(self, tmp_path):
        src = tmp_path / "pkg" / "mod.py"
        src.parent.mkdir()
        src.write_text(textwrap.dedent(self.BAD))
        cache = str(tmp_path / "cache.json")

        vs1, _ = lint.run([str(src.parent)], None, check_docs=False,
                          changed_only=True, cache_file=cache)
        assert "RTL001" in rules_fired(vs1)
        assert os.path.exists(cache)

        # Warm run: served from cache, same answer.
        vs2, _ = lint.run([str(src.parent)], None, check_docs=False,
                          changed_only=True, cache_file=cache)
        assert rules_fired(vs2) == rules_fired(vs1)

        # Edit fixes the violation: the cache must notice.
        src.write_text(textwrap.dedent(self.GOOD))
        vs3, _ = lint.run([str(src.parent)], None, check_docs=False,
                          changed_only=True, cache_file=cache)
        assert "RTL001" not in rules_fired(vs3)

    def test_touch_without_edit_stays_cached_and_correct(self, tmp_path):
        src = tmp_path / "pkg" / "mod.py"
        src.parent.mkdir()
        src.write_text(textwrap.dedent(self.BAD))
        cache = str(tmp_path / "cache.json")
        lint.run([str(src.parent)], None, check_docs=False,
                 changed_only=True, cache_file=cache)
        os.utime(src, (time.time() + 5, time.time() + 5))  # mtime bump
        vs, _ = lint.run([str(src.parent)], None, check_docs=False,
                         changed_only=True, cache_file=cache)
        assert "RTL001" in rules_fired(vs)

    def test_global_rules_rerun_over_cached_summaries(self, tmp_path):
        # File A (client) cached, file B (service) edited: the wire
        # contract must still see A's call site.
        svc = tmp_path / "pkg" / "svc.py"
        svc.parent.mkdir()
        cli = tmp_path / "pkg" / "cli.py"
        svc.write_text(textwrap.dedent("""
            class FakeAgent:
                def handle_seal(self, payload, conn):
                    return None
        """))
        cli.write_text(textwrap.dedent("""
            class Client:
                def go(self, agent):
                    agent.notify("seal", {})
        """))
        cache = str(tmp_path / "cache.json")
        vs1, _ = lint.run([str(svc.parent)], None, check_docs=False,
                          changed_only=True, cache_file=cache)
        assert "RTL009" not in rules_fired(vs1)
        # Rename the handler; only svc.py re-analyzes, cli.py comes from
        # cache — the stale call site must still be caught.
        svc.write_text(textwrap.dedent("""
            class FakeAgent:
                def handle_sealed(self, payload, conn):
                    return None
        """))
        vs2, _ = lint.run([str(svc.parent)], None, check_docs=False,
                          changed_only=True, cache_file=cache)
        assert "RTL009" in rules_fired(vs2)

    def test_json_output(self, tmp_path, capsys):
        src = write(tmp_path, "mod.py", self.BAD)
        rc = lint.main([src, "--json", "--no-docs-check", "--no-waivers"])
        out = json.loads(capsys.readouterr().out)
        assert rc == 1
        assert out["unwaived"] >= 1
        assert any(v["rule"] == "RTL001" for v in out["violations"])


# ------------------------------------------- the real tree: mutation test
CORE_FILES = ("core_worker.py", "control_plane.py", "node_agent.py",
              "rpc.py", "owner_table.py", "cp_ha.py")


def _copy_core(tmp_path):
    dst = tmp_path / "ray_tpu_torch" / "core"
    dst.mkdir(parents=True)
    for name in CORE_FILES:
        shutil.copy(os.path.join(REPO, "ray_tpu_torch", "core", name),
                    dst / name)
    return dst


class TestWireContractMutation:
    """Acceptance: renaming a real handler makes RTL009 fail; restoring
    it lints clean — proof the wire-contract rule fires on the real
    tree, not just on fixtures."""

    def test_rename_handler_fires_rtl009(self, tmp_path):
        dst = _copy_core(tmp_path)
        waivers = os.path.join(REPO, "ray_tpu_torch", "devtools",
                               "lint_waivers.toml")
        baseline = run_dir(dst, waiver_file=waivers)
        assert rules_fired(baseline) == [], [
            v.render() for v in baseline if not v.waived
        ]

        agent = dst / "node_agent.py"
        src = agent.read_text()
        assert "def handle_seal_object(" in src
        agent.write_text(src.replace("def handle_seal_object(",
                                     "def handle_seal_object_renamed("))
        mutated = run_dir(dst, waiver_file=waivers)
        hits = [v for v in mutated if v.rule == "RTL009" and not v.waived]
        assert hits, "renaming a live handler must trip RTL009"
        assert any("seal_object" in v.message for v in hits)

        agent.write_text(src)  # restore -> clean again
        assert rules_fired(run_dir(dst, waiver_file=waivers)) == []

    def test_lane_safe_entry_rot_fires_rtl009(self, tmp_path):
        dst = _copy_core(tmp_path)
        waivers = os.path.join(REPO, "ray_tpu_torch", "devtools",
                               "lint_waivers.toml")
        cw = dst / "core_worker.py"
        src = cw.read_text()
        assert '"probe_object",' in src
        cw.write_text(src.replace('"probe_object",',
                                  '"probe_objectt",', 1))
        mutated = run_dir(dst, waiver_file=waivers)
        assert any(v.rule == "RTL009" and "probe_objectt" in v.message
                   for v in mutated if not v.waived)

    def test_unlocked_lane_mutation_fires_rtl007(self, tmp_path):
        # Strip the heartbeat lock from the real control plane: the exact
        # regression this lock guards against must be caught if
        # reintroduced.
        dst = _copy_core(tmp_path)
        waivers = os.path.join(REPO, "ray_tpu_torch", "devtools",
                               "lint_waivers.toml")
        cp = dst / "control_plane.py"
        src = cp.read_text()
        guarded = ("        with self._heartbeat_lock:\n"
                   "            job[\"last_heartbeat\"] = time.monotonic()")
        assert guarded in src
        cp.write_text(src.replace(
            guarded, "        job[\"last_heartbeat\"] = time.monotonic()"))
        mutated = run_dir(dst, waiver_file=waivers)
        assert any(v.rule == "RTL007" and "job_heartbeat" in v.message
                   for v in mutated if not v.waived)

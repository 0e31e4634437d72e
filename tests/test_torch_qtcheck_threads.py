"""qtcheck-threads of the port: the static lock-discipline auditor
(``quintnet_tpu_torch/analysis/threads.py``), its committed baseline
gate, and the instrumented-lock runtime (``analysis/lockrt.py``).

JAX's ``tests/test_qtcheck_threads.py``, every function ported:

- **synthetic rules** — QT201 (lock-order cycles, lexical and
  interprocedural), QT202 (guarded-by inference on thread-reachable
  paths), QT203 (spawn census, BOTH directions), and the
  ``# qtcheck: ok[RULE]`` pragma contract, over in-memory sources;
- **repo gate** — the committed
  ``quintnet_tpu_torch/tools/qtcheck_threads_baseline.json`` matches the
  port's tree EXACTLY, every entry carries a note, the lock-order graph
  (``ops/``'s build and launch-count locks included) is cycle-free, and
  a seeded inverted acquisition IS caught;
- **runtime** — ``LockOrderError`` on the second edge direction naming
  both stacks, ledgers under an injected clock, the held-too-long
  watchdog, the Condition protocol, and an 8-thread ``AdmissionQueue``
  stress behind one ``InstrumentedLock``;
- **fleet** — ``lock_audit=True`` is inert: the kill-migration golden
  stays token-equal to its oracle (which the unaudited golden of
  ``tests/test_torch_fleet.py`` pins), with no order violation under
  real chaos, and the ``quintnet_lock_*`` families pass the strict
  exposition parser. The process-fleet SIGKILL twin is slow, as JAX's.

On top: the port's pass and JAX's (loaded by file path) give the same
findings, path prefix aside, on JAX's tree and on the port's
``fleet/serve/obs``, and the two ``LockAudit`` runtimes give equal
``summary()`` dicts for one injected-clock script.
"""

import importlib.util
import sys
import ast
import json
import os
import textwrap
import threading
import time

import numpy as np
import pytest

from quintnet_tpu_torch.analysis.lint import (SourceFile, collect_sources,
                                              compare_baseline,
                                              load_baseline,
                                              violations_to_baseline)
from quintnet_tpu_torch.analysis.lockrt import (InstrumentedLock, LockAudit,
                                                LockOrderError)
from quintnet_tpu_torch.analysis.threads import (THREAD_PATHS, audit_parsed,
                                                 audit_paths, audit_sources,
                                                 load_thread_specs,
                                                 thread_spawn_census)
from quintnet_tpu_torch.fleet import AdmissionQueue, Overloaded

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "quintnet_tpu_torch", "tools")
BASELINE = os.path.join(TOOLS, "qtcheck_threads_baseline.json")
LINT_BASELINE = os.path.join(TOOLS, "qtcheck_baseline.json")


def _src(text):
    return textwrap.dedent(text).strip() + "\n"


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


# ---------------------------------------------------------------------
# QT201: lock-order cycles
# ---------------------------------------------------------------------

_CYCLE = _src("""
    import threading

    class S:
        def __init__(self):
            self._a = threading.Lock()
            self._b = threading.Lock()

        def fwd(self):
            with self._a:
                with self._b:
                    pass

        def rev(self):
            with self._b:
                with self._a:
                    pass
""")


class TestQT201:
    def test_inverted_acquisition_names_both_chains(self):
        vs = audit_sources([("pkg/mod.py", _CYCLE)], rules=["QT201"])
        assert len(vs) == 1
        v = vs[0]
        assert v.rule == "QT201"
        # the finding names BOTH locks and BOTH directions' call chains
        assert "pkg/mod.py:S._a" in v.symbol
        assert "pkg/mod.py:S._b" in v.symbol
        assert " <-> " in v.symbol
        assert v.message.startswith("lock-order cycle (")
        assert "S.fwd" in v.message and "S.rev" in v.message
        assert "->" in v.message

    def test_consistent_order_is_clean(self):
        one_way = _CYCLE.replace("with self._b:\n            with "
                                 "self._a:\n                pass",
                                 "pass")
        vs = audit_sources([("pkg/mod.py", one_way)], rules=["QT201"])
        assert vs == []

    def test_pragma_suppresses_the_edge(self):
        # suppressing the b->a edge at its acquisition site breaks the
        # cycle: pragma honored exactly like the lint rules
        pragmad = _CYCLE.replace(
            "with self._b:\n            with self._a:",
            "with self._b:\n            with self._a:"
            "  # qtcheck: ok[QT201]")
        assert pragmad != _CYCLE
        vs = audit_sources([("pkg/mod.py", pragmad)], rules=["QT201"])
        assert vs == []

    def test_interprocedural_cycle_via_resolved_call(self):
        """Holding B while CALLING a method that acquires A is a B->A
        edge — the bounded call-graph half of the pass."""
        src = _src("""
            import threading

            class S:
                def __init__(self):
                    self._a = threading.Lock()
                    self._b = threading.Lock()

                def fwd(self):
                    with self._a:
                        with self._b:
                            pass

                def rev(self):
                    with self._b:
                        self._grab()

                def _grab(self):
                    with self._a:
                        pass
            """)
        vs = audit_sources([("pkg/mod.py", src)], rules=["QT201"])
        assert len(vs) == 1
        assert "_grab" in vs[0].message    # the chain is readable


# ---------------------------------------------------------------------
# QT202: guarded-by inference
# ---------------------------------------------------------------------

_GUARDED = _src("""
    import threading

    class C:
        def __init__(self):
            self._lock = threading.Lock()
            self._n = 0

        def start(self):
            t = threading.Thread(target=self._loop, daemon=True)
            t.start()

        def bump(self):
            with self._lock:
                self._n += 1

        def _loop(self):
            return self._n
""")


class TestQT202:
    def test_unguarded_read_on_thread_path_flagged(self):
        vs = audit_sources([("pkg/mod.py", _GUARDED)], rules=["QT202"])
        assert len(vs) == 1
        v = vs[0]
        assert v.symbol == "C._loop"
        assert "load of self._n" in v.message
        assert "pkg/mod.py:C._lock" in v.message
        assert "thread-reachable" in v.message

    def test_guarded_read_is_clean(self):
        fixed = _GUARDED.replace(
            "def _loop(self):\n        return self._n",
            "def _loop(self):\n        with self._lock:\n"
            "            return self._n")
        assert fixed != _GUARDED
        vs = audit_sources([("pkg/mod.py", fixed)], rules=["QT202"])
        assert vs == []

    def test_init_is_exempt_both_sides(self):
        # __init__'s unguarded write of _n classifies nothing and
        # triggers nothing: construction happens-before every thread
        vs = audit_sources([("pkg/mod.py", _GUARDED.replace(
            "def _loop(self):\n        return self._n",
            "def _loop(self):\n        pass"))], rules=["QT202"])
        assert vs == []

    def test_pragma_suppresses(self):
        pragmad = _GUARDED.replace(
            "return self._n",
            "return self._n  # qtcheck: ok[QT202]")
        vs = audit_sources([("pkg/mod.py", pragmad)], rules=["QT202"])
        assert vs == []

    def test_ambient_held_makes_locked_convention_clean(self):
        """The repo's ``*_locked`` convention: a method ONLY ever
        called with the lock held inherits it as ambient — no
        annotation needed, no false positive."""
        src = _src("""
            import threading

            class C:
                def __init__(self):
                    self._lock = threading.Lock()
                    self._n = 0

                def start(self):
                    t = threading.Thread(target=self._loop, daemon=True)
                    t.start()

                def _loop(self):
                    with self._lock:
                        self._n += 1
                        self._flush_locked()

                def _flush_locked(self):
                    return self._n
            """)
        vs = audit_sources([("pkg/mod.py", src)], rules=["QT202"])
        assert vs == []


# ---------------------------------------------------------------------
# QT203: thread-spawn census, both directions
# ---------------------------------------------------------------------

_SPAWNER = _src("""
    import threading

    class W:
        def start(self):
            self._t = threading.Thread(target=self._run, daemon=True)
            self._t.start()

        def stop(self):
            self._t.join()

        def _run(self):
            pass
""")

_SPAWN_SPEC = {"pkg/w.py": [{"symbol": "W.start", "target": "self._run",
                             "daemon": True, "joined": True}]}


class TestQT203:
    def test_census_matches_spec_clean(self):
        vs = audit_sources([("pkg/w.py", _SPAWNER)], rules=["QT203"],
                           specs=_SPAWN_SPEC)
        assert vs == []

    def test_unexpected_spawn_fails(self):
        vs = audit_sources([("pkg/w.py", _SPAWNER)], rules=["QT203"],
                           specs={})
        assert len(vs) == 1
        assert vs[0].symbol == "W.start[self._run]"
        assert "unexpected Thread spawn" in vs[0].message
        assert "THREAD_SPAWN_SPECS" in vs[0].message

    def test_stale_spec_entry_fails(self):
        specs = {"pkg/w.py": _SPAWN_SPEC["pkg/w.py"] + [
            {"symbol": "W.start", "target": "self._gone",
             "daemon": True, "joined": True}]}
        vs = audit_sources([("pkg/w.py", _SPAWNER)], rules=["QT203"],
                           specs=specs)
        assert len(vs) == 1
        assert vs[0].symbol == "W.start[self._gone]"
        assert "no longer has it" in vs[0].message

    def test_daemon_flag_mismatch_fails(self):
        specs = {"pkg/w.py": [dict(_SPAWN_SPEC["pkg/w.py"][0],
                                   daemon=False)]}
        vs = audit_sources([("pkg/w.py", _SPAWNER)], rules=["QT203"],
                           specs=specs)
        assert len(vs) == 1
        assert "daemon: spec False, tree True" in vs[0].message

    def test_census_shape(self):
        parsed = [SourceFile("pkg/w.py", _SPAWNER,
                             ast.parse(_SPAWNER))]
        census = thread_spawn_census(parsed)
        assert census == [{"module": "pkg/w.py", "symbol": "W.start",
                           "line": census[0]["line"],
                           "target": "self._run", "daemon": True,
                           "joined": True, "kind": "Thread"}]


# ---------------------------------------------------------------------
# repo gate: committed baseline == live tree, exactly
# ---------------------------------------------------------------------

class TestRepoGate:
    def test_threads_baseline_gate(self):
        """The no-drift contract, both directions: a NEW violation
        (fix it or pragma it with a note) and a STALE entry (you fixed
        one — regenerate with --write-baseline) both fail tier-1."""
        violations = audit_paths(root=REPO)
        new, stale = compare_baseline(violations,
                                      load_baseline(BASELINE))
        assert not new, f"new concurrency violations: {new}"
        assert not stale, f"stale baseline entries: {stale}"

    def test_baseline_entries_all_carry_notes(self):
        """Every grandfathered finding must say WHY it is benign — a
        baseline without justifications is just a mute button."""
        baseline = load_baseline(BASELINE)
        missing = [e for e in baseline["violations"]
                   if not e.get("note")]
        assert not missing, missing

    def test_lock_order_graph_is_cycle_free(self):
        """The acceptance bar for pool actuation: ZERO QT201 findings
        on the real tree — no baseline rides for deadlocks."""
        assert audit_paths(root=REPO, rules=["QT201"]) == []

    def test_spawn_census_matches_spec(self):
        """QT203 clean against the committed THREAD_SPAWN_SPECS — and
        the spec is non-trivial (the fleet really does spawn)."""
        assert audit_paths(root=REPO, rules=["QT203"]) == []
        specs = load_thread_specs()
        assert sum(len(v) for v in specs.values()) >= 8
        assert all(k.startswith("quintnet_tpu_torch/") for k in specs)

    def test_seeded_inversion_is_caught_then_reverted(self):
        """Seed an inverted acquisition into the live parse set: the
        gate MUST catch it (this is the whole point of the pass), and
        the unseeded set must stay clean."""
        parsed = list(collect_sources(list(THREAD_PATHS), root=REPO))
        src = _CYCLE
        seed = SourceFile("quintnet_tpu_torch/fleet/_seeded_demo.py", src,
                          ast.parse(src))
        vs = audit_parsed(parsed + [seed], rules=["QT201"])
        assert any(v.rule == "QT201"
                   and "_seeded_demo" in v.symbol for v in vs)
        # reverted: the real tree alone is cycle-free
        assert audit_parsed(parsed, rules=["QT201"]) == []


# ---------------------------------------------------------------------
# CLI: --select / --json / both-direction failures / timed smoke
# ---------------------------------------------------------------------

class TestCLI:
    def test_select_qt2_with_baseline_clean(self):
        from quintnet_tpu_torch.tools.qtcheck import main

        rc = main(["--select", "QT2", "--threads-baseline", BASELINE,
                   "--root", REPO])
        assert rc == 0

    def test_select_single_rule_without_baseline(self, capsys):
        """--select arms the concurrency pass even with no baseline;
        QT203 alone is clean on the real tree, so rc 0."""
        from quintnet_tpu_torch.tools.qtcheck import main

        rc = main(["--select", "QT203", "--root", REPO])
        out = capsys.readouterr().out
        assert rc == 0
        assert "0 violation(s)" in out

    def test_json_gate_output(self, capsys):
        from quintnet_tpu_torch.tools.qtcheck import main

        rc = main(["--select", "QT2", "--threads-baseline", BASELINE,
                   "--root", REPO, "--json"])
        payload = json.loads(capsys.readouterr().out)
        assert rc == 0
        assert payload["new"] == [] and payload["stale"] == []
        assert payload["total"] >= 1   # the baselined benign findings

    def test_json_listing_output(self, capsys):
        from quintnet_tpu_torch.tools.qtcheck import main

        rc = main(["--select", "QT203", "--root", REPO, "--json"])
        payload = json.loads(capsys.readouterr().out)
        assert rc == 0 and payload == []

    def test_new_violation_fails_gate(self, tmp_path, capsys):
        """Direction 1: tree has findings an (empty) baseline lacks."""
        from quintnet_tpu_torch.tools.qtcheck import main

        p = tmp_path / "empty.json"
        p.write_text(json.dumps(violations_to_baseline([])))
        rc = main(["--select", "QT2", "--threads-baseline", str(p),
                   "--root", REPO])
        out = capsys.readouterr().out
        assert rc == 1 and "NEW" in out

    def test_stale_entry_fails_gate(self, tmp_path, capsys):
        """Direction 2: baseline carries an entry the tree no longer
        produces."""
        from quintnet_tpu_torch.tools.qtcheck import main

        base = load_baseline(BASELINE)
        base["violations"] = base["violations"] + [
            {"rule": "QT202", "path": "quintnet_tpu_torch/fleet/fleet.py",
             "symbol": "ServeFleet.fixed_long_ago", "count": 1}]
        p = tmp_path / "stale.json"
        p.write_text(json.dumps(base))
        rc = main(["--select", "QT2", "--threads-baseline", str(p),
                   "--root", REPO])
        out = capsys.readouterr().out
        assert rc == 1 and "STALE" in out

    def test_full_tree_both_passes_timed_smoke(self):
        """Both passes over the whole tree share ONE parse
        (qtcheck.py hoists collect_sources): the combined run is
        bounded — this is the perf regression tripwire for the CLI."""
        from quintnet_tpu_torch.tools.qtcheck import main

        t0 = time.monotonic()
        rc = main(["--baseline", LINT_BASELINE,
                   "--threads-baseline", BASELINE, "--root", REPO])
        elapsed = time.monotonic() - t0
        assert rc == 0
        assert elapsed < 60.0, f"full-tree qtcheck took {elapsed:.1f}s"


# ---------------------------------------------------------------------
# runtime: LockAudit / InstrumentedLock
# ---------------------------------------------------------------------

class TestLockRuntime:
    def test_inversion_raises_typed_with_both_stacks(self):
        audit = LockAudit()
        a, b = audit.lock("A"), audit.lock("B")
        with a:
            with b:
                pass
        seen = []
        audit.on_violation = seen.append
        with b:
            with pytest.raises(LockOrderError) as ei:
                a.acquire()
        err = ei.value
        assert err.first == "A" and err.second == "B"
        assert err.thread == threading.current_thread().name
        assert err.forward_stack and err.reverse_stack
        # the message is the readable deadlock report: both directions
        assert "earlier A -> B" in str(err)
        assert "current B -> A" in str(err)
        # raised BEFORE blocking: B is still cleanly held/releasable,
        # and the callback saw the same info the exception carries
        assert seen and seen[0]["first"] == "A"
        assert seen[0]["second"] == "B"
        assert seen[0]["forward_stack"] == err.forward_stack
        s = audit.summary()
        assert s["order_violations"] == 1
        assert s["order_edges"] == 1       # only A->B was recorded

    def test_consistent_order_records_edges_silently(self):
        audit = LockAudit()
        a, b = audit.lock("A"), audit.lock("B")
        for _ in range(3):
            with a:
                with b:
                    pass
        s = audit.summary()
        assert s["order_edges"] == 1 and s["order_violations"] == 0
        assert s["locks"]["A"]["acquisitions"] == 3

    def test_self_deadlock_on_non_reentrant(self):
        audit = LockAudit()
        a = audit.lock("A")
        with a:
            with pytest.raises(LockOrderError) as ei:
                a.acquire()
        assert "self-deadlock" in ei.value.forward_stack

    def test_rlock_reacquire_is_fine(self):
        audit = LockAudit()
        r = audit.rlock("R")
        with r:
            with r:
                pass
        assert audit.summary()["locks"]["R"]["acquisitions"] == 2
        assert audit.summary()["order_violations"] == 0

    def test_mint_same_name_returns_same_lock(self):
        """Replica restarts and re-armed subsystems re-mint by name:
        same name + same kind is the SAME node (one story per name);
        a kind mismatch is a hard error."""
        audit = LockAudit()
        assert audit.lock("X") is audit.lock("X")
        with pytest.raises(ValueError, match="already minted"):
            audit.rlock("X")

    def test_ledgers_with_injected_clock(self):
        clk = FakeClock()
        audit = LockAudit(clock=clk, hold_budget_s=1.0)
        a = audit.lock("A")
        a.acquire()
        clk.advance(2.5)
        a.release()
        led = audit.summary()["locks"]["A"]
        assert led["hold_s"] == pytest.approx(2.5)
        assert led["max_hold_s"] == pytest.approx(2.5)
        assert led["held_too_long"] == 1   # 2.5s > 1.0s budget

    def test_check_held_watchdog_deterministic(self):
        clk = FakeClock()
        audit = LockAudit(clock=clk, hold_budget_s=1.0)
        a = audit.lock("A")
        a.acquire()
        clk.advance(5.0)
        offenders = audit.check_held()
        assert len(offenders) == 1
        assert offenders[0]["lock"] == "A"
        assert offenders[0]["held_s"] == pytest.approx(5.0)
        assert offenders[0]["holder"] == threading.current_thread().name
        a.release()
        assert audit.check_held() == []

    def test_watchdog_thread_counts_long_holds(self):
        audit = LockAudit(hold_budget_s=0.005,
                          watchdog_interval_s=0.005)
        a = audit.lock("A")
        a.acquire()
        deadline = time.monotonic() + 5.0
        while (audit.summary()["locks"]["A"]["held_too_long"] == 0
               and time.monotonic() < deadline):
            time.sleep(0.005)
        a.release()
        audit.close()
        assert audit.summary()["locks"]["A"]["held_too_long"] >= 1

    def test_contended_acquire_counted(self):
        audit = LockAudit()
        a = audit.lock("A")
        a.acquire()
        started = threading.Event()

        def worker():
            started.set()
            with a:
                pass

        t = threading.Thread(target=worker)
        t.start()
        started.wait(5.0)
        time.sleep(0.05)       # let the worker hit the blocking path
        a.release()
        t.join(5.0)
        assert not t.is_alive()
        assert audit.summary()["locks"]["A"]["contended"] >= 1

    def test_condition_wait_releases_audit_entry(self):
        """Condition over an instrumented RLock: wait() fully releases
        (a sleeping waiter holds NOTHING in the audit's model) and the
        notify/wake handshake works — if _release_save didn't release
        the inner lock, the producer below would deadlock."""
        audit = LockAudit()
        cond = audit.condition("C")
        state = {"flag": False, "done": False}

        def consumer():
            with cond:
                while not state["flag"]:
                    cond.wait(timeout=5.0)
                state["done"] = True

        t = threading.Thread(target=consumer)
        t.start()
        time.sleep(0.05)
        with cond:
            state["flag"] = True
            cond.notify()
        t.join(5.0)
        assert not t.is_alive() and state["done"]
        lk = cond._lock
        assert isinstance(lk, InstrumentedLock)
        assert lk.holder is None           # nothing residually held
        assert audit.summary()["order_violations"] == 0


# ---------------------------------------------------------------------
# satellite 3: AdmissionQueue under an 8-thread barrier stress
# ---------------------------------------------------------------------

class _QItem:
    __slots__ = ("ident", "deadline", "submit_time", "adapter_id")

    def __init__(self, ident, now):
        self.ident = ident
        self.deadline = None
        self.submit_time = now
        self.adapter_id = None


class TestAdmissionStress:
    def test_eight_thread_barrier_stress_under_one_lock(self):
        """The queue's REAL concurrency contract, stressed: it is not
        internally locked — the fleet serialises all access under its
        condition lock. Eight threads (pushers, a migration re-queuer,
        a targeted remover, a popper, a pressure observer) hammer it
        behind ONE InstrumentedLock. Afterwards: no item lost, none
        duplicated, shed items never entered, the audit saw zero order
        violations, and the ledger accounts every acquisition."""
        audit = LockAudit()
        lock = audit.lock("fleet._cv")
        q = AdmissionQueue(max_pending=64)
        barrier = threading.Barrier(8)
        errors = []
        pushed_ok, shed = [], []
        popped, removed = [], []
        push_lists = [[f"p{w}-{i}" for i in range(150)]
                      for w in range(3)]

        def run(fn):
            def wrapped():
                try:
                    barrier.wait(timeout=30.0)
                    fn()
                except Exception as e:      # pragma: no cover
                    errors.append(e)
            return wrapped

        def pusher(idents):
            def go():
                for ident in idents:
                    with lock:
                        it = _QItem(ident, time.monotonic())
                        try:
                            q.push(it)
                            pushed_ok.append(ident)
                        except Overloaded as e:
                            assert e.reason == "queue_full"
                            shed.append(ident)
            return go

        def requeuer():
            # migration path: pop + push_front is ONE atomic re-queue
            # under the fleet lock; net queue membership is unchanged
            for _ in range(300):
                with lock:
                    it = q.pop()
                    if it is not None:
                        q.push_front([it])

        def remover():
            for _ in range(300):
                with lock:
                    items = q.items()
                    if items:
                        it = items[len(items) // 2]
                        q.remove(it)
                        removed.append(it.ident)

        def popper():
            for _ in range(400):
                with lock:
                    it = q.pop()
                    if it is not None:
                        popped.append(it.ident)

        def observer():
            for _ in range(400):
                with lock:
                    depth = len(q)
                    wait_s = q.oldest_wait_s()
                    q.peek_adapter_id()
                    assert depth >= 0 and wait_s >= 0.0

        threads = [threading.Thread(target=run(fn)) for fn in
                   [pusher(push_lists[0]), pusher(push_lists[1]),
                    pusher(push_lists[2]), requeuer, remover, popper,
                    observer,
                    lambda: None]]          # 8th: pure barrier party
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
            assert not t.is_alive()
        assert errors == []

        with lock:
            remaining = [i.ident for i in q.drain_all()]
            assert len(q) == 0

        # conservation: every accepted item is in EXACTLY one place
        consumed = sorted(popped + removed + remaining)
        assert consumed == sorted(pushed_ok)
        assert len(set(consumed)) == len(consumed)   # no duplication
        # shed items never entered the queue
        assert not set(shed) & set(pushed_ok)
        assert len(pushed_ok) + len(shed) == 450
        # the instrumented fleet lock observed a clean discipline
        s = audit.summary()
        assert s["order_violations"] == 0
        assert s["locks"]["fleet._cv"]["acquisitions"] >= 450


# ---------------------------------------------------------------------
# cross-check: the port's pass and runtime against JAX's
# ---------------------------------------------------------------------

def _jax_module(name, filename):
    """One of JAX's jax-free analysis modules, loaded by file path (its
    package ``__init__`` would import jax)."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "quintnet_tpu", "analysis", filename))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _findings(vs):
    return sorted((v.rule, v.path, v.line, v.symbol, v.message) for v in vs)


@pytest.mark.parametrize("tree", ["jax", "port"])
def test_threads_pass_matches_jax(tree):
    """The port's concurrency pass is JAX's line for line: both give the
    same findings on JAX's tree and on the port's fleet/serve/obs, each
    judged against that tree's own spawn spec."""
    jt = _jax_module("_qtcheck_jax_threads", "threads.py")
    if tree == "jax":
        paths = list(jt.THREAD_PATHS)
        specs = jt.load_thread_specs()
    else:
        paths = [p for p in THREAD_PATHS if not p.endswith("/ops")]
        specs = load_thread_specs()
    jaxs = jt.audit_parsed(jt.collect_sources(paths, root=REPO),
                           specs=specs)
    ours = audit_parsed(collect_sources(paths, root=REPO), specs=specs)
    assert _findings(ours) == _findings(jaxs)
    assert {v.rule for v in ours} == {"QT202"}       # the benign publishes
    if tree == "port":
        # the port's spawn spec describes the port's tree as JAX's does
        # JAX's, entry for entry, path prefix aside
        jspec = {k.replace("quintnet_tpu/", "quintnet_tpu_torch/"): v
                 for k, v in jt.load_thread_specs().items()}
        assert specs == jspec


def _lock_script(audit_cls, clock):
    """One deterministic script: nested acquisitions, an RLock re-entry,
    a long hold against the budget, an inversion, a watchdog check."""
    audit = audit_cls(clock=clock, hold_budget_s=1.0)
    a, b, r = audit.lock("A"), audit.lock("B"), audit.rlock("R")
    for _ in range(3):
        with a:
            clock.advance(0.25)
            with b:
                clock.advance(0.5)
    with r:
        with r:
            clock.advance(2.0)
    b.acquire()
    try:
        a.acquire()
    except RuntimeError as e:
        assert type(e).__name__ == "LockOrderError"
    clock.advance(3.0)
    held = audit.check_held()
    b.release()
    return audit.summary(), [(h["lock"], h["held_s"]) for h in held]


def test_lock_audit_summary_matches_jax():
    jl = _jax_module("_qtcheck_jax_lockrt", "lockrt.py")
    ours = _lock_script(LockAudit, FakeClock())
    jaxs = _lock_script(jl.LockAudit, FakeClock())
    assert ours == jaxs
    assert ours[0]["order_violations"] == 1
    assert ours[0]["locks"]["R"]["held_too_long"] == 1


# ---------------------------------------------------------------------
# fleet: lock_audit=True is inert (token-equal) and observable
# ---------------------------------------------------------------------

torch = pytest.importorskip("torch")

from quintnet_tpu_torch.analysis.recompile import RecompileError  # noqa: E402
from quintnet_tpu_torch.fleet import ServeFleet                    # noqa: E402
from quintnet_tpu_torch.ft import ChaosMonkey                      # noqa: E402
from quintnet_tpu_torch.models.gpt2 import (GPT2Config,            # noqa: E402
                                            gpt2_init)
from quintnet_tpu_torch.models.gpt2_generate import gpt2_generate  # noqa: E402
from quintnet_tpu_torch.obs.prom import (parse_exposition,         # noqa: E402
                                         render_exposition, sample)
from quintnet_tpu_torch.serve import (AdapterRegistry,             # noqa: E402
                                      ServeEngine, gpt2_family)

CFG = GPT2Config.tiny(n_layer=2)
TEMP, TOPK = 0.8, 5


@pytest.fixture(scope="module")
def params():
    return gpt2_init(torch.Generator().manual_seed(0), CFG)


@pytest.fixture
def factory(params):
    def make():
        return ServeEngine(gpt2_family(CFG), params, device="cpu",
                           max_slots=2, block_size=4, num_blocks=24,
                           max_seq_len=24, temperature=TEMP, top_k=TOPK)

    return make


def _oracle(params, prompt, max_new, seed):
    return np.asarray(gpt2_generate(
        params, torch.as_tensor(prompt)[None], CFG, max_new_tokens=max_new,
        temperature=TEMP, top_k=TOPK, seed=seed)[0])


def _prompts(rng, lengths):
    return [np.asarray(rng.integers(0, CFG.vocab_size, (t,)), np.int32)
            for t in lengths]


def _chaos_run(factory, prompts, seeds, **kw):
    monkey = ChaosMonkey(kill_at_step=3, mode="raise", target="r1")
    fleet = ServeFleet(factory, n_replicas=3, policy="round_robin",
                       chaos=monkey, obs=True, **kw)
    fids = [fleet.submit(p, 8, seed=s) for p, s in zip(prompts, seeds)]
    return fleet, [fleet.result(f, timeout=300) for f in fids]


class TestFleetLockAudit:
    def test_kill_migration_golden_with_lock_audit(self, factory, params,
                                                   rng):
        """THE inertness proof: the kill-migration golden rerun with
        lock_audit=True (+obs). Every request equals the unaudited run
        and the undisturbed oracle token for token; under real chaos (a
        death, a migration, a restart) the instrumented locks saw ZERO
        order violations; every replica kept the one-decode promise."""
        prompts = _prompts(rng, (5, 7, 3, 6, 4, 8, 5, 6, 4))
        seeds = [500 + i for i in range(9)]
        plain, plain_outs = _chaos_run(factory, prompts, seeds)
        plain.drain(timeout=120)
        fleet, outs = _chaos_run(factory, prompts, seeds, lock_audit=True)
        try:
            for p, sd, o, po in zip(prompts, seeds, outs, plain_outs):
                np.testing.assert_array_equal(o, po)
                np.testing.assert_array_equal(o, _oracle(params, p, 8, sd))

            m = fleet.metrics
            assert m.replica_deaths == 1 and m.restarts == 1
            assert m.migrations >= 1
            assert m.finished == 9 and m.shed == 0
            fleet.assert_compile_count(decode=1)

            s = fleet.lock_audit.summary()
            assert s["order_violations"] == 0
            assert s["locks"]["fleet._cv"]["acquisitions"] > 0
            assert "obs.events" in s["locks"]
            assert fleet.events.snapshot(
                kind="lock_order_violation") == []
            assert fleet.last_crash is not None
            assert fleet.last_crash["locks"]["order_violations"] == 0
            assert "fleet._cv" in fleet.last_crash["locks"]["locks"]

            text = render_exposition(fleet.metrics.summary(),
                                     locks=fleet.lock_audit.summary())
            parsed = parse_exposition(text)
            assert sample(parsed,
                          "quintnet_lock_order_violations_total") == 0.0
            assert sample(parsed, "quintnet_lock_order_edges") >= 0.0
            assert sample(parsed, "quintnet_lock_acquisitions_total",
                          lock="fleet._cv") > 0.0
            assert sample(parsed, "quintnet_lock_contended_total",
                          lock="fleet._cv") >= 0.0
            assert sample(parsed, "quintnet_lock_hold_seconds_total",
                          lock="fleet._cv") >= 0.0
        finally:
            fleet.drain(timeout=120)

    def test_violation_wiring_emits_event(self, factory):
        fleet = ServeFleet(factory, n_replicas=1, obs=True,
                           lock_audit=True)
        try:
            fleet.lock_audit.on_violation(
                {"first": "A", "second": "B", "thread": "t-demo",
                 "forward_stack": "fwd", "reverse_stack": "rev"})
            evs = fleet.events.snapshot(kind="lock_order_violation")
            assert len(evs) == 1
            assert evs[0]["first"] == "A" and evs[0]["second"] == "B"
            assert evs[0]["thread"] == "t-demo"
        finally:
            fleet.drain(timeout=60)

    def test_off_path_constructs_stock_primitives(self, factory):
        fleet = ServeFleet(factory, n_replicas=1)
        try:
            assert fleet.lock_audit is None
            assert not isinstance(
                getattr(fleet._cv, "_lock", None), InstrumentedLock)
        finally:
            fleet.drain(timeout=60)

    def test_adapter_registry_lock_joins_the_audit(self, params):
        """``AdapterRegistry(lock=)`` takes an instrumented RLock, and a
        lock-audited fleet swaps its engines' registry lock for one
        ("serve.adapters") before any request reaches it."""
        from quintnet_tpu_torch.models.lora import LoRAConfig, lora_init

        audit = LockAudit()
        lcfg = LoRAConfig(rank=4, alpha=8.0)
        tree = lora_init(torch.Generator().manual_seed(1),
                         params["blocks"], lcfg)
        own = AdapterRegistry(lock=audit.rlock("registry"))
        own.register("t", tree=tree, cfg=lcfg)
        assert audit.summary()["locks"]["registry"]["acquisitions"] > 0

        reg = AdapterRegistry()
        reg.register("t", tree=tree, cfg=lcfg)

        def make():
            return ServeEngine(gpt2_family(CFG), params, device="cpu",
                               max_slots=2, block_size=4, num_blocks=24,
                               max_seq_len=24, adapters=reg)

        fleet = ServeFleet(make, n_replicas=2, lock_audit=True)
        try:
            assert isinstance(reg._lock, InstrumentedLock)
            before = fleet.lock_audit.summary()["locks"]["serve.adapters"]
            out = fleet.result(fleet.submit(
                np.arange(4, dtype=np.int32), 3, adapter_id="t"),
                timeout=120)
            assert len(out) == 7
            s = fleet.lock_audit.summary()
            assert (s["locks"]["serve.adapters"]["acquisitions"]
                    > before["acquisitions"])
            assert s["order_violations"] == 0
        finally:
            fleet.drain(timeout=60)

    def test_fleet_compile_count_names_the_drift(self, factory, rng):
        """``ServeFleet.assert_compile_count`` aggregates the replicas'
        sentinels: the bound holds after traffic, and an impossible
        expectation raises with the sentinel's count."""
        fleet = ServeFleet(factory, n_replicas=2, lock_audit=True)
        try:
            fleet.generate(_prompts(rng, (5, 3, 6)), max_new_tokens=4,
                           timeout=120)
            fleet.assert_compile_count(decode=1)
            with pytest.raises(RecompileError,
                               match="serve.decode: expected 2"):
                fleet.assert_compile_count(decode=2)
            per = fleet.summary()["replicas"]
            assert all(r["compile_stats"]["decode"] <= 1
                       for r in per.values())
        finally:
            fleet.drain(timeout=60)


# ---------------------------------------------------------------------
# slow tier: the process-fleet SIGKILL golden, audited
# ---------------------------------------------------------------------

@pytest.mark.slow
def test_sigkill_golden_with_lock_audit(params, rng, tmp_path):
    """The cross-process twin: SIGKILL on p1 of 3 mid-stream with the
    parent's locks instrumented. Token identity to the undisturbed
    oracle plus zero observed order violations across death,
    journal-replay migration and supervised restart."""
    import signal as _signal

    from _torch_proc_factories import write_weights

    from quintnet_tpu_torch.fleet import Backoff, ProcessFleet

    path = write_weights(params, str(tmp_path / "tiny.safetensors"))
    spec = {"file": os.path.join(os.path.dirname(__file__),
                                 "_torch_proc_factories.py"),
            "func": "build_tiny_gpt2",
            "kwargs": {"temperature": TEMP, "top_k": TOPK,
                       "max_seq_len": 40, "weights_path": path}}
    fleet = ProcessFleet(spec, n_replicas=3, policy="round_robin",
                         device="cpu", heartbeat_s=0.05,
                         backoff=Backoff(base_s=0.01, cap_s=0.1),
                         spawn_timeout_s=240.0, obs=True, lock_audit=True)
    try:
        big = _prompts(rng, (5, 7, 3, 6, 4, 8, 5, 6, 4))
        seeds = [500 + i for i in range(9)]
        streamed, fids = [], []
        for i, (p, sd) in enumerate(zip(big, seeds)):
            cb = ((lambda fid, tok, last: streamed.append(tok))
                  if i == 1 else None)     # round_robin: i=1 -> p1
            fids.append(fleet.submit(p, 24, seed=sd, on_token=cb))
        victim = fleet.replica("p1")
        t0 = time.monotonic()
        while len(streamed) < 3:
            if time.monotonic() - t0 > 120:
                raise AssertionError("victim never started streaming")
            time.sleep(0.01)
        os.kill(victim.pid, _signal.SIGKILL)

        outs = [fleet.result(f, timeout=300) for f in fids]
        for p, sd, o in zip(big, seeds, outs):
            np.testing.assert_array_equal(o, _oracle(params, p, 24, sd))

        assert fleet.metrics.replica_deaths == 1
        assert fleet.metrics.migrations >= 1
        assert fleet.metrics.finished == 9 and fleet.metrics.shed == 0
        fleet.assert_compile_count()

        s = fleet.lock_audit.summary()
        assert s["order_violations"] == 0
        assert s["locks"]["fleet._cv"]["acquisitions"] > 0
        assert any(name.startswith("proc.p1.") for name in s["locks"])
        assert fleet.events.snapshot(kind="lock_order_violation") == []
        assert fleet.last_crash["locks"]["order_violations"] == 0
    finally:
        fleet.drain(timeout=180)

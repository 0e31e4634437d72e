"""qtcheck-threads: static lock-discipline auditor for the fleet.

Port of ``quintnet_tpu/analysis/threads.py``; the analysis is the same
line for line, so both packages' passes give the same findings on the
same tree (tests/test_torch_qtcheck_threads.py cross-checks them). The
fleet/serve/obs layers are a real concurrent system — dispatcher,
reader, heartbeat, handoff, tier-fetch and warmup threads all touching
routing state — and the port adds locks JAX lacks in ``ops/`` (the
kernel build lock, the launch-count locks). This pass parses the tree
(AST only, standard library only — loadable by file path exactly like
``lint.py``), builds the lock/thread model, and fails CI on
violations.

Rules
-----
- **QT201 lock-order-cycle** — every ``with self._lock:``-style
  acquisition becomes a node keyed (module, class, attr); holding A
  while acquiring B (lexically nested, or via a resolvable call into a
  method that acquires B) is an edge A→B. Any cycle in the resulting
  graph is a potential deadlock and the finding names every edge's
  call chain, so the two inverted stacks are readable from the CI log.
- **QT202 unguarded-shared-state** — an attribute WRITTEN under a lock
  in at least one (non-``__init__``) method is classified as guarded
  by that lock; any read or write of it WITHOUT the lock, in a method
  reachable from a thread entry point (``threading.Thread`` targets,
  ``threading.Timer`` callbacks, ``run_in_executor`` targets, or an
  ``async def`` front-door handler), is a finding. ``__init__`` is
  exempt on both sides: construction happens-before every thread that
  can see the object.
- **QT203 thread-spawn-census** — every ``threading.Thread(...)`` /
  ``threading.Timer(...)`` spawn site (resolved ``target=``, literal
  ``daemon=`` flag, join-or-shutdown heuristic) is compared against
  the declarative expected-spawn spec (``THREAD_SPAWN_SPECS`` in
  :mod:`~quintnet_tpu_torch.analysis.specs`, a pure literal read back
  via ``ast.literal_eval``). Census and spec must match exactly — an
  unexpected spawn AND a spec entry the tree no longer produces both
  fail, mirroring the collective census.

Interprocedural model (bounded on purpose):

- calls resolve through ``self.m()``, ``self.attr.m()`` where ``attr``
  was assigned a class constructed in the analyzed set, locals
  assigned from such constructors, and — as a last resort — method
  names defined by exactly ONE analyzed class (unique-name
  resolution); anything ambiguous is skipped, never guessed;
- held-lock state propagates two ways: effective-acquire sets flow
  bottom-up (holding A while calling a method that acquires B is an
  A→B edge), and an AMBIENT held set flows top-down as the
  intersection of held sets across every observed call site — this is
  what makes the repo's ``*_locked`` convention (methods called with
  the fleet lock already held) analyzable without annotations.

Findings flow through the same committed-baseline contract as the
lint rules (``quintnet_tpu_torch/tools/qtcheck_threads_baseline.json``;
new violations
AND stale entries both fail) and honor the same ``# qtcheck: ok[RULE]``
pragmas. The runtime twin of this pass is
:mod:`~quintnet_tpu_torch.analysis.lockrt`.
"""

from __future__ import annotations

import ast
import importlib.util
import os
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple


# Reuse lint.py's Violation dataclass + baseline machinery WITHOUT
# importing the package (which imports torch): like lint.py, this
# module loads by file path with the standard library alone. Prefer
# whichever incarnation of the port's lint is already loaded.
def _load_lint():
    for name in ("quintnet_tpu_torch.analysis.lint", "_qtcheck_torch_lint"):
        if name in sys.modules:
            return sys.modules[name]
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "lint.py")
    spec = importlib.util.spec_from_file_location("_qtcheck_torch_lint",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules["_qtcheck_torch_lint"] = mod
    spec.loader.exec_module(mod)
    return mod


_lint = _load_lint()
Violation = _lint.Violation
compare_baseline = _lint.compare_baseline
load_baseline = _lint.load_baseline
violations_to_baseline = _lint.violations_to_baseline
collect_sources = _lint.collect_sources
_PRAGMA = _lint._PRAGMA
_dotted = _lint._dotted

RULES = {
    "QT201": "lock-order cycle between acquisition sites (potential "
             "deadlock)",
    "QT202": "unguarded access to a lock-guarded attribute on a "
             "thread-reachable path",
    "QT203": "thread-spawn census does not match the declarative spec",
}

# the subsystems the concurrency pass audits by default: everything
# that spawns threads or takes locks in serving, and ops/ (the kernel
# build lock and the launch-count locks, which JAX does not have)
THREAD_PATHS = ("quintnet_tpu_torch/fleet", "quintnet_tpu_torch/serve",
                "quintnet_tpu_torch/obs", "quintnet_tpu_torch/ops")

_LOCK_CTORS = {"Lock", "RLock", "Condition"}


def load_thread_specs(path: Optional[str] = None) -> Dict:
    """``THREAD_SPAWN_SPECS`` from analysis/specs.py WITHOUT importing
    it (importing the package imports torch; the spawn spec is a pure
    literal exactly so this reader can ``ast.literal_eval`` it with the
    standard library alone)."""
    path = path or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "specs.py")
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    for node in tree.body:
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets = [node.target]
        for t in targets:
            if isinstance(t, ast.Name) and t.id == "THREAD_SPAWN_SPECS":
                return ast.literal_eval(node.value)
    return {}


# ---------------------------------------------------------------------------
# model extraction


# a lock node: (module rel path, class name or "" for module level,
# attribute/variable name)
LockKey = Tuple[str, str, str]
# a function node: (module rel path, class name or "", def name)
FnKey = Tuple[str, str, str]


def _lock_label(k: LockKey) -> str:
    mod, cls, attr = k
    return f"{mod}:{cls + '.' if cls else ''}{attr}"


def _fn_label(k: FnKey) -> str:
    mod, cls, name = k
    return f"{mod}:{cls + '.' if cls else ''}{name}"


def _is_lock_ctor(node: ast.AST) -> bool:
    # an `instrumented if audited else stock` conditional (the fleets'
    # lock_audit swap) is a lock if either arm is one
    if isinstance(node, ast.IfExp):
        return _is_lock_ctor(node.body) or _is_lock_ctor(node.orelse)
    if not isinstance(node, ast.Call):
        return False
    name = _dotted(node.func) or ""
    parts = name.split(".")
    if parts[-1] in _LOCK_CTORS and (
            len(parts) == 1 or parts[0] == "threading"):
        return True
    # the lockrt minting API: <...audit...>.lock/rlock/condition(name)
    # returns an InstrumentedLock (or a Condition over one) — the
    # receiver must mention "audit" so unrelated `.lock()` methods
    # (e.g. a file lock helper) don't get promoted
    return (len(parts) >= 2
            and parts[-1] in ("lock", "rlock", "condition")
            and any("audit" in p for p in parts[:-1]))


@dataclass
class _Spawn:
    module: str
    symbol: str              # enclosing def, dotted like lint symbols
    line: int
    target: str              # resolved target= as written ("self._worker")
    daemon: Optional[bool]   # literal kwarg, None when absent/dynamic
    joined: bool             # join-or-shutdown heuristic
    kind: str                # "Thread" | "Timer"


@dataclass
class _ClassModel:
    module: str
    name: str
    locks: Set[str] = field(default_factory=set)         # lock attrs
    attr_types: Dict[str, str] = field(default_factory=dict)
    methods: Dict[str, ast.AST] = field(default_factory=dict)


@dataclass
class _FnScanOut:
    key: FnKey
    line: int
    # lock -> first acquisition line in this fn
    acquire_lines: Dict[LockKey, int] = field(default_factory=dict)
    # (outer, inner, line): lexically nested acquisitions
    nested: List[Tuple[LockKey, LockKey, int]] = field(
        default_factory=list)
    # (callee ref, line, held-at-site): for edge + ambient propagation
    calls: List[Tuple[object, int, Tuple[LockKey, ...]]] = field(
        default_factory=list)
    # (attr, "load"/"store", line, held-at-site)
    accesses: List[Tuple[str, str, int, Tuple[LockKey, ...]]] = field(
        default_factory=list)
    # thread roots introduced here (Thread targets, executor fns)
    root_refs: List[object] = field(default_factory=list)
    spawns: List[_Spawn] = field(default_factory=list)
    is_async: bool = False


class _CallRef:
    """An unresolved callee: resolution happens once the whole file
    set's class table exists."""

    __slots__ = ("kind", "cls", "name", "var")

    def __init__(self, kind: str, name: str, cls: str = "",
                 var: str = ""):
        self.kind = kind      # "self" | "typed" | "name" | "free"
        self.cls = cls        # class name for "typed"
        self.name = name      # method / function name
        self.var = var


class _FnScanner(ast.NodeVisitor):
    """One pass over one def's body: lock regions, calls, self-attr
    accesses, thread spawns. Does NOT descend into nested defs — a
    closure runs on whichever thread calls it, not necessarily under
    the locks lexically around its definition, so charging the
    enclosing region to it would be wrong in both directions."""

    def __init__(self, model: "_TreeModel", module: str, cls: str,
                 fn: ast.AST, lines: List[str]):
        self.model = model
        self.module = module
        self.cls = cls
        self.fn = fn
        self.lines = lines
        self.out = _FnScanOut(
            key=(module, cls, fn.name), line=fn.lineno,
            is_async=isinstance(fn, ast.AsyncFunctionDef))
        self._held: List[LockKey] = []
        self._locals: Dict[str, str] = {}    # var -> class name

    # ---- lock resolution --------------------------------------------
    def _lock_of(self, expr: ast.AST) -> Optional[LockKey]:
        if (isinstance(expr, ast.Attribute)
                and isinstance(expr.value, ast.Name)
                and expr.value.id == "self" and self.cls):
            cm = self.model.classes.get((self.module, self.cls))
            if cm and expr.attr in cm.locks:
                return (self.module, self.cls, expr.attr)
        if isinstance(expr, ast.Name):
            if expr.id in self.model.module_locks.get(self.module, ()):
                return (self.module, "", expr.id)
        return None

    # ---- traversal ---------------------------------------------------
    def _scan(self) -> _FnScanOut:
        for stmt in self.fn.body:
            self.visit(stmt)
        return self.out

    def visit_FunctionDef(self, node):     # nested def: skip body
        pass

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):
        pass

    def _do_with(self, node):
        acquired: List[LockKey] = []
        for item in node.items:
            lk = self._lock_of(item.context_expr)
            if lk is not None:
                self.out.acquire_lines.setdefault(
                    lk, item.context_expr.lineno)
                for outer in self._held:
                    if outer != lk:
                        self.out.nested.append(
                            (outer, lk, item.context_expr.lineno))
                self._held.append(lk)
                acquired.append(lk)
            else:
                self.visit(item.context_expr)
            if item.optional_vars is not None:
                self.visit(item.optional_vars)
        for stmt in node.body:
            self.visit(stmt)
        for _ in acquired:
            self._held.pop()

    visit_With = _do_with
    visit_AsyncWith = _do_with

    def visit_Assign(self, node):
        # local type inference: x = ClassName(...)
        if (isinstance(node.value, ast.Call)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            callee = _dotted(node.value.func) or ""
            cls = callee.split(".")[-1]
            if self.model.class_names.get(cls):
                self._locals[node.targets[0].id] = cls
        self.generic_visit(node)

    def visit_Attribute(self, node):
        if (isinstance(node.value, ast.Name) and node.value.id == "self"
                and self.cls):
            ctx = "store" if isinstance(
                node.ctx, (ast.Store, ast.Del)) else "load"
            self.out.accesses.append(
                (node.attr, ctx, node.lineno, tuple(self._held)))
        self.generic_visit(node)

    def visit_AugAssign(self, node):
        # self.x += 1 parses the target as a Load-ctx Attribute in some
        # versions and Store in others; record it explicitly as a store
        if (isinstance(node.target, ast.Attribute)
                and isinstance(node.target.value, ast.Name)
                and node.target.value.id == "self" and self.cls):
            self.out.accesses.append(
                (node.target.attr, "store", node.lineno,
                 tuple(self._held)))
            self.visit(node.value)
            return
        self.generic_visit(node)

    def _callee_ref(self, func: ast.AST) -> Optional[_CallRef]:
        if isinstance(func, ast.Attribute):
            base = func.value
            if isinstance(base, ast.Name):
                if base.id == "self":
                    return _CallRef("self", func.attr)
                if base.id in self._locals:
                    return _CallRef("typed", func.attr,
                                    cls=self._locals[base.id])
                return _CallRef("name", func.attr, var=base.id)
            if (isinstance(base, ast.Attribute)
                    and isinstance(base.value, ast.Name)
                    and base.value.id == "self" and self.cls):
                cm = self.model.classes.get((self.module, self.cls))
                typ = cm.attr_types.get(base.attr) if cm else None
                if typ:
                    return _CallRef("typed", func.attr, cls=typ)
                return _CallRef("name", func.attr, var=base.attr)
        if isinstance(func, ast.Name):
            return _CallRef("free", func.id)
        return None

    def _target_ref(self, expr: ast.AST) -> Tuple[str, Optional[_CallRef]]:
        """A function-valued argument (Thread target=, executor fn)."""
        return (_dotted(expr) or "<dynamic>", self._callee_ref(expr))

    def visit_Call(self, node):
        name = _dotted(node.func) or ""
        parts = name.split(".")
        tail = parts[-1]
        # thread spawn census sites
        if tail in ("Thread", "Timer") and (
                len(parts) == 1 or parts[0] == "threading"):
            self._note_spawn(node, tail)
        # run_in_executor(None, fn, ...): fn runs on an executor thread
        elif tail == "run_in_executor" and len(node.args) >= 2:
            txt, ref = self._target_ref(node.args[1])
            if ref is not None:
                self.out.root_refs.append(ref)
        ref = self._callee_ref(node.func)
        if ref is not None:
            self.out.calls.append((ref, node.lineno, tuple(self._held)))
        self.generic_visit(node)

    # ---- spawn census ------------------------------------------------
    def _note_spawn(self, node: ast.Call, kind: str) -> None:
        target_expr = None
        daemon: Optional[bool] = None
        if kind == "Timer" and len(node.args) >= 2:
            target_expr = node.args[1]
        for kw in node.keywords:
            if kw.arg == "target" or (kind == "Timer"
                                      and kw.arg == "function"):
                target_expr = kw.value
            elif kw.arg == "daemon" and isinstance(kw.value,
                                                   ast.Constant):
                daemon = bool(kw.value.value)
        txt, ref = (self._target_ref(target_expr)
                    if target_expr is not None else ("<dynamic>", None))
        if ref is not None:
            self.out.root_refs.append(ref)
        sym = (f"{self.cls}.{self.fn.name}" if self.cls
               else self.fn.name)
        self.out.spawns.append(_Spawn(
            module=self.module, symbol=sym, line=node.lineno,
            target=txt, daemon=daemon,
            joined=self._join_nearby(node), kind=kind))

    def _join_nearby(self, node: ast.Call) -> bool:
        """Join-or-shutdown heuristic: the spawned handle is joined if
        a ``.join(`` call appears in the same function (locals, loop
        collections) or — when the handle lands on ``self.X`` — on
        ``self.X`` anywhere in the class."""
        for n in ast.walk(self.fn):
            if (isinstance(n, ast.Call)
                    and isinstance(n.func, ast.Attribute)
                    and n.func.attr == "join"):
                return True
        # self.X = threading.Thread(...): look for self.X.join in class
        attr = self._spawn_attr(node)
        if attr and self.cls:
            cm = self.model.classes.get((self.module, self.cls))
            for meth in (cm.methods.values() if cm else ()):
                for n in ast.walk(meth):
                    if (isinstance(n, ast.Call)
                            and isinstance(n.func, ast.Attribute)
                            and n.func.attr == "join"
                            and isinstance(n.func.value, ast.Attribute)
                            and n.func.value.attr == attr):
                        return True
        return False

    def _spawn_attr(self, call: ast.Call) -> Optional[str]:
        for n in ast.walk(self.fn):
            if (isinstance(n, ast.Assign) and n.value is call
                    and len(n.targets) == 1
                    and isinstance(n.targets[0], ast.Attribute)
                    and isinstance(n.targets[0].value, ast.Name)
                    and n.targets[0].value.id == "self"):
                return n.targets[0].attr
        return None


class _TreeModel:
    """The whole analyzed file set: class table, lock nodes, per-def
    scans, resolved call graph."""

    def __init__(self):
        self.classes: Dict[Tuple[str, str], _ClassModel] = {}
        self.module_locks: Dict[str, Set[str]] = {}
        self.class_names: Dict[str, List[Tuple[str, str]]] = {}
        self.method_index: Dict[str, List[FnKey]] = {}
        self.fns: Dict[FnKey, _FnScanOut] = {}
        self.sources: Dict[str, List[str]] = {}   # rel -> lines

    # ---- construction ------------------------------------------------
    def add_module(self, rel: str, source: str, tree: ast.Module) -> None:
        self.sources[rel] = source.splitlines()
        mlocks: Set[str] = set()
        for node in tree.body:
            if (isinstance(node, ast.Assign) and _is_lock_ctor(node.value)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)):
                mlocks.add(node.targets[0].id)
        self.module_locks[rel] = mlocks
        for node in tree.body:
            if isinstance(node, ast.ClassDef):
                self._add_class(rel, node)
            elif isinstance(node, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                key = (rel, "", node.name)
                self.classes.setdefault(
                    (rel, ""), _ClassModel(module=rel, name=""))
                self.classes[(rel, "")].methods[node.name] = node
                self.method_index.setdefault(node.name, []).append(key)

    def _add_class(self, rel: str, node: ast.ClassDef) -> None:
        cm = _ClassModel(module=rel, name=node.name)
        self.classes[(rel, node.name)] = cm
        self.class_names.setdefault(node.name, []).append(
            (rel, node.name))
        for item in node.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                cm.methods[item.name] = item
                self.method_index.setdefault(item.name, []).append(
                    (rel, node.name, item.name))
        # lock attrs + attr types from self.X = ... assignments in ANY
        # method (the conditional lock_audit wiring assigns the same
        # attr on both branches; every assignment is inspected)
        for meth in cm.methods.values():
            for n in ast.walk(meth):
                if not (isinstance(n, ast.Assign)
                        and len(n.targets) == 1
                        and isinstance(n.targets[0], ast.Attribute)
                        and isinstance(n.targets[0].value, ast.Name)
                        and n.targets[0].value.id == "self"):
                    continue
                attr = n.targets[0].attr
                if _is_lock_ctor(n.value):
                    cm.locks.add(attr)
                elif isinstance(n.value, ast.Call):
                    callee = (_dotted(n.value.func) or "").split(".")[-1]
                    if callee and callee[:1].isupper():
                        cm.attr_types.setdefault(attr, callee)

    def scan_all(self) -> None:
        for (rel, cls), cm in self.classes.items():
            for name, fn in cm.methods.items():
                out = _FnScanner(self, rel, cls, fn,
                                 self.sources[rel])._scan()
                self.fns[out.key] = out

    # ---- resolution --------------------------------------------------
    def resolve(self, ref: _CallRef, site: FnKey) -> Optional[FnKey]:
        mod, cls, _ = site
        if ref.kind == "self" and cls:
            key = (mod, cls, ref.name)
            return key if key in self.fns else None
        if ref.kind == "typed":
            for crel, cname in self.class_names.get(ref.cls, ()):
                key = (crel, cname, ref.name)
                if key in self.fns:
                    return key
            return None
        if ref.kind == "free":
            key = (mod, "", ref.name)
            return key if key in self.fns else None
        if ref.kind == "name":
            # unique-name fallback: resolve only when exactly one
            # analyzed class defines a method with this name AND that
            # method touches locks (an ambiguous or lock-free callee
            # adds nothing to the graph — skipping is safe)
            cands = [k for k in self.method_index.get(ref.name, ())
                     if len(k) == 3 and k in self.fns and k[1]]
            if len(cands) == 1:
                return cands[0]
        return None


# ---------------------------------------------------------------------------
# analysis passes


def _suppressed(model: _TreeModel, rel: str, line: int,
                rule: str) -> bool:
    lines = model.sources.get(rel, [])
    for ln in (line, line - 1):
        if 1 <= ln <= len(lines):
            m = _PRAGMA.search(lines[ln - 1])
            if m and (m.group(1) is None
                      or rule in m.group(1).replace(" ", "").split(",")):
                return True
    return False


def _resolved_calls(model: _TreeModel):
    """(caller, callee, line, held-at-site) for every resolvable call."""
    for key, out in model.fns.items():
        for ref, line, held in out.calls:
            callee = model.resolve(ref, key)
            if callee is not None and callee != key:
                yield key, callee, line, held


def _thread_roots(model: _TreeModel) -> Set[FnKey]:
    roots: Set[FnKey] = set()
    for key, out in model.fns.items():
        if out.is_async:
            roots.add(key)            # front-door asyncio handlers
        for ref in out.root_refs:
            r = model.resolve(ref, key)
            if r is not None:
                roots.add(r)
    return roots


def _reachable(model: _TreeModel, roots: Set[FnKey],
               calls) -> Set[FnKey]:
    adj: Dict[FnKey, Set[FnKey]] = {}
    for caller, callee, _line, _held in calls:
        adj.setdefault(caller, set()).add(callee)
    seen = set(roots)
    work = list(roots)
    while work:
        k = work.pop()
        for nxt in adj.get(k, ()):
            if nxt not in seen:
                seen.add(nxt)
                work.append(nxt)
    return seen


def _ambient_held(model: _TreeModel, roots: Set[FnKey],
                  calls) -> Dict[FnKey, Set[LockKey]]:
    """Top-down held-lock propagation: ambient(fn) = the intersection
    of (lexical held ∪ ambient(caller)) over every observed call site.
    Thread roots start from nothing. Methods nobody calls keep an
    empty ambient (conservative: may over-report, never under)."""
    sites: Dict[FnKey, List[Tuple[FnKey, Tuple[LockKey, ...]]]] = {}
    for caller, callee, _line, held in calls:
        sites.setdefault(callee, []).append((caller, held))
    ambient: Dict[FnKey, Set[LockKey]] = {
        k: set() for k in model.fns}
    # iterate to a fixed point (graph is small; depth is bounded)
    for _ in range(len(model.fns)):
        changed = False
        for key in model.fns:
            if key in roots or key not in sites:
                new: Set[LockKey] = set()
            else:
                new = None
                for caller, held in sites[key]:
                    s = set(held) | ambient.get(caller, set())
                    new = s if new is None else (new & s)
                new = new or set()
            if new != ambient[key]:
                ambient[key] = new
                changed = True
        if not changed:
            break
    return ambient


def _effective_acquires(model: _TreeModel, calls
                        ) -> Tuple[Dict[FnKey, Set[LockKey]],
                                   Dict[FnKey, Dict[LockKey, str]]]:
    """Bottom-up: which locks does calling fn (transitively) acquire,
    and via which call chain (for the finding's message)."""
    eff: Dict[FnKey, Set[LockKey]] = {}
    chain: Dict[FnKey, Dict[LockKey, str]] = {}
    for key, out in model.fns.items():
        eff[key] = set(out.acquire_lines)
        chain[key] = {lk: f"{_fn_label(key)}:{ln}"
                      for lk, ln in out.acquire_lines.items()}
    call_list = list(calls)
    for _ in range(len(model.fns)):
        changed = False
        for caller, callee, _line, _held in call_list:
            for lk in eff.get(callee, ()):
                if lk not in eff[caller]:
                    eff[caller].add(lk)
                    chain[caller][lk] = (f"{_fn_label(caller)} -> "
                                         f"{chain[callee][lk]}")
                    changed = True
        if not changed:
            break
    return eff, chain


def _lock_order_edges(model: _TreeModel, calls, ambient, eff, chain):
    """edge (A, B) -> (module, line, human chain) provenance."""
    edges: Dict[Tuple[LockKey, LockKey], Tuple[str, int, str]] = {}

    def note(a: LockKey, b: LockKey, mod: str, line: int,
             how: str) -> None:
        if a == b:
            return
        if _suppressed(model, mod, line, "QT201"):
            return
        edges.setdefault((a, b), (mod, line, how))

    for key, out in model.fns.items():
        amb = ambient.get(key, set())
        for outer, inner, line in out.nested:
            note(outer, inner, key[0], line,
                 f"{_fn_label(key)}:{line}")
        # ambient locks held around this fn's own direct acquisitions
        for lk, ln in out.acquire_lines.items():
            for outer in amb:
                note(outer, lk, key[0], ln,
                     f"[callers hold {_lock_label(outer)}] "
                     f"{_fn_label(key)}:{ln}")
    for caller, callee, line, held in calls:
        outer_set = set(held) | ambient.get(caller, set())
        for outer in outer_set:
            for lk in eff.get(callee, ()):
                note(outer, lk, caller[0], line,
                     f"{_fn_label(caller)}:{line} -> "
                     f"{chain[callee][lk]}")
    return edges


def _cycles(edges) -> List[List[Tuple[LockKey, LockKey]]]:
    """Strongly connected components with >= 2 nodes, reported as the
    list of their internal edges (every cycle lives inside one SCC)."""
    adj: Dict[LockKey, Set[LockKey]] = {}
    nodes: Set[LockKey] = set()
    for (a, b) in edges:
        adj.setdefault(a, set()).add(b)
        nodes.update((a, b))
    index: Dict[LockKey, int] = {}
    low: Dict[LockKey, int] = {}
    on: Set[LockKey] = set()
    stack: List[LockKey] = []
    sccs: List[Set[LockKey]] = []
    counter = [0]

    def strongconnect(v: LockKey) -> None:
        # iterative Tarjan (explicit stack; the graph is tiny but a
        # recursion limit failure in a linter is unacceptable)
        work = [(v, iter(sorted(adj.get(v, ()))))]
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on.add(v)
        while work:
            node, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on.add(w)
                    work.append((w, iter(sorted(adj.get(w, ())))))
                    advanced = True
                    break
                elif w in on:
                    low[node] = min(low[node], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                comp: Set[LockKey] = set()
                while True:
                    w = stack.pop()
                    on.discard(w)
                    comp.add(w)
                    if w == node:
                        break
                if len(comp) > 1:
                    sccs.append(comp)

    for v in sorted(nodes):
        if v not in index:
            strongconnect(v)
    out = []
    for comp in sccs:
        out.append(sorted((a, b) for (a, b) in edges
                          if a in comp and b in comp))
    return out


# ---------------------------------------------------------------------------
# rule drivers


def _qt201(model: _TreeModel, edges) -> List[Violation]:
    out: List[Violation] = []
    for comp_edges in _cycles(edges):
        names = sorted({_lock_label(n) for e in comp_edges for n in e})
        detail = "; ".join(
            f"{_lock_label(a)} -> {_lock_label(b)} via {edges[(a, b)][2]}"
            for a, b in comp_edges)
        mod, line, _ = edges[comp_edges[0]]
        out.append(Violation(
            rule="QT201", path=mod, line=line,
            symbol=" <-> ".join(names),
            message=f"lock-order cycle ({detail})"))
    return out


def _qt202(model: _TreeModel, roots, calls, ambient) -> List[Violation]:
    # classify: attr -> guarding lock, per class (written under exactly
    # one lock of its own class in >= 1 non-__init__ method)
    guards: Dict[Tuple[str, str], Dict[str, Set[LockKey]]] = {}
    for key, out in model.fns.items():
        mod, cls, name = key
        if not cls or name == "__init__":
            continue
        cm = model.classes[(mod, cls)]
        amb = ambient.get(key, set())
        for attr, ctx, _line, held in out.accesses:
            if ctx != "store" or attr in cm.locks:
                continue
            own = {lk for lk in (set(held) | amb)
                   if lk[0] == mod and lk[1] == cls}
            if own:
                guards.setdefault((mod, cls), {}).setdefault(
                    attr, set()).update(own)
    reach = _reachable(model, roots, calls)
    out_v: List[Violation] = []
    for key in sorted(reach):
        mod, cls, name = key
        if not cls or name == "__init__":
            continue
        scan = model.fns[key]
        amb = ambient.get(key, set())
        cls_guards = guards.get((mod, cls), {})
        seen_lines: Set[Tuple[str, int]] = set()
        for attr, ctx, line, held in scan.accesses:
            gset = cls_guards.get(attr)
            if not gset or len(gset) != 1:
                continue     # unguarded or ambiguously guarded: skip
            guard = next(iter(gset))
            if guard in set(held) | amb:
                continue
            if (attr, line) in seen_lines:
                continue
            seen_lines.add((attr, line))
            if _suppressed(model, mod, line, "QT202"):
                continue
            out_v.append(Violation(
                rule="QT202", path=mod, line=line,
                symbol=f"{cls}.{name}",
                message=f"{ctx} of self.{attr} without "
                        f"{_lock_label(guard)} (guarded-by inference: "
                        f"written under it elsewhere) on a "
                        f"thread-reachable path"))
    return out_v


def _qt203(model: _TreeModel, specs: Dict) -> List[Violation]:
    observed: Dict[Tuple[str, str, str], _Spawn] = {}
    for out in model.fns.values():
        for sp in out.spawns:
            observed[(sp.module, sp.symbol, sp.target)] = sp
    expected: Dict[Tuple[str, str, str], Dict] = {}
    for mod, entries in (specs or {}).items():
        for e in entries:
            expected[(mod, e["symbol"], e["target"])] = e

    out_v: List[Violation] = []
    for key in sorted(set(observed) | set(expected)):
        mod, symbol, target = key
        sp = observed.get(key)
        e = expected.get(key)
        sym = f"{symbol}[{target}]"
        if sp is not None and _suppressed(model, mod, sp.line, "QT203"):
            continue
        if e is None:
            out_v.append(Violation(
                rule="QT203", path=mod, line=sp.line, symbol=sym,
                message=f"unexpected {sp.kind} spawn (daemon="
                        f"{sp.daemon}, joined={sp.joined}) — add it to "
                        f"THREAD_SPAWN_SPECS in analysis/specs.py with "
                        f"its shutdown story, or remove the spawn"))
            continue
        if sp is None:
            out_v.append(Violation(
                rule="QT203", path=mod, line=0, symbol=sym,
                message="spec expects this thread spawn but the tree "
                        "no longer has it — update THREAD_SPAWN_SPECS"))
            continue
        mismatches = []
        if "daemon" in e and bool(e["daemon"]) != bool(sp.daemon):
            mismatches.append(
                f"daemon: spec {e['daemon']}, tree {sp.daemon}")
        if "joined" in e and bool(e["joined"]) != sp.joined:
            mismatches.append(
                f"joined: spec {e['joined']}, tree {sp.joined}")
        if mismatches:
            out_v.append(Violation(
                rule="QT203", path=mod, line=sp.line, symbol=sym,
                message="spawn census mismatch: " + "; ".join(
                    mismatches)))
    return out_v


def thread_spawn_census(parsed) -> List[Dict]:
    """The raw census (JSON-able), for --json consumers and tests."""
    model = _build_model(parsed)
    out = []
    for scan in model.fns.values():
        for sp in scan.spawns:
            out.append({"module": sp.module, "symbol": sp.symbol,
                        "line": sp.line, "target": sp.target,
                        "daemon": sp.daemon, "joined": sp.joined,
                        "kind": sp.kind})
    return sorted(out, key=lambda d: (d["module"], d["line"]))


# ---------------------------------------------------------------------------
# entry points


def _build_model(parsed) -> _TreeModel:
    model = _TreeModel()
    for sf in parsed:
        if sf.tree is None:
            continue
        model.add_module(sf.rel, sf.source, sf.tree)
    model.scan_all()
    return model


def audit_parsed(parsed, *, rules: Optional[Sequence[str]] = None,
                 specs: Optional[Dict] = None) -> List[Violation]:
    """Run the concurrency pass over pre-parsed sources (the shared
    parse from :func:`analysis.lint.collect_sources` — each file is
    read and parsed ONCE for all passes)."""
    active = set(rules) if rules else set(RULES)
    model = _build_model(parsed)
    calls = list(_resolved_calls(model))
    roots = _thread_roots(model)
    ambient = _ambient_held(model, roots, calls)
    out: List[Violation] = []
    if "QT201" in active:
        eff, chain = _effective_acquires(model, calls)
        edges = _lock_order_edges(model, calls, ambient, eff, chain)
        out.extend(_qt201(model, edges))
    if "QT202" in active:
        out.extend(_qt202(model, roots, calls, ambient))
    if "QT203" in active:
        out.extend(_qt203(model, specs if specs is not None
                          else load_thread_specs()))
    return sorted(out, key=lambda v: (v.path, v.line, v.rule))


def audit_paths(paths: Sequence[str] = THREAD_PATHS, *,
                root: str = ".",
                rules: Optional[Sequence[str]] = None,
                specs: Optional[Dict] = None) -> List[Violation]:
    return audit_parsed(collect_sources(paths, root=root),
                        rules=rules, specs=specs)


def audit_sources(named_sources: Sequence[Tuple[str, str]], *,
                  rules: Optional[Sequence[str]] = None,
                  specs: Optional[Dict] = None) -> List[Violation]:
    """Test-facing: audit in-memory (rel_path, source) pairs as one
    file set. ``specs`` defaults to EMPTY here (synthetic sources
    should not be judged against the repo's spawn spec)."""
    parsed = [_lint.SourceFile(rel, src, ast.parse(src, filename=rel))
              for rel, src in named_sources]
    return audit_parsed(parsed, rules=rules,
                        specs=specs if specs is not None else {})

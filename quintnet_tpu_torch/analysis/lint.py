"""AST linter for eager-PyTorch footguns, with a committed-baseline workflow.

Port of ``quintnet_tpu/analysis/lint.py``, retargeted from JAX's traced
code to the port's eager torch. The rule IDs, the pragma and the
baseline format are JAX's, so one workflow serves both packages. Each
rule is narrow on purpose: a rule that fires on half the tree teaches
people to ignore the tool.

Rules
-----
- **QT102 unseeded-rng** — an RNG draw with no explicit generator:
  ``torch.rand``/``randn``/``randint``/``randperm``/``bernoulli``/
  ``multinomial``/``normal`` (and their ``_like`` and in-place forms)
  without ``generator=``, or a call to the ``np.random.*`` or stdlib
  ``random.*`` module functions. The port's sampling, dropout and data
  order are pure functions of a seed (the counter-based chain, the
  per-rank dropout generators); a draw from a global RNG makes a run
  unreproducible and a resumed run diverge. Constructors of an explicit
  generator (``np.random.default_rng``, ``random.Random``, ...) are
  the fix, not a finding.
- **QT104 host-sync-in-step-loop** — ``.item()``, ``float()``/``int()``
  on non-literals, ``.tolist()``, ``.cpu()``, ``.numpy()`` or
  ``torch.cuda.synchronize()`` inside a host loop that drives a
  train/engine step. Each one waits for the card to drain, and each is
  a point the queued CUDA-graph decode step must keep outside its
  captured region. Deliberate syncs carry pragmas or baseline entries
  with a note.
- **QT105 mutable-default** — mutable literals, or ``torch.``/``np.``
  calls, as parameter defaults. A default evaluates once at import; a
  tensor default is one buffer shared by every call (and a device
  allocation kept for the life of the process).
- **QT106 timing-no-sync** — a wall-clock delta (``time.time()``/
  ``monotonic()``/``perf_counter()`` subtraction) in a function that
  never synchronizes: no ``torch.cuda.synchronize``, no CUDA event
  ``synchronize``/``elapsed_time``, no call of a ``sync``/``_sync``
  helper (the repo's wrappers of ``torch.cuda.synchronize``), and no
  host read (``.item()``, ``.cpu()``, ``.tolist()``, ``.numpy()``).
  CUDA launches return before the work is done, so such a delta
  measures enqueue latency.

JAX's **QT101** (host numpy inside a jitted function) and **QT103**
(Python branching on a tracer) have no torch meaning: the port traces
nothing — no ``torch.compile``, no ``jit`` — so every numpy call and
every branch runs on the host each call, which is what the code means.
They are listed in :data:`UNPORTED_RULES` and never fire.

Suppression: append ``# qtcheck: ok`` (or ``# qtcheck: ok[QT104]``) to
the offending line. Legacy violations live in the committed baseline
(``quintnet_tpu_torch/tools/qtcheck_baseline.json``) keyed by (rule,
file, enclosing function) with a count and a note;
:func:`compare_baseline` fails on NEW violations and on STALE entries
alike (tests/test_torch_qtcheck.py gates this in tier-1).

Standard library only: loadable by file path (the CLI does so).
"""

from __future__ import annotations

import ast
import json
import os
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

RULES = {
    "QT102": "RNG draw without an explicit generator",
    "QT104": "host sync (.item()/float()/int()/.tolist()/.cpu()/"
             ".numpy()/cuda.synchronize) inside a step loop",
    "QT105": "mutable or tensor-valued default argument",
    "QT106": "wall-clock timing delta without a device sync",
}

# JAX's rules that have no meaning in eager torch, with the reason
UNPORTED_RULES = {
    "QT101": "host numpy inside jit-traced code: the port traces "
             "nothing (no torch.compile, no jit)",
    "QT103": "Python branching on a tracer: eager tensors are concrete, "
             "so a branch runs on the host every call as written",
}

# torch draws that take generator= (the in-place tensor methods too)
_TORCH_DRAWS = {
    "rand", "randn", "rand_like", "randn_like", "randint", "randint_like",
    "randperm", "bernoulli", "multinomial", "normal", "poisson",
}
_TENSOR_DRAWS = {"bernoulli", "bernoulli_", "multinomial", "random_",
                 "uniform_", "normal_", "exponential_", "geometric_",
                 "cauchy_", "log_normal_"}
# explicit-generator constructors: the fix for QT102, not a finding
_GENERATOR_CTORS = {
    "default_rng", "Generator", "RandomState", "SeedSequence", "PCG64",
    "PCG64DXSM", "Philox", "MT19937", "SFC64", "BitGenerator",
    "Random", "SystemRandom",
}

_TIME_CALLS = {"time", "monotonic", "perf_counter", "process_time"}
_SYNC_ATTRS = {"synchronize", "elapsed_time", "item", "cpu", "tolist",
               "numpy"}
_SYNC_HELPERS = {"sync", "_sync"}
_HOST_READS = {"item", "tolist", "cpu", "numpy"}

_PRAGMA = re.compile(r"#\s*qtcheck:\s*ok(?:\[([A-Z0-9, ]+)\])?")


@dataclass(frozen=True)
class Violation:
    rule: str
    path: str
    line: int
    symbol: str
    message: str

    @property
    def key(self) -> Tuple[str, str, str]:
        return (self.rule, self.path, self.symbol)

    def render(self) -> str:
        return (f"{self.path}:{self.line}: {self.rule} [{self.symbol}] "
                f"{self.message}")


def _dotted(node: ast.AST) -> Optional[str]:
    """'a.b.c' for a Name/Attribute chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _root(dotted: Optional[str]) -> Optional[str]:
    return dotted.split(".", 1)[0] if dotted else None


def _has_generator(node: ast.Call) -> bool:
    return any(kw.arg == "generator" for kw in node.keywords)


class _Linter(ast.NodeVisitor):
    def __init__(self, rel: str, source: str, rules: Set[str]):
        self.rel = rel
        self.lines = source.splitlines()
        self.rules = rules
        self.violations: List[Violation] = []
        self._stack: List[str] = []          # enclosing def names
        self._loop_stack: List[bool] = []    # QT104: step-driving loops

    # -- plumbing ------------------------------------------------------
    def _suppressed(self, line: int, rule: str) -> bool:
        for ln in (line, line - 1):
            if 1 <= ln <= len(self.lines):
                m = _PRAGMA.search(self.lines[ln - 1])
                if m and (m.group(1) is None
                          or rule in m.group(1).replace(" ", "").split(",")):
                    return True
        return False

    def _flag(self, rule: str, node: ast.AST, message: str) -> None:
        if rule not in self.rules:
            return
        line = getattr(node, "lineno", 0)
        if self._suppressed(line, rule):
            return
        self.violations.append(Violation(
            rule=rule, path=self.rel, line=line,
            symbol=".".join(self._stack) or "<module>", message=message))

    # -- visitors ------------------------------------------------------
    def _visit_def(self, node):
        self._check_defaults(node)
        self._stack.append(node.name)
        if "QT106" in self.rules:
            self._check_timing(node)
        self.generic_visit(node)
        self._stack.pop()

    visit_FunctionDef = _visit_def
    visit_AsyncFunctionDef = _visit_def

    def _check_defaults(self, node) -> None:
        args = node.args
        for default in list(args.defaults) + [d for d in args.kw_defaults
                                              if d is not None]:
            if isinstance(default, (ast.List, ast.Dict, ast.Set)):
                self._flag("QT105", default,
                           f"mutable default in {node.name}() is shared "
                           "across calls")
            elif isinstance(default, ast.Call):
                root = _root(_dotted(default.func))
                if root in ("np", "numpy", "torch"):
                    self._flag("QT105", default,
                               f"tensor default in {node.name}() is built "
                               "once at import and shared across calls")

    def visit_Call(self, node: ast.Call) -> None:
        name = _dotted(node.func)
        self._check_rng(node, name)
        if isinstance(node.func, ast.Attribute):
            attr = node.func.attr
            if attr in _HOST_READS and not node.args:
                self._maybe_host_sync(node, f".{attr}()")
            elif name in ("torch.cuda.synchronize", "cuda.synchronize"):
                self._maybe_host_sync(node, "torch.cuda.synchronize()")
        if (isinstance(node.func, ast.Name)
                and node.func.id in ("float", "int")
                and node.args
                and not isinstance(node.args[0], ast.Constant)
                and not self._is_host_math(node.args[0])):
            self._maybe_host_sync(node, f"{node.func.id}()")
        self.generic_visit(node)

    def _check_rng(self, node: ast.Call, name: Optional[str]) -> None:
        if name is None:
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr in _TENSOR_DRAWS
                    and not _has_generator(node)):
                self._flag("QT102", node,
                           f".{node.func.attr}() draws from the global "
                           "torch RNG; pass generator=")
            return
        parts = name.split(".")
        tail = parts[-1]
        if parts[0] == "torch" and len(parts) == 2 \
                and tail in _TORCH_DRAWS and not _has_generator(node):
            self._flag("QT102", node,
                       f"{name}() draws from the global torch RNG; pass "
                       "generator=")
        elif ((parts[0] in ("np", "numpy") and parts[1:2] == ["random"]
               and len(parts) == 3) or (parts[0] == "random"
                                        and len(parts) == 2)):
            if tail not in _GENERATOR_CTORS:
                self._flag("QT102", node,
                           f"{name}() uses the module-global RNG; draw "
                           "from an explicit seeded generator")
        elif (len(parts) >= 2 and tail in _TENSOR_DRAWS
              and parts[0] not in ("torch", "np", "numpy", "random")
              and not _has_generator(node)):
            self._flag("QT102", node,
                       f"{name}() draws from the global torch RNG; pass "
                       "generator=")

    def _visit_loop(self, node):
        drives_step = False
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                callee = _dotted(sub.func) or ""
                if "step" in callee.split(".")[-1].lower():
                    drives_step = True
                    break
        self._loop_stack.append(drives_step)
        self.generic_visit(node)
        self._loop_stack.pop()

    visit_For = _visit_loop
    visit_While = _visit_loop

    @staticmethod
    def _is_host_math(node) -> bool:
        """float(np.exp(...)) / float(math.log(...)) never touch the
        device — numpy/math results are already host scalars."""
        return (isinstance(node, ast.Call)
                and _root(_dotted(node.func)) in ("np", "numpy", "math"))

    def _maybe_host_sync(self, node, what: str) -> None:
        if any(self._loop_stack):
            self._flag("QT104", node,
                       f"{what} in a step-driving loop waits for the card "
                       "every iteration; keep device values on the device "
                       "(or sync once per window)")

    # -- QT106 ---------------------------------------------------------
    def _check_timing(self, fn_node) -> None:
        """Flag wall-clock deltas in functions that never sync: a
        Sub-expression where an operand is a time call (or a local
        assigned from one), in a function with no synchronize,
        elapsed_time or host read."""
        def is_time_call(n) -> bool:
            if not isinstance(n, ast.Call):
                return False
            name = _dotted(n.func) or ""
            # time.monotonic() or a bare imported perf_counter()
            return (name.split(".")[-1] in _TIME_CALLS
                    and (_root(name) == "time" or "." not in name))

        body_walk = list(ast.walk(fn_node))
        # skip nested defs' bodies: they get their own visit
        nested = set()
        for n in body_walk:
            if n is not fn_node and isinstance(
                    n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                nested.update(ast.walk(n))
        body_walk = [n for n in body_walk if n not in nested]

        if any((isinstance(n, ast.Attribute) and n.attr in _SYNC_ATTRS)
               or (isinstance(n, ast.Call)
                   and (_dotted(n.func) or "").split(".")[-1]
                   in _SYNC_HELPERS)
               for n in body_walk):
            return
        timed_names = {
            t.id
            for n in body_walk if isinstance(n, ast.Assign)
            and is_time_call(n.value)
            for t in n.targets if isinstance(t, ast.Name)
        }
        for n in body_walk:
            if isinstance(n, ast.BinOp) and isinstance(n.op, ast.Sub):
                ops = (n.left, n.right)
                if any(is_time_call(o)
                       or (isinstance(o, ast.Name) and o.id in timed_names)
                       for o in ops):
                    self._flag(
                        "QT106", n,
                        "wall-clock delta without a device sync measures "
                        "the launch, not the work on the card")
                    return


def lint_source(source: str, rel_path: str,
                rules: Optional[Sequence[str]] = None) -> List[Violation]:
    tree = ast.parse(source, filename=rel_path)
    linter = _Linter(rel_path, source, set(rules) if rules else set(RULES))
    linter.visit(tree)
    return sorted(linter.violations, key=lambda v: (v.path, v.line, v.rule))


@dataclass(frozen=True)
class SourceFile:
    """One collected file: the SHARED parse every pass consumes. The
    CLI walks and parses the tree once (``collect_sources``) and hands
    the same list to the lint rules and the concurrency pass
    (analysis/threads.py)."""
    rel: str
    source: str
    tree: Optional[ast.Module]           # None when the file failed to
    error: Optional[str] = None          # parse (error says why)


def collect_sources(paths: Sequence[str], *,
                    root: str = ".") -> List[SourceFile]:
    """Read + parse every ``*.py`` under ``paths`` (files or
    directories) once, reporting paths relative to ``root`` so
    baselines stay stable across checkouts."""
    files: List[str] = []
    for p in paths:
        full = os.path.join(root, p)
        if os.path.isfile(full):
            files.append(full)
        else:
            for dirpath, dirnames, filenames in os.walk(full):
                dirnames[:] = [d for d in dirnames
                               if d not in ("__pycache__", ".git", "_build")]
                files.extend(os.path.join(dirpath, f)
                             for f in filenames if f.endswith(".py"))
    out: List[SourceFile] = []
    seen: Set[str] = set()
    for f in sorted(files):
        rel = os.path.relpath(f, root)
        if rel in seen:        # overlapping path args: parse once
            continue
        seen.add(rel)
        with open(f, encoding="utf-8") as fh:
            src = fh.read()
        try:
            out.append(SourceFile(rel, src,
                                  ast.parse(src, filename=rel)))
        except SyntaxError as e:
            out.append(SourceFile(rel, src, None,
                                  error=f"syntax error: {e.msg} "
                                        f"(line {e.lineno})"))
    return out


def lint_parsed(sources: Sequence[SourceFile],
                rules: Optional[Sequence[str]] = None) -> List[Violation]:
    """Lint pre-parsed sources (no file IO, no re-parse)."""
    out: List[Violation] = []
    for sf in sources:
        if sf.tree is None:
            out.append(Violation(rule="QT000", path=sf.rel, line=0,
                                 symbol="<module>",
                                 message=sf.error or "unparseable"))
            continue
        linter = _Linter(sf.rel, sf.source,
                         set(rules) if rules else set(RULES))
        linter.visit(sf.tree)
        out.extend(linter.violations)
    return sorted(out, key=lambda v: (v.path, v.line, v.rule))


def lint_paths(paths: Sequence[str], *, root: str = ".",
               rules: Optional[Sequence[str]] = None) -> List[Violation]:
    """Lint every ``*.py`` under ``paths`` (files or directories),
    reporting paths relative to ``root``."""
    return lint_parsed(collect_sources(paths, root=root), rules)


# ---------------------------------------------------------------------------
# baseline


def violations_to_baseline(violations: Sequence[Violation],
                           notes: Optional[Dict[Tuple[str, str, str], str]]
                           = None) -> dict:
    counts: Dict[Tuple[str, str, str], int] = {}
    lines: Dict[Tuple[str, str, str], int] = {}
    for v in violations:
        counts[v.key] = counts.get(v.key, 0) + 1
        lines.setdefault(v.key, v.line)
    entries = []
    for (rule, path, symbol), n in sorted(counts.items()):
        e = {"rule": rule, "path": path, "symbol": symbol, "count": n,
             "line": lines[(rule, path, symbol)]}
        if notes and (rule, path, symbol) in notes:
            e["note"] = notes[(rule, path, symbol)]
        entries.append(e)
    return {"version": 1, "violations": entries}


def load_baseline(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def compare_baseline(violations: Sequence[Violation],
                     baseline: dict) -> Tuple[List[str], List[str]]:
    """(new, stale): ``new`` are violations beyond the baseline (fail),
    ``stale`` are baseline entries the tree no longer produces (fail
    too — regenerate with --write-baseline so the committed file always
    mirrors the tree)."""
    base = {(e["rule"], e["path"], e["symbol"]): e["count"]
            for e in baseline.get("violations", [])}
    cur: Dict[Tuple[str, str, str], List[Violation]] = {}
    for v in violations:
        cur.setdefault(v.key, []).append(v)

    new, stale = [], []
    for key, vs in sorted(cur.items()):
        allowed = base.get(key, 0)
        if len(vs) > allowed:
            for v in vs[allowed:]:
                new.append(v.render())
    for key, n in sorted(base.items()):
        have = len(cur.get(key, ()))
        if have < n:
            rule, path, symbol = key
            stale.append(f"{path}: {rule} [{symbol}] baseline says "
                         f"{n}, tree has {have} — regenerate the "
                         "baseline (--write-baseline)")
    return new, stale

"""qtcheck CLI: lint the port for eager-torch footguns and
concurrency-discipline violations, gated by committed baselines.

  python -m quintnet_tpu_torch.tools.qtcheck                  # lint all
  python -m quintnet_tpu_torch.tools.qtcheck quintnet_tpu_torch/serve
  python -m quintnet_tpu_torch.tools.qtcheck \
      --baseline quintnet_tpu_torch/tools/qtcheck_baseline.json \
      --threads-baseline \
      quintnet_tpu_torch/tools/qtcheck_threads_baseline.json    # CI gate
  python -m quintnet_tpu_torch.tools.qtcheck \
      --baseline quintnet_tpu_torch/tools/qtcheck_baseline.json \
      --write-baseline                                        # refresh
  python -m quintnet_tpu_torch.tools.qtcheck --select QT2    # threads

Port of ``quintnet_tpu/tools/qtcheck.py``: the same flags and exit
codes. Exit codes: 0 = clean or exactly baseline-matched; 1 = NEW
violations (fix them or, for a deliberate pattern, add a
``# qtcheck: ok[RULE]`` pragma with a justifying comment) or STALE
baseline entries (you fixed legacy violations — rerun with
``--write-baseline`` and commit the shrunken file; notes on surviving
entries are preserved); 2 = ``--write-baseline`` without a baseline.

Two source-level passes share ONE parse of the tree
(analysis/lint.collect_sources):

- the **lint pass** (QT1xx, analysis/lint.py) runs by default over
  ``quintnet_tpu_torch/`` and ``chip_smoke.py`` and gates on
  ``--baseline``;
- the **concurrency pass** (QT2xx, analysis/threads.py — lock-order
  graph, guarded-by inference, thread-spawn census) is opt-in: it runs
  when ``--threads-baseline`` is given or when ``--select``/``--rules``
  names a QT2xx rule, and audits ``fleet/``, ``serve/``, ``obs/`` and
  ``ops/`` unless explicit paths are given. It gates on
  ``--threads-baseline`` with the same both-directions contract.

``--select`` filters by rule-ID prefix (``--select QT2`` = the whole
concurrency family, ``--select QT104,QT2`` mixes passes).

The baselines key violations by (rule, file, enclosing function) with a
count, so line drift never churns them, and tier-1
(tests/test_torch_qtcheck.py, tests/test_torch_qtcheck_threads.py)
fails whenever a committed file and the tree disagree in EITHER
direction.

The runtime passes (collective census, recompile sentinels, in-place
and dtype reports) need real calls, so they live in the tests and in
``chip_smoke.py``. This CLI is the pure-source half: run as a FILE
(``python quintnet_tpu_torch/tools/qtcheck.py``) it imports nothing but
the standard library (analysis/lint.py and analysis/threads.py are
loaded by path, bypassing the package ``__init__``, which imports
torch); ``python -m quintnet_tpu_torch.tools.qtcheck`` behaves
identically but initialises the package (and therefore torch).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

# Load analysis/lint.py and analysis/threads.py by FILE PATH, not
# through the package (whose __init__ imports torch): this CLI lints
# source with the standard library alone. Order matters: threads.py
# reuses whichever lint module is already in sys.modules, so
# registering "_qtcheck_torch_lint" first guarantees both passes share
# ONE Violation class (baseline dicts and isinstance checks stay
# coherent). The names differ from JAX's CLI's, so both CLIs can load
# in one process.
_ANALYSIS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "analysis")


def _load_by_path(name: str, filename: str):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(_ANALYSIS_DIR, filename))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod   # dataclasses needs it registered
    spec.loader.exec_module(mod)
    return mod


_lint = _load_by_path("_qtcheck_torch_lint", "lint.py")
_threads = _load_by_path("_qtcheck_torch_threads", "threads.py")

RULES = _lint.RULES
THREAD_RULES = _threads.RULES
ALL_RULES = {**RULES, **THREAD_RULES}
compare_baseline = _lint.compare_baseline
collect_sources = _lint.collect_sources
lint_parsed = _lint.lint_parsed
lint_paths = _lint.lint_paths
load_baseline = _lint.load_baseline
violations_to_baseline = _lint.violations_to_baseline

DEFAULT_PATHS = ("quintnet_tpu_torch", "chip_smoke.py")


def repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def _select_rules(available, rules, select):
    """The subset of ``available`` rule IDs matching --rules (exact,
    comma-separated) and --select (prefix, comma-separated)."""
    ids = set(available)
    if rules:
        ids &= {r.strip() for r in rules}
    if select:
        prefixes = tuple(p.strip() for p in select if p.strip())
        ids = {r for r in ids if r.startswith(prefixes)}
    return ids


def _under(rel: str, roots) -> bool:
    return any(rel == r or rel.startswith(r + "/") for r in roots)


def _write_baseline_file(path: str, violations) -> None:
    notes = {}
    if os.path.exists(path):
        for e in load_baseline(path).get("violations", []):
            if "note" in e:
                notes[(e["rule"], e["path"], e["symbol"])] = e["note"]
    data = violations_to_baseline(violations, notes)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {path}: {len(data['violations'])} entries "
          f"({len(violations)} violations)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="qtcheck", description="eager-torch footgun + concurrency "
        "linter of the port (rules: analysis/lint.py and "
        "analysis/threads.py)")
    ap.add_argument("paths", nargs="*", default=None,
                    help=f"files/dirs to lint (default: {DEFAULT_PATHS}; "
                         f"the concurrency pass defaults to "
                         f"{_threads.THREAD_PATHS})")
    ap.add_argument("--root", default=None,
                    help="repo root for relative paths (default: "
                         "autodetected from this file)")
    ap.add_argument("--baseline", default=None,
                    help="committed lint baseline JSON; new violations "
                         "and stale entries both fail")
    ap.add_argument("--threads-baseline", default=None,
                    help="committed concurrency baseline JSON (same "
                         "both-directions contract); also turns the "
                         "concurrency pass on")
    ap.add_argument("--write-baseline", action="store_true",
                    help="regenerate the given baseline file(s) from "
                         "the current tree (preserving notes) instead "
                         "of checking")
    ap.add_argument("--rules", default=None,
                    help="comma-separated exact subset, e.g. QT104,QT202")
    ap.add_argument("--select", default=None,
                    help="comma-separated rule-ID prefixes, e.g. QT2 "
                         "(concurrency family) or QT104,QT2")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable output")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule, desc in sorted(ALL_RULES.items()):
            print(f"{rule}  {desc}")
        return 0

    root = args.root or repo_root()
    rules = args.rules.split(",") if args.rules else None
    select = args.select.split(",") if args.select else None

    lint_rules = _select_rules(RULES, rules, select)
    thread_rules = _select_rules(THREAD_RULES, rules, select)
    # The concurrency pass is opt-in: a filter naming a QT2xx rule, or
    # a threads baseline, arms it. A bare `qtcheck` run stays the lint
    # pass alone (its baseline is the committed contract CI pins). A
    # filter that excludes a pass's every rule disarms that pass — and
    # its baseline comparison with it.
    run_lint = bool(lint_rules)
    run_threads = bool(thread_rules) and (
        bool(args.threads_baseline) or bool(rules or select))

    # ONE parse shared by both passes: each file is read and parsed
    # exactly once however many passes (or rules) consume it.
    if args.paths:
        sources = collect_sources(args.paths, root=root)
        thread_sources = sources
    elif run_lint:
        sources = collect_sources(list(DEFAULT_PATHS), root=root)
        thread_sources = [s for s in sources
                          if _under(s.rel, _threads.THREAD_PATHS)]
    else:
        sources = collect_sources(list(_threads.THREAD_PATHS), root=root)
        thread_sources = sources

    lint_violations = (lint_parsed(sources, rules=sorted(lint_rules))
                       if run_lint else [])
    thread_violations = (
        _threads.audit_parsed(thread_sources,
                              rules=sorted(thread_rules))
        if run_threads else [])

    if args.write_baseline:
        if not (args.baseline or args.threads_baseline):
            print("--write-baseline needs --baseline and/or "
                  "--threads-baseline", file=sys.stderr)
            return 2
        if args.baseline and run_lint:
            _write_baseline_file(args.baseline, lint_violations)
        if args.threads_baseline and run_threads:
            _write_baseline_file(args.threads_baseline,
                                 thread_violations)
        return 0

    if args.baseline or args.threads_baseline:
        new, stale = [], []
        if args.baseline and run_lint:
            n, s = compare_baseline(lint_violations,
                                    load_baseline(args.baseline))
            new += n
            stale += s
        if args.threads_baseline and run_threads:
            n, s = compare_baseline(thread_violations,
                                    load_baseline(args.threads_baseline))
            new += n
            stale += s
        total = len(lint_violations) + len(thread_violations)
        if args.as_json:
            print(json.dumps({"new": new, "stale": stale,
                              "total": total}))
        else:
            for line in new:
                print(f"NEW   {line}")
            for line in stale:
                print(f"STALE {line}")
            status = "clean" if not (new or stale) else "FAIL"
            print(f"qtcheck: {total} violation(s), "
                  f"{len(new)} new, {len(stale)} stale vs baseline "
                  f"— {status}")
        return 1 if (new or stale) else 0

    violations = sorted(lint_violations + thread_violations,
                        key=lambda v: (v.path, v.line, v.rule))
    if args.as_json:
        print(json.dumps([v.__dict__ for v in violations]))
    else:
        for v in violations:
            print(v.render())
        print(f"qtcheck: {len(violations)} violation(s)")
    return 1 if violations else 0


if __name__ == "__main__":
    sys.exit(main())

"""qtcheck: static and runtime checks of the port's programs.

The port's counterpart of ``quintnet_tpu/analysis/``. Four passes, one
CI gate (``python -m quintnet_tpu_torch.tools.qtcheck``):

- :mod:`~quintnet_tpu_torch.analysis.step_audit` (JAX's
  ``jaxpr_audit.py``) — run one call and watch it: per-axis collective
  census, dtype-promotion report, in-place state report, gathered-view
  reads of the KV pool;
- :mod:`~quintnet_tpu_torch.analysis.recompile` — count calls by
  abstract signature; enforce "exactly N programs" (the serve engine's
  one-program-per-bucket promise, the trainer's one-step promise: the
  captures a CUDA graph would need);
- :mod:`~quintnet_tpu_torch.analysis.lint` — AST rules for eager-torch
  footguns (global-RNG draws, step-loop host syncs, tensor defaults,
  unsynced wall-clock timing) with a committed baseline
  (``quintnet_tpu_torch/tools/qtcheck_baseline.json``);
- :mod:`~quintnet_tpu_torch.analysis.threads` — AST concurrency rules
  for the fleet (lock-order cycles, guarded-by inference, thread-spawn
  census vs the declarative spec) with its own committed baseline
  (``quintnet_tpu_torch/tools/qtcheck_threads_baseline.json``). Its
  runtime twin, :mod:`~quintnet_tpu_torch.analysis.lockrt`, wraps
  ``threading`` locks with order/hold/contention instrumentation behind
  the fleets' ``lock_audit=`` flag.

Expected-census specs (and the thread-spawn spec) live in
:mod:`~quintnet_tpu_torch.analysis.specs`; tests/test_torch_census.py,
tests/test_torch_qtcheck.py and tests/test_torch_qtcheck_threads.py pin
them.
"""

from quintnet_tpu_torch.analysis.lint import (
    RULES,
    Violation,
    collect_sources,
    compare_baseline,
    lint_parsed,
    lint_paths,
    lint_source,
    load_baseline,
    violations_to_baseline,
)
from quintnet_tpu_torch.analysis.lockrt import (
    InstrumentedLock,
    LockAudit,
    LockOrderError,
)
from quintnet_tpu_torch.analysis.recompile import (
    RecompileError,
    RecompileSentinel,
    abstract_signature,
    assert_compile_count,
    check_serving_compile_counts,
)
from quintnet_tpu_torch.analysis.step_audit import (
    Census,
    collective_census,
    donation_report,
    dtype_report,
    gathered_view_gathers,
)
from quintnet_tpu_torch.analysis.threads import (
    RULES as THREAD_RULES,
    THREAD_PATHS,
    audit_parsed,
    audit_paths,
    audit_sources,
    load_thread_specs,
    thread_spawn_census,
)

__all__ = [
    "Census",
    "collective_census",
    "donation_report",
    "dtype_report",
    "gathered_view_gathers",
    "RULES",
    "Violation",
    "collect_sources",
    "compare_baseline",
    "lint_parsed",
    "lint_paths",
    "lint_source",
    "load_baseline",
    "violations_to_baseline",
    "InstrumentedLock",
    "LockAudit",
    "LockOrderError",
    "RecompileError",
    "RecompileSentinel",
    "abstract_signature",
    "assert_compile_count",
    "check_serving_compile_counts",
    "THREAD_PATHS",
    "THREAD_RULES",
    "audit_parsed",
    "audit_paths",
    "audit_sources",
    "load_thread_specs",
    "thread_spawn_census",
]

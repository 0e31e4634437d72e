"""Step auditor: collective census, dtype promotion, in-place state and
gathered-view reads of one eager call.

The port's counterpart of ``quintnet_tpu/analysis/jaxpr_audit.py``.
JAX lowers a program and walks its jaxpr without running it; eager
torch has no program to walk, so each audit here RUNS the call once
and watches it:

- :func:`collective_census` runs ``fn`` under the collective counter
  of ``core/collectives.py`` (every collective of the port goes through
  ``communicate``) and returns a :class:`Census` of JAX's shape:
  ``counts[axis][op]``, backward collectives included (the autograd
  transposes, which JAX's census counts in the differentiated jaxpr).
  A Python loop over layers is counted per trip, as JAX multiplies a
  scan body by its trip count. ``analysis/specs.py`` holds the expected
  counts of every strategy and serving program.
- :func:`dtype_report` walks the call's ATen ops under a
  ``TorchDispatchMode`` for silent precision changes: f32 -> f64
  upcasts, and reductions/contractions that produce a 16-bit result
  from 16-bit inputs. The hand-written kernels are launched through
  ``ctypes`` and are outside the walk, as ``pallas_call`` interiors are
  outside JAX's (``jaxpr_audit.py:339-350``).
- :func:`donation_report` is buffer donation's torch meaning: IN-PLACE
  STATE. For each tensor argument it reports whether the call updated
  its storage in place (same ``data_ptr``, version counter bumped), and
  flags "aliasable misses": an undonated argument for which an output
  of the same shape and dtype landed in new storage (the state a caller
  discards, paid for twice at peak).
- :func:`gathered_view_gathers` counts the index/gather ops that read a
  full block-table view out of the KV pool — the plain path's
  ``paged_gather`` per layer for k and v (and the scales under a scaled
  policy). K4's path must show 0: the kernel walks the table itself.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from quintnet_tpu_torch.core import collectives as cc

_16BIT = (torch.bfloat16, torch.float16)
# ATen ops that accumulate: JAX's reduce_sum / dot_general / cumsum
_ACCUMULATING = {"sum", "mean", "cumsum", "nansum", "mm", "bmm", "addmm",
                 "baddbmm", "addbmm", "dot", "mv", "addmv",
                 "_addmm_activation"}
_GATHERS = {"index", "index_select", "gather"}


@dataclass
class Census:
    """Per-axis collective counts of one call.

    ``counts[axis][op]`` is the number of times ``op`` ran over mesh
    axis ``axis`` (a collective over several axes counts once on each).
    ``dynamic`` is JAX's count of collectives under a ``while_loop``;
    an eager call has none, so it stays 0. ``result`` is what the call
    returned."""

    counts: Dict[str, Dict[str, int]] = field(default_factory=dict)
    dynamic: int = 0
    result: Any = field(default=None, repr=False, compare=False)

    def add(self, axis: str, op: str, n: int = 1) -> None:
        per_axis = self.counts.setdefault(axis, {})
        per_axis[op] = per_axis.get(op, 0) + n

    def total(self) -> int:
        return sum(n for per in self.counts.values() for n in per.values())

    def as_dict(self) -> Dict[str, Dict[str, int]]:
        return {a: dict(sorted(ops.items()))
                for a, ops in sorted(self.counts.items())}

    def diff(self, expected: Dict[str, Dict[str, int]]) -> List[str]:
        """Human-readable mismatches vs a declarative expected census
        (empty list == exact match). Zero-count entries on either side
        are ignored so specs can write explicit zeros."""
        lines = []
        keys = set()
        for side in (self.counts, expected):
            for a, ops in side.items():
                keys.update((a, op) for op, n in ops.items() if n)
        for a, op in sorted(keys):
            got = self.counts.get(a, {}).get(op, 0)
            want = expected.get(a, {}).get(op, 0)
            if got != want:
                lines.append(f"{a}.{op}: expected {want}, got {got}")
        return lines


def collective_census(fn: Callable, *args, **kwargs) -> Census:
    """Run ``fn(*args, **kwargs)`` once (this rank's part of a mesh
    program; every rank must call it) and count its collectives,
    backward ones included. The call's effects happen (a train step
    updates its state): the census is of a real step."""
    with cc.count_collectives() as counts:
        result = fn(*args, **kwargs)
    return Census(counts=counts, result=result)


# ---------------------------------------------------------------------------
# dtype promotion report


@dataclass(frozen=True)
class DtypeIssue:
    kind: str        # "f64-upcast" | "half-accum"
    primitive: str
    detail: str
    count: int       # occurrences in the call


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


class _Watch(TorchDispatchMode):
    def __init__(self, visit):
        super().__init__()
        self.visit = visit

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.visit(func, args, kwargs or {}, out)
        return out


def _op_name(func) -> str:
    return func.overloadpacket.__name__.rstrip("_")


def dtype_report(fn: Callable, *args, **kwargs) -> List[DtypeIssue]:
    """Silent-precision audit of one call.

    Flags (a) any op producing float64 from narrower float inputs (an
    accidental Python double or ``.double()`` widening a hot tensor
    2x), and (b) reductions and contractions (``sum``, ``mean``,
    ``cumsum``, ``mm``, ``bmm``, ``addmm``, ...) whose 16-bit inputs
    give a 16-bit output — JAX's half-accum check (its ``jnp.sum``
    upcasts by itself, torch's does not, so a bf16 ``sum`` is flagged
    unless it passes ``dtype=torch.float32``)."""
    found: Dict[Tuple[str, str, str], int] = {}

    def visit(func, a, k, out):
        name = _op_name(func)
        ins = _tensors((a, k))
        outs = _tensors(out)
        in_dtypes = [t.dtype for t in ins]
        for o in outs:
            if o.dtype == torch.float64 and any(
                    d.is_floating_point and d != torch.float64
                    for d in in_dtypes):
                key = ("f64-upcast", name,
                       f"{[str(d) for d in in_dtypes]} -> float64")
                found[key] = found.get(key, 0) + 1
        if name in _ACCUMULATING and any(d in _16BIT for d in in_dtypes):
            for o in outs:
                if o.dtype in _16BIT:
                    key = ("half-accum", name, f"accumulates in {o.dtype}")
                    found[key] = found.get(key, 0) + 1

    with _Watch(visit):
        fn(*args, **kwargs)
    return [DtypeIssue(kind=k, primitive=p, detail=d, count=n)
            for (k, p, d), n in sorted(found.items())]


# ---------------------------------------------------------------------------
# in-place state report (donation's torch meaning)


@dataclass(frozen=True)
class ArgDonation:
    path: str
    shape: Tuple[int, ...]
    dtype: str
    bytes: int
    donated: bool     # storage updated in place by the call
    aliasable: bool   # in place, or an unclaimed same-shape output exists


@dataclass
class DonationReport:
    args: List[ArgDonation]

    @property
    def donated_bytes(self) -> int:
        return sum(a.bytes for a in self.args if a.donated)

    @property
    def undonated_aliasable(self) -> List[ArgDonation]:
        """The headline finding: arguments a caller almost certainly
        discards (an output of their shape and dtype replaces them, in
        new storage) that the call did not update in place. Each one
        is peak memory paid twice."""
        return [a for a in self.args if a.aliasable and not a.donated]

    def summary(self) -> str:
        flagged = self.undonated_aliasable
        lines = [f"{len(self.args)} tensor args, "
                 f"{self.donated_bytes} bytes updated in place, "
                 f"{len(flagged)} undonated-but-aliasable"]
        lines += [f"  MISSED {a.path}: {a.shape} {a.dtype} ({a.bytes} B)"
                  for a in flagged]
        return "\n".join(lines)

    def by_path(self) -> Dict[str, ArgDonation]:
        return {a.path: a for a in self.args}


def _leaves_with_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out.extend(_leaves_with_paths(v, f"{prefix}[{k!r}]"))
        return out
    if isinstance(tree, (tuple, list)):
        out = []
        for i, v in enumerate(tree):
            out.extend(_leaves_with_paths(v, f"{prefix}[{i}]"))
        return out
    return [(prefix or "<arg>", tree)]


def donation_report(fn: Callable, *args, **kwargs) -> DonationReport:
    """Run ``fn`` once and report, per tensor argument (its path:
    ``args[i]...`` positionally, the keyword's name otherwise), whether
    it was updated in place, and which undonated arguments an output of the
    same shape and dtype could have replaced in place (JAX's slot rule:
    each new-storage output claims at most one argument)."""
    named = [(f"args[{i}]", a) for i, a in enumerate(args)]
    named += list(kwargs.items())
    entries = [(path, t, t.data_ptr(), t._version)
               for name, arg in named
               for path, t in _leaves_with_paths(arg, name)
               if isinstance(t, torch.Tensor)]
    out = fn(*args, **kwargs)
    in_ptrs = {ptr for _, _, ptr, _ in entries}
    slots = Counter((tuple(o.shape), str(o.dtype)) for o in _tensors(out)
                    if o.data_ptr() not in in_ptrs)
    rows = []
    for path, t, ptr, version in entries:
        donated = t.data_ptr() == ptr and t._version > version
        sig = (tuple(t.shape), str(t.dtype))
        aliasable = donated
        if not donated and slots[sig] > 0:
            slots[sig] -= 1
            aliasable = True
        rows.append(ArgDonation(
            path=path, shape=tuple(t.shape), dtype=str(t.dtype),
            bytes=t.numel() * t.element_size(), donated=donated,
            aliasable=aliasable))
    return DonationReport(args=rows)


# ---------------------------------------------------------------------------
# gathered-view audit (K4, ops/paged_attention.py)


def gathered_view_gathers(fn: Callable, *args, num_blocks: int,
                          table_width: int, **kwargs) -> int:
    """Run ``fn`` once and count the index/gather ops that read a FULL
    block-table view out of the pool: the first tensor operand has
    ``num_blocks`` rows (the pool seen as [blocks, bs, H, D], or the
    scales [blocks, H]) and the output's dim 1 is ``table_width`` (one
    entry per table column) — ``paged_gather`` and
    ``paged_gather_scales``. Counted per call, so a layer loop counts
    each layer. The plain path shows n_layer x {k, v} (and both scales
    under a scaled policy); K4's path must show 0. The scaled pool
    write's window gathers have ``max_blocks`` columns, so audit a call
    whose window is narrower than the table (decode's is 1)."""
    found = 0

    def visit(func, a, k, out):
        nonlocal found
        if _op_name(func) not in _GATHERS:
            return
        ins = _tensors(a)
        if not ins or not isinstance(out, torch.Tensor):
            return
        src = ins[0]
        if (src.dim() >= 1 and src.shape[0] == num_blocks
                and out.dim() >= 2 and out.shape[1] == table_width):
            found += 1

    with _Watch(visit):
        fn(*args, **kwargs)
    return found

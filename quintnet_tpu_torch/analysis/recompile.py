"""Recompile sentinel: count a callable's calls by abstract signature.

Port of ``quintnet_tpu/analysis/recompile.py``. In JAX every distinct
abstract signature of a jitted call is one XLA compile, and the serving
engine promises one program per prefill bucket, one decode program (one
per LoRA rank bucket with adapters) and one per verify bucket; the
trainer promises one step program per batch shape. PyTorch runs
eagerly and compiles nothing, but the same signature is what a CUDA
graph would have to capture: one capture per distinct (structure,
shapes, dtypes, devices) of a call, replayed for every call that
matches it. So the sentinel keeps its JAX meaning — the number of
programs the call site needs — and bounds the captures the queued
CUDA-graph decode step will make.

- wrap a callable in :class:`RecompileSentinel`; every call records the
  ABSTRACT signature of its arguments: the container structure, and per
  leaf ``dtype[shape]@device`` for a tensor (or a numpy array, on the
  host), a weak scalar of its type for a Python ``bool``/``int``/
  ``float`` (as ``jax.core.get_aval(5)`` is a weak ``int32[]``: a
  position passed as a Python int must not make each prefill a new
  program), ``generator@device`` for a ``torch.Generator`` (a step's
  dropout generator, JAX's key argument), and ``static:<repr>`` for
  anything else;
- ``compile_count`` is the number of distinct signatures seen;
- :meth:`RecompileSentinel.assert_compile_count` turns the expected
  count into a hard error whose message diffs the offending signature
  against the first one;
- ``max_compiles`` enforces at call time: the serve engine wraps each
  program with ``max_compiles=1``, so a drifting signature fails the
  call that would need a second program. The trainer wraps its step and
  eval functions observe-only and logs the diff of each new signature.

A signature reads metadata only (no device data, no sync), so a call
costs a few microseconds. The engine passes a program's per-step
arguments alone; the parameter tree is bound into the wrapped callable
and never walked.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch


class RecompileError(RuntimeError):
    pass


_WEAK = {bool: "weak:bool[]", int: "weak:int[]", float: "weak:float[]"}


def _leaf_sig(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        dt = str(leaf.dtype).replace("torch.", "")
        return f"{dt}{list(leaf.shape)}@{leaf.device.type}".replace(" ", "")
    if isinstance(leaf, torch.Generator):
        # a per-step dropout generator is an argument like JAX's key
        return f"generator@{leaf.device.type}"
    weak = _WEAK.get(type(leaf))
    if weak is not None:
        return weak
    if isinstance(leaf, (np.ndarray, np.generic)):
        return f"{leaf.dtype}{list(np.shape(leaf))}@host".replace(" ", "")
    return f"static:{leaf!r}"


def _flatten(node, leaves: List[str]) -> str:
    """The container structure as a string; leaf signatures appended to
    ``leaves`` in order (dict keys sorted, as jax's pytrees sort them)."""
    if isinstance(node, (tuple, list)):
        inner = ",".join(_flatten(x, leaves) for x in node)
        return f"({inner})" if isinstance(node, tuple) else f"[{inner}]"
    if isinstance(node, dict):
        try:
            keys = sorted(node)
        except TypeError:
            keys = list(node)
        return "{" + ",".join(f"{k!r}:{_flatten(node[k], leaves)}"
                              for k in keys) + "}"
    if node is None:
        return "None"
    leaves.append(_leaf_sig(node))
    return "*"


def abstract_signature(args: tuple, kwargs: dict) -> Tuple:
    """Hashable abstract signature of a call: the structure string and
    the per-leaf signatures. Two calls with equal signatures are the
    same program (one CUDA-graph capture); unequal ones are two."""
    leaves: List[str] = []
    structure = _flatten((tuple(args), dict(kwargs)), leaves)
    return (structure, tuple(leaves))


def _diff_sigs(base: Tuple, new: Tuple) -> str:
    if base[0] != new[0]:
        return f"pytree structure changed:\n  was {base[0]}\n  now {new[0]}"
    lines = [f"  leaf[{i}]: {a} -> {b}"
             for i, (a, b) in enumerate(zip(base[1], new[1])) if a != b]
    if len(base[1]) != len(new[1]):
        lines.append(f"  leaf count: {len(base[1])} -> {len(new[1])}")
    return "changed leaves:\n" + "\n".join(lines)


class RecompileSentinel:
    """Wrap a callable and count distinct abstract signatures.

    ``max_compiles``: raise :class:`RecompileError` BEFORE dispatching a
    call whose signature would exceed the budget. ``on_recompile(name,
    count, diff)`` fires on every new signature after the first —
    observe-only wiring (the trainer logs it).
    """

    def __init__(self, name: str, fn: Callable, *,
                 max_compiles: Optional[int] = None,
                 on_recompile: Optional[Callable[[str, int, str], None]]
                 = None):
        self.name = name
        self.fn = fn
        self.max_compiles = max_compiles
        self.on_recompile = on_recompile
        self._sigs: Dict[Tuple, int] = {}   # signature -> first-seen order

    def __call__(self, *args, **kwargs):
        sig = abstract_signature(args, kwargs)
        if sig not in self._sigs:
            if self._sigs:
                diff = _diff_sigs(next(iter(self._sigs)), sig)
                if (self.max_compiles is not None
                        and len(self._sigs) >= self.max_compiles):
                    raise RecompileError(
                        f"{self.name}: call would trigger lowering "
                        f"#{len(self._sigs) + 1} (budget "
                        f"{self.max_compiles}); {diff}")
                if self.on_recompile is not None:
                    self.on_recompile(self.name, len(self._sigs) + 1, diff)
            self._sigs[sig] = len(self._sigs)
        return self.fn(*args, **kwargs)

    @property
    def compile_count(self) -> int:
        return len(self._sigs)

    def assert_compile_count(self, expected: int) -> None:
        if len(self._sigs) != expected:
            sigs = list(self._sigs)
            detail = ""
            if len(sigs) > 1:
                detail = "; first drift: " + _diff_sigs(sigs[0], sigs[1])
            raise RecompileError(
                f"{self.name}: expected {expected} compiled program(s), "
                f"observed {len(self._sigs)}{detail}")


def assert_compile_count(expected: Dict[str, int],
                         **sentinels: RecompileSentinel) -> None:
    """Check several sentinels at once:
    ``assert_compile_count({'prefill': 1, 'decode': 1}, prefill=s1,
    decode=s2)``."""
    for key, n in expected.items():
        sentinels[key].assert_compile_count(n)


def check_serving_compile_counts(name: str, counts: Dict[str, int], *,
                                 max_prefill: Optional[int] = None,
                                 decode: int = 1) -> None:
    """The serving bounded-compile promise validated from a PLAIN
    ``{program: compile_count}`` dict — the form that crosses a process
    boundary (``ServeEngine.compile_counts`` in the process fleet's
    ``stats`` reply). The rules of the in-process
    ``ServeFleet.assert_compile_count``:

    - at most ONE compile per prefill bucket (``prefill[<width>]``),
      between 1 and ``max_prefill`` (default: the replica's bucket
      count) in total;
    - at most one compile per verify bucket (``verify[<k>]``);
    - exactly ``decode`` compiles of the single ``decode`` program — or
      0 when a verify bucket compiled (an engine whose every step
      speculated never runs plain decode);
    - with adapters armed (``decode[r<rank>]`` keys instead), at most
      one compile per rank bucket.

    Raises :class:`RecompileError` naming the replica and the offending
    program counts."""
    per_prefill = {k: v for k, v in counts.items()
                   if k.startswith("prefill[")}
    per_verify = {k: v for k, v in counts.items()
                  if k.startswith("verify[")}
    per_rank = {k: v for k, v in counts.items()
                if k.startswith("decode[")}
    total = sum(per_prefill.values())
    cap = max_prefill if max_prefill is not None else len(per_prefill)
    if not 1 <= total <= cap or any(n > 1
                                    for n in per_prefill.values()):
        raise RecompileError(
            f"{name}: expected 1..{cap} compiled prefill bucket "
            f"program(s) (at most one per bucket), observed {total} "
            f"({per_prefill})")
    if any(n > 1 for n in per_verify.values()):
        raise RecompileError(
            f"{name}: expected at most one compiled verify program "
            f"per draft-length bucket, observed {per_verify}")
    if per_rank:
        if any(n > 1 for n in per_rank.values()):
            raise RecompileError(
                f"{name}: expected at most one compiled decode "
                f"program per LoRA rank bucket, observed {per_rank}")
    elif "decode" in counts:
        d = counts["decode"]
        has_verify = any(n > 0 for n in per_verify.values())
        if d != decode and not (has_verify and d == 0):
            raise RecompileError(
                f"{name}: expected {decode} compiled decode "
                f"program(s), observed {d}")
    else:
        raise RecompileError(
            f"{name}: no decode program count reported at all "
            f"({sorted(counts)})")

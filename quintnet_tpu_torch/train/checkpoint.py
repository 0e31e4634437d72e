"""Step-indexed checkpoints on safetensors, with resume.

Port of ``quintnet_tpu/train/checkpoint.py`` for one device. The JAX
package writes through orbax; the port needs no orbax. Each step is a
directory ``<directory>/<step>/`` holding the state as one safetensors
file (``state.safetensors``) and the host-side train cursor as JSON
(``cursor.json``). Tensor names are the JAX key strings of the leaves'
paths (``jax.tree_util.keystr`` form, e.g.
``['params']['blocks']['attn']['qkv']['w']``), so a file written by
:func:`save_pytree` loads in the JAX package's ``load_pytree`` and the
other way round.

A step commits atomically: it is written into a hidden temporary
directory and renamed to its step number, so a save killed half-way
leaves nothing that :meth:`CheckpointManager.all_steps` lists. A step
that is listed but damaged (a truncated file, a cursor the state file
says exists but that is missing or unreadable) raises
:class:`CheckpointRestoreError`; ``ft/restore.restore_with_fallback``
walks past it to the newest step that loads. The rename is atomic
against a killed process, not against a lost machine (no fsync).
"""

from __future__ import annotations

import ast
import json
import os
import re
import shutil
import uuid
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from quintnet_tpu_torch.core.pytree import tree_leaves
from quintnet_tpu_torch.utils import safetensors_io as st

STATE_FILE = "state.safetensors"
CURSOR_FILE = "cursor.json"
_TMP_PREFIX = ".tmp-"


class CheckpointRestoreError(RuntimeError):
    """A specific checkpoint step failed to load, with the recovery
    options spelled out.

    Attributes: ``directory``, ``step`` (the bad one), ``available``
    (other steps present in the directory, newest first).
    """

    def __init__(self, directory: str, step: int, *, available, cause):
        self.directory = directory
        self.step = step
        self.available = sorted(available, reverse=True)
        msg = (f"checkpoint step {step} in {directory} failed to "
               f"restore: {cause}")
        if self.available:
            msg += (f". Older steps exist: {self.available} — retry with "
                    f"restore(step={self.available[0]}), or use "
                    "quintnet_tpu_torch.ft.restore.restore_with_fallback "
                    "to resume from the newest step that loads")
        else:
            msg += (". No other steps exist in this directory; the run "
                    "must re-init from scratch")
        super().__init__(msg)


# ---------------------------------------------------------------------
# whole-pytree files
# ---------------------------------------------------------------------

def keystr(path) -> str:
    """The JAX key string of a path of dict keys: ``['a']['b']``."""
    return "".join(f"[{k!r}]" for k in path)


_KEY = re.compile(r"\[('(?:[^'\\]|\\.)*')\]")


def _parse_keystr(s: str) -> tuple:
    keys = tuple(ast.literal_eval(m) for m in _KEY.findall(s))
    if keystr(keys) != s:
        raise ValueError(f"not a key string of dict keys: {s!r}")
    return keys


def _to_array(leaf):
    """A leaf as the tensor or array stored for it (python numbers as
    0-d int64 / float64 / bool arrays, as ``np.asarray`` gives them)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach()
    return np.asarray(leaf)


def save_pytree(path: str, tree: Any,
                metadata: Optional[Dict[str, str]] = None) -> None:
    """One safetensors file of every leaf of ``tree`` (nested dicts of
    tensors, numpy arrays and python numbers), keyed by JAX key strings;
    tensors are copied to the host."""
    st.save_file({keystr(p): _to_array(x) for p, x in tree_leaves(tree)},
                 path, metadata=metadata)


def _fill(template, data: Dict[str, torch.Tensor], path=()):
    if isinstance(template, dict):
        return {k: _fill(v, data, path + (k,)) for k, v in template.items()}
    key = keystr(path)
    if key not in data:
        raise KeyError(f"{key} is not in the checkpoint")
    v = data[key]
    if isinstance(template, torch.Tensor):
        if template.dim() == 0 and tuple(v.shape) == (1,):
            v = v.reshape(())    # the JAX writer stores a scalar as [1]
        if tuple(v.shape) != tuple(template.shape) or v.dtype != template.dtype:
            raise ValueError(
                f"{key}: saved {v.dtype}{list(v.shape)}, the template "
                f"wants {template.dtype}{list(template.shape)}")
        return v.to(template.device)
    if isinstance(template, np.ndarray):
        return v.numpy()
    if isinstance(template, bool):
        return bool(v)
    if isinstance(template, int):
        return int(v)
    if isinstance(template, float):
        return float(v)
    return v


def _nest(data: Dict[str, torch.Tensor]) -> Dict:
    out: Dict = {}
    for key, v in data.items():
        path = _parse_keystr(key)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def load_pytree(path: str, template: Any = None) -> Any:
    """Inverse of :func:`save_pytree`. With ``template`` (a tree of the
    same layout): its structure, each tensor leaf checked against the
    template's shape and dtype and moved to its device, python numbers
    back as python numbers. Without: nested dicts of CPU tensors."""
    data = st.load_file(path)
    return _nest(data) if template is None else _fill(template, data)


# ---------------------------------------------------------------------
# the manager
# ---------------------------------------------------------------------

class CheckpointManager:
    """Step-indexed train-state checkpoints in ``directory``.

    ``save(step, state, cursor=)`` writes ``state`` (params, optimizer
    state and host numbers, any tree :func:`save_pytree` takes) and the
    JSON ``cursor`` into one step directory, atomically; the newest
    ``max_to_keep`` steps are kept (None keeps all). Saves are
    synchronous: tensors are copied to the host inside ``save``, so
    :meth:`wait_until_finished` has nothing to wait for."""

    def __init__(self, directory: str, *, max_to_keep: Optional[int] = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        # a save killed before its rename leaves a hidden temporary
        # directory that no step lists; clear it
        for name in os.listdir(self.directory):
            if name.startswith(_TMP_PREFIX):
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def all_steps(self) -> List[int]:
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit()
                      and os.path.isdir(os.path.join(self.directory, n)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any, *, cursor: Optional[dict] = None,
             force: bool = False) -> None:
        """Commit ``state`` (and ``cursor``) as step ``step``. A step
        already on disk is never overwritten unless ``force``: a
        re-reached step is bit-identical by deterministic replay, and
        ``force`` is for a step known to be unreadable or superseded (an
        epoch-boundary cursor replacing a mid-epoch one at the same
        step); the old copy is swapped out by rename, so the step is
        either the old or the new one at every moment, or briefly
        absent."""
        if step in self.all_steps() and not force:
            return
        tmp = os.path.join(self.directory,
                           f"{_TMP_PREFIX}{int(step)}-{uuid.uuid4().hex}")
        os.makedirs(tmp)
        try:
            save_pytree(os.path.join(tmp, STATE_FILE), state, metadata={
                "step": str(int(step)),
                "cursor": "1" if cursor is not None else "0"})
            if cursor is not None:
                with open(os.path.join(tmp, CURSOR_FILE), "w") as f:
                    json.dump(cursor, f)
            final = self._step_dir(step)
            if os.path.exists(final):
                trash = tmp + ".old"
                os.rename(final, trash)
                os.rename(tmp, final)
                shutil.rmtree(trash, ignore_errors=True)
            else:
                os.rename(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._prune()

    def _prune(self) -> None:
        if not self.max_to_keep:
            return
        for s in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def wait_until_finished(self) -> None:
        """Barrier on in-flight saves (there are none: saves are
        synchronous)."""

    def _error(self, step: int, cause) -> CheckpointRestoreError:
        others = [s for s in self.all_steps() if s != step]
        return CheckpointRestoreError(self.directory, step,
                                      available=others, cause=cause)

    def restore(self, template: Any = None, *, step: Optional[int] = None
                ) -> Any:
        """The state of ``step`` (default: the newest). With ``template``
        (a tree like the saved state, e.g. a fresh ``{"params", "opt",
        "epoch"}``) the result has its structure and its tensors' devices;
        without, nested dicts of CPU tensors — the reload path of the
        single-device verifiers. A damaged step raises
        :class:`CheckpointRestoreError`."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        try:
            return load_pytree(os.path.join(self._step_dir(step),
                                            STATE_FILE), template)
        except Exception as e:  # noqa: BLE001 — every failure of a read
            # (missing or truncated file, bad header, layout mismatch)
            # means "this step is bad"
            raise self._error(step, e) from e

    def restore_cursor(self, *, step: Optional[int] = None
                       ) -> Optional[dict]:
        """The JSON train cursor saved with ``step``, or None for a step
        saved without one. A cursor that the state file records but that
        is missing or unreadable raises :class:`CheckpointRestoreError`."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        d = self._step_dir(step)
        try:
            meta = st.load_metadata(os.path.join(d, STATE_FILE))
            if meta.get("cursor") != "1":
                return None
            with open(os.path.join(d, CURSOR_FILE)) as f:
                return json.load(f)
        except Exception as e:  # noqa: BLE001 — see restore()
            raise self._error(step, e) from e

    def step_bytes(self, step: Optional[int] = None) -> int:
        """Bytes on disk of one step directory (default: the newest)."""
        step = self.latest_step() if step is None else step
        d = self._step_dir(step)
        return sum(os.path.getsize(os.path.join(d, n)) for n in os.listdir(d))

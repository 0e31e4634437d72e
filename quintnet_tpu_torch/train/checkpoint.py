"""Step-indexed checkpoints on safetensors, with resume, on one device or a mesh.

Port of ``quintnet_tpu/train/checkpoint.py``. The JAX package writes
through orbax, which saves a sharded array as one logical checkpoint
and restores it onto any sharding; the port needs no orbax and has its
own format for the same job. Tensor names are the JAX key strings of
the leaves' paths (``jax.tree_util.keystr`` form, e.g.
``['params']['blocks']['attn']['qkv']['w']``).

**One device** (no mesh, or a mesh of one rank): each step is a
directory ``<directory>/<step>/`` holding the state as one safetensors
file (``state.safetensors``) and the host-side train cursor as JSON
(``cursor.json``). A file written by :func:`save_pytree` loads in the
JAX package's ``load_pytree`` and the other way round.

**A mesh** (one process a rank; every rank calls ``save`` and the
manager's constructor, in the same order): one logical checkpoint a
step, written by every rank. The step directory holds

- ``shard-<rank>.safetensors`` from every rank: the blocks of the
  leaves that rank writes. Each array is written once: a leaf goes to
  the file of each rank whose index is 0 on every mesh axis the leaf is
  replicated over, and that rank writes its own block (its shard) of
  it. A ZeRO-1/2 moment chunk (spec :data:`CHUNK`) is a different
  vector on every rank: each rank writes its own, as the flat chunk it
  is, seen as the block ``[1, ..., 1, n]`` of a global array of shape
  ``[*mesh sizes, n]``.
- ``sharding.json`` from rank 0: the saving mesh (axis names and
  sizes), the strategy, the ZeRO stage, and for each leaf its spec, its
  global shape and dtype.
- ``cursor.json`` from rank 0.

Parameters are stored in the layout the run holds them, as the JAX
package's orbax checkpoint stores them: for tp > 1 the fused QKV in the
tp-blocked column order (``parallel/tp.py``).

A step commits atomically on one device and on a mesh: it is written
into a hidden temporary directory (on a mesh rank 0 makes it and every
rank writes its part), the ranks then agree whether every part was
written (one all-reduced flag), and only then does one rank rename it
to its step number. Making the directory and the rename are agreed the
same way, so a failure on any rank raises on every rank (none is left
waiting in a collective its peers have left), and a save killed or
failing on any rank leaves nothing that
:meth:`CheckpointManager.all_steps` lists. The rename is atomic
against a killed process, not against a lost machine (no fsync).

Restore: onto the SAME mesh, each rank reads its own blocks (and its
own moment chunks) of the full train state; onto another mesh, or with
no mesh at all, the parameters come back whole (global arrays, in the
saved layout; with a template and specs on a mesh, cut to this rank's
shards). A restore with a template onto a mesh whose tp differs from the
saved one (no mesh counts as tp = 1) converts the tp-blocked QKV when
told the head count, and otherwise
raises :class:`MeshMismatchError` naming both meshes, as does restoring
ZeRO chunks onto another mesh: a layout is never silently wrong.

A step that is listed but damaged (a truncated file, a cursor the step
says exists but that is missing or unreadable) raises
:class:`CheckpointRestoreError`; ``ft/restore.restore_with_fallback``
walks past it to the newest step that loads (on a mesh, as a decision
of the whole world).
"""

from __future__ import annotations

import ast
import json
import os
import re
import shutil
import uuid
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from quintnet_tpu_torch.core import runtime
from quintnet_tpu_torch.core.mesh import MeshSpec, rank_grid
from quintnet_tpu_torch.core.pytree import tree_leaves
from quintnet_tpu_torch.parallel.tp import (block_index,
                                            qkv_blocked_from_standard,
                                            qkv_standard_from_blocked,
                                            shard_leaf, spec_axes)
from quintnet_tpu_torch.utils import safetensors_io as st

STATE_FILE = "state.safetensors"
CURSOR_FILE = "cursor.json"
SHARDING_FILE = "sharding.json"
FORMAT = "quintnet-sharded-1"
# the spec of a leaf that is a per-rank flat chunk (ZeRO-1/2 moments)
CHUNK = "chunk"
_TMP_PREFIX = ".tmp-"


def shard_file(rank: int) -> str:
    return f"shard-{rank:05d}.safetensors"


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


class MeshMismatchError(ValueError):
    """A step cannot be restored onto this mesh as asked (ZeRO chunks
    onto another mesh, a tp-blocked QKV onto another tp with no head
    count to convert it): not a damaged step, so no fallback walks past
    it."""


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
# sharded steps: the blocks a rank writes and reads
# ---------------------------------------------------------------------

def _spec_to_json(spec):
    return [list(p) if isinstance(p, tuple) else p for p in spec]


def _spec_from_json(spec):
    return tuple(tuple(p) if isinstance(p, list) else p for p in spec)


class _Layout:
    """A mesh as a step records it (axis names and sizes; the row-major
    rank grid of ``core/mesh.rank_grid``): which rank writes which block
    of a leaf (``parallel/tp.block_index`` says where it lies)."""

    def __init__(self, names, sizes):
        self.spec = MeshSpec(axes=tuple(zip(names, (int(s) for s in sizes))))
        self.names, self.sizes = self.spec.names, self.spec.shape
        self.grid = rank_grid(self.spec)

    def describe(self) -> str:
        return str(dict(self.spec.axes))

    def coords(self, rank: int) -> Dict[str, int]:
        where = np.argwhere(self.grid == rank)[0]
        return dict(zip(self.names, (int(i) for i in where)))

    def rank_at(self, coords: Dict[str, int]) -> int:
        return int(self.grid[tuple(coords[a] for a in self.names)])

    def count(self, part) -> int:
        """The number of blocks along one spec entry."""
        return block_index(part, dict(self.spec.axes),
                           dict.fromkeys(self.names, 0))[1]

    def where(self, spec, block_shape, rank: int) -> tuple:
        """The slices of the whole leaf that ``rank``'s block fills."""
        coords, sizes = self.coords(rank), dict(self.spec.axes)
        out = [slice(None)] * len(block_shape)
        for d, part in enumerate(spec):
            if part is not None:
                i = block_index(part, sizes, coords)[0]
                out[d] = slice(i * block_shape[d], (i + 1) * block_shape[d])
        return tuple(out)

    def writers(self, spec):
        """The ranks that write a leaf of ``spec``: index 0 on every axis
        the leaf is replicated over (one rank a block)."""
        present = spec_axes(spec)
        return [r for r in range(self.grid.size)
                if all(c == 0 for a, c in self.coords(r).items()
                       if a not in present)]

    def writer_of(self, spec, coords) -> int:
        """The rank whose file holds the block of ``spec`` that the rank
        at ``coords`` holds."""
        present = spec_axes(spec)
        return self.rank_at({a: (c if a in present else 0)
                             for a, c in coords.items()})


def _local_blocks(state, specs, mesh):
    """``({key: block this rank writes}, {key: leaf record})`` of a train
    state on ``mesh``; ``specs`` (a tree like ``state``, or None) gives
    each leaf's spec, :data:`CHUNK` for a per-rank flat chunk, ``()`` (a
    replicated leaf) where it names none."""
    spec_of = dict(tree_leaves(specs)) if specs is not None else {}
    layout = _Layout(mesh.axis_names, [mesh.shape[a] for a in
                                       mesh.axis_names])
    blocks, leaves = {}, {}
    for path, leaf in tree_leaves(state):
        key = keystr(path)
        arr = _to_array(leaf)
        spec = spec_of.get(path, ())
        chunk = isinstance(spec, str) and spec == CHUNK
        if chunk:
            if arr.ndim != 1:
                raise ValueError(f"{key}: a {CHUNK} leaf must be a flat "
                                 f"vector, got shape {list(arr.shape)}")
            spec = tuple(layout.names) + (None,)
            arr = arr.reshape((1,) * len(layout.names) + tuple(arr.shape))
        shape = list(arr.shape)
        for d, part in enumerate(spec):
            if part is not None:
                shape[d] *= layout.count(part)
        if mesh.rank in layout.writers(spec):
            blocks[key] = arr
        leaves[key] = {"spec": _spec_to_json(spec), "shape": shape,
                       "dtype": str(arr.dtype), "chunk": chunk}
    return blocks, leaves


class _Shards:
    """The shard files of one sharded step, opened lazily (a file that
    is missing or truncated raises when a block of it is first read)."""

    def __init__(self, directory: str, info: dict):
        self.directory, self.info = directory, info
        self.layout = _Layout(info["mesh"]["names"], info["mesh"]["sizes"])
        self._files: Dict[int, st.SafeTensorFile] = {}

    def _file(self, rank: int) -> st.SafeTensorFile:
        if rank not in self._files:
            self._files[rank] = st.SafeTensorFile(
                os.path.join(self.directory, shard_file(rank)))
        return self._files[rank]

    def record(self, key: str) -> dict:
        if key not in self.info["leaves"]:
            raise KeyError(f"{key} is not in the checkpoint")
        return self.info["leaves"][key]

    def own_block(self, key: str, coords) -> torch.Tensor:
        """The block of ``key`` that the rank at ``coords`` of the saving
        mesh holds (a flat chunk as the vector it was)."""
        rec = self.record(key)
        spec = _spec_from_json(rec["spec"])
        block = self._file(self.layout.writer_of(spec, coords)).tensor(key)
        return block.reshape(-1) if rec["chunk"] else block

    def global_array(self, key: str) -> torch.Tensor:
        """The whole leaf, put together from its writers' blocks."""
        rec = self.record(key)
        spec = _spec_from_json(rec["spec"])
        out = None
        for r in self.layout.writers(spec):
            block = self._file(r)[key]
            if out is None:
                out = torch.empty(rec["shape"], dtype=block.dtype)
            out[self.layout.where(spec, block.shape, r)] = block
        return out

    def close(self):
        for f in self._files.values():
            f.close()
        self._files.clear()


def _raise(err, step, what: str):
    """A rank's own error where it has one, else one that says ``what``
    another rank failed at (``step``: the step being saved, if any)."""
    if err is not None:
        raise err
    raise RuntimeError(what if step is None else
                       f"checkpoint step {step}: {what}; nothing was "
                       f"committed")


def _agreed(err, step, what: str) -> None:
    """Raise on every rank when any rank's ``err`` is set (one
    all-reduced flag)."""
    if runtime.any_rank(err is not None):
        _raise(err, step, what)


def _is_qkv(path) -> bool:
    """A stacked block tree's fused-QKV weight or bias (parameters and
    their moments alike)."""
    return len(path) >= 3 and tuple(path[-3:-1]) == ("attn", "qkv") \
        and "blocks" in path


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
    :meth:`wait_until_finished` has nothing to wait for.

    ``mesh`` (this rank's :class:`~quintnet_tpu_torch.core.mesh.Mesh`;
    None or one rank: the one-device format): every rank of the mesh
    constructs the manager and calls :meth:`save` together, each writing
    its part of one logical step (the module docstring)."""

    def __init__(self, directory: str, *, max_to_keep: Optional[int] = 3,
                 mesh=None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self._main = self.mesh is None or self.mesh.rank == 0
        err = None
        if self._main:
            try:
                os.makedirs(self.directory, exist_ok=True)
                # a save killed before its rename leaves a hidden
                # temporary directory that no step lists; clear it
                for name in os.listdir(self.directory):
                    if name.startswith(_TMP_PREFIX):
                        shutil.rmtree(os.path.join(self.directory, name),
                                      ignore_errors=True)
            except Exception as e:  # noqa: BLE001 — every rank must learn it
                if self.mesh is None:
                    raise
                err = e
        if self.mesh is not None:
            # no rank writes before the clean-up, and none goes on alone
            _agreed(err, None, f"rank 0 failed to open {self.directory}")

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
             force: bool = False, specs: Any = None,
             meta: Optional[dict] = None) -> None:
        """Commit ``state`` (and ``cursor``) as step ``step``. A step
        already on disk is never overwritten unless ``force``: a
        re-reached step is bit-identical by deterministic replay, and
        ``force`` is for a step known to be unreadable or superseded (an
        epoch-boundary cursor replacing a mid-epoch one at the same
        step); the old copy is swapped out by rename, so the step is
        either the old or the new one at every moment, or briefly
        absent.

        On a mesh: ``specs`` (a tree like ``state``) gives each leaf's
        spec (``parallel/tp.py``; :data:`CHUNK` for a ZeRO moment chunk;
        a leaf it leaves out is replicated) and ``meta`` what else the
        step records (the strategy, the ZeRO stage). Rank 0 decides
        whether the step is written; the step is listed only if every
        rank wrote its part, else every rank raises."""
        if self.mesh is not None:
            return self._save_sharded(step, state, cursor=cursor,
                                      force=force, specs=specs, meta=meta)
        if step in self.all_steps() and not force:
            return
        tmp = self._tmp_dir(step)
        try:
            save_pytree(os.path.join(tmp, STATE_FILE), state, metadata={
                "step": str(int(step)),
                "cursor": "1" if cursor is not None else "0"})
            self._write_cursor(tmp, cursor)
            self._commit(tmp, step)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._prune()

    def _tmp_dir(self, step: int) -> str:
        tmp = os.path.join(self.directory,
                           f"{_TMP_PREFIX}{int(step)}-{uuid.uuid4().hex}")
        os.makedirs(tmp)
        return tmp

    @staticmethod
    def _write_cursor(tmp: str, cursor: Optional[dict]) -> None:
        if cursor is not None:
            with open(os.path.join(tmp, CURSOR_FILE), "w") as f:
                json.dump(cursor, f)

    def _commit(self, tmp: str, step: int) -> None:
        """Rename the written ``tmp`` to the step (swapping out an old
        copy of it by rename)."""
        final = self._step_dir(step)
        if os.path.exists(final):
            trash = tmp + ".old"
            os.rename(final, trash)
            os.rename(tmp, final)
            shutil.rmtree(trash, ignore_errors=True)
        else:
            os.rename(tmp, final)

    def _save_sharded(self, step, state, *, cursor, force, specs, meta):
        # three agreed points (one all-reduced flag each): rank 0 made the
        # temporary directory, every rank wrote its part, rank 0 renamed
        # it; a failure at any of them raises on every rank, so no rank is
        # left waiting in a collective its peers have left
        mesh = self.mesh
        tmp, err = None, None
        if self._main and (force or step not in self.all_steps()):
            try:
                tmp = self._tmp_dir(step)
            except Exception as e:  # noqa: BLE001 — every rank must learn it
                err = e
        _agreed(err, step, "rank 0 failed to make the step's directory")
        tmp = runtime.broadcast_object(tmp)
        if tmp is None:
            return
        try:
            blocks, leaves = _local_blocks(state, specs, mesh)
            st.save_file(blocks, os.path.join(tmp, shard_file(mesh.rank)),
                         metadata={"step": str(int(step)),
                                   "rank": str(mesh.rank)})
            if self._main:
                with open(os.path.join(tmp, SHARDING_FILE), "w") as f:
                    json.dump({
                        "format": FORMAT, "step": int(step),
                        "cursor": cursor is not None,
                        "mesh": {"names": list(mesh.axis_names),
                                 "sizes": [mesh.shape[a]
                                           for a in mesh.axis_names]},
                        **(meta or {}), "leaves": leaves}, f)
                self._write_cursor(tmp, cursor)
        except Exception as e:  # noqa: BLE001
            err = e
        if runtime.any_rank(err is not None):
            if self._main:
                shutil.rmtree(tmp, ignore_errors=True)
            runtime.barrier()      # nothing of the step is left on disk
            _raise(err, step, "another rank failed to write its part")
        if self._main:
            try:
                self._commit(tmp, step)
                self._prune()
            except Exception as e:  # noqa: BLE001
                shutil.rmtree(tmp, ignore_errors=True)
                err = e
        # the step is listed on every rank, or every rank raises
        _agreed(err, step, "rank 0 failed to commit it")

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

    def sharding(self, step: Optional[int] = None) -> Optional[dict]:
        """The record of a sharded step (``sharding.json``: the saving
        mesh, the strategy, the ZeRO stage, each leaf's spec and global
        shape), or None for a one-device step."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        path = os.path.join(self._step_dir(step), SHARDING_FILE)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    def restore(self, template: Any = None, *, step: Optional[int] = None,
                specs: Any = None, num_heads: Optional[int] = None) -> Any:
        """The state of ``step`` (default: the newest).

        Without ``template``: nested dicts of CPU tensors, every leaf
        whole (a sharded step's leaves put together from its shard
        files, in the saved layout; a ZeRO chunk leaf as ``[*mesh sizes,
        n]``) — the reload path of the single-device verifiers. With
        ``template`` (a tree like the saved state, e.g. a fresh
        ``{"params", "opt", "epoch"}``) the result has its structure and
        its tensors' devices: on the saving mesh each rank's own blocks;
        on another mesh (or none) each leaf whole, cut to this rank's
        shards by ``specs`` (a tree like ``template``; a leaf it leaves
        out is replicated). Onto another tp (no mesh: tp = 1), the
        tp-blocked QKV is converted with ``num_heads``, and without it
        :class:`MeshMismatchError` names both meshes, as it does for
        ZeRO chunks onto another mesh. A damaged step raises
        :class:`CheckpointRestoreError`."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        d = self._step_dir(step)
        try:
            info = self.sharding(step)
            if info is None:
                return load_pytree(os.path.join(d, STATE_FILE), template)
            return self._restore_sharded(d, info, template, specs,
                                         num_heads)
        except MeshMismatchError:
            raise
        except Exception as e:  # noqa: BLE001 — every failure of a read
            # (missing or truncated file, bad header, layout mismatch)
            # means "this step is bad"
            raise self._error(step, e) from e

    def _restore_sharded(self, d, info, template, specs, num_heads):
        shards = _Shards(d, info)
        try:
            if template is None:
                return _nest({k: shards.global_array(k)
                              for k in info["leaves"]})
            saved, live = shards.layout, self.mesh
            same = live is not None and (saved.names, saved.sizes) == (
                tuple(live.axis_names),
                tuple(live.shape[a] for a in live.axis_names))
            spec_of = dict(tree_leaves(specs)) if specs is not None else {}
            data = {}
            for path, _ in tree_leaves(template):
                key = keystr(path)
                if same:
                    data[key] = shards.own_block(key, live.coords)
                    continue
                if shards.record(key)["chunk"]:
                    raise MeshMismatchError(
                        f"{key} is a per-rank chunk saved on mesh "
                        f"{saved.describe()}; it restores only onto that "
                        f"mesh, not onto {self._describe_live()}")
                data[key] = self._reshard(path, shards.global_array(key),
                                          saved, spec_of.get(path, ()),
                                          num_heads)
            return _fill(template, data)
        finally:
            shards.close()

    def _describe_live(self) -> str:
        if self.mesh is None:
            return "no mesh (one process)"
        return str(dict(self.mesh.shape))

    def _reshard(self, path, x, saved: _Layout, spec, num_heads):
        """A whole leaf of a step saved on ``saved`` -> this rank's shard
        of it under ``spec`` (whole without a mesh), the tp-blocked QKV
        converted to this mesh's tp (no mesh: tp = 1, the standard
        layout)."""
        tp_saved = dict(saved.spec.axes).get("tp", 1)
        tp_live = 1 if self.mesh is None else self.mesh.shape.get("tp", 1)
        if tp_saved != tp_live and _is_qkv(path):
            if num_heads is None:
                raise MeshMismatchError(
                    f"{keystr(path)} was saved on mesh {saved.describe()} "
                    f"in the tp-blocked QKV layout of tp={tp_saved}; this "
                    f"mesh {self._describe_live()} has tp={tp_live}: pass "
                    f"num_heads= to convert it")
            x = qkv_blocked_from_standard(
                qkv_standard_from_blocked(x, num_heads, tp_saved),
                num_heads, tp_live)
        return x if self.mesh is None else shard_leaf(x, spec, self.mesh)

    def restore_cursor(self, *, step: Optional[int] = None
                       ) -> Optional[dict]:
        """The JSON train cursor saved with ``step``, or None for a step
        saved without one. A cursor that the step records but that is
        missing or unreadable raises :class:`CheckpointRestoreError`."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        d = self._step_dir(step)
        try:
            info = self.sharding(step)
            if info is not None:
                has_cursor = bool(info["cursor"])
            else:
                meta = st.load_metadata(os.path.join(d, STATE_FILE))
                has_cursor = meta.get("cursor") == "1"
            if not has_cursor:
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

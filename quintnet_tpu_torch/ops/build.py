"""Build the port's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into ``_build/lib<name>-<hash>.so`` (the
directory is gitignored), where the hash covers the source's bytes,
those of every shared header ``csrc/*.cuh`` and the flags — an edited
source or header rebuilds, an unchanged one loads. Nothing
is built at import time: :func:`load` runs on the first launch, so a
machine without ``nvcc`` can import every module. :func:`build` starts
one ``nvcc`` per missing source, all at once, and waits for them all.

Thread-safe: the serving fleet's replica threads launch their first
kernels at the same moment. :func:`load` builds and loads a library
once under one module lock (the other threads wait for it), and each
build writes a temporary file named by process AND thread, renamed
into place when it is whole. :func:`typed` sets a loaded library's
``ctypes`` signatures once, under the same lock.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
# guards _LIBS, the builds load() starts and each library's signatures
_LOCK = threading.RLock()


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the
    toolkit's default install location."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (checked $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the port's CUDA kernels are built from "
        "source at first use")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: the name of the library holds
    a hash of the source, of every header in ``csrc/`` (any of them may
    be included) and of the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every listed source whose library is missing, one
    ``nvcc`` process each, started together. Returns name -> library
    path. Raises ``RuntimeError`` with the compiler's output when a
    build fails. The compiler log (``-Xptxas -v``: registers, shared
    memory, spills) is kept beside each library as ``.log``."""
    names = list(dict.fromkeys(names))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    procs = {}
    for n in names:
        if paths[n].exists():
            continue
        tmp = paths[n].with_suffix(
            f".{os.getpid()}-{threading.get_ident()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    failed = []
    for n, (tmp, proc) in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        paths[n].with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{n}.cu (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use:
    one build and one library whichever threads ask at once."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _LIBS[name] = lib
    return lib


def typed(lib: ctypes.CDLL, set_signatures: Callable) -> ctypes.CDLL:
    """``lib`` after ``set_signatures(lib)`` has run on it exactly once
    (the ``argtypes`` / ``restype`` a loader declares): a thread never
    calls an entry point whose signature another thread is still
    setting."""
    if getattr(lib, "_typed", False):
        return lib
    with _LOCK:
        if not getattr(lib, "_typed", False):
            set_signatures(lib)
            lib._typed = True
    return lib

"""Kernel loading is thread-safe (``ops/build.py``): the serving fleet's
replica threads launch their first kernels at the same moment. Four
threads asking ``build.load`` for one library at once start one compile
and get one library; ``build.typed`` sets a library's signatures once;
each compile writes a temporary file of its own thread; the launch
counts stay exact under threads. The compiler is a stub here (there is
no ``nvcc`` on this machine), a script that writes its ``-o`` file."""

import ctypes
import os
import re
import stat
import sys
import threading

import pytest

from quintnet_tpu_torch.ops import build


@pytest.fixture
def fake_toolchain(tmp_path, monkeypatch):
    """A csrc/ with one source, an empty build dir, a stub ``nvcc`` that
    logs each call and its output path, then sleeps a little and writes
    it, and a stub ``ctypes.CDLL``."""
    csrc, out = tmp_path / "csrc", tmp_path / "_build"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// a kernel\n")
    calls = tmp_path / "calls.log"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        "while [ $# -gt 0 ]; do\n"
        '  if [ "$1" = "-o" ]; then out="$2"; fi; shift\n'
        "done\n"
        f'echo "$out" >> {calls}\n'
        "sleep 0.3\n"
        'echo lib > "$out"\n')
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", out)
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build, "nvcc_path", lambda: str(nvcc))
    opened = []

    class FakeLib:
        def __init__(self, path):
            opened.append(path)

    monkeypatch.setattr(build.ctypes, "CDLL", FakeLib)
    return calls, opened


def _at_once(n, fn):
    start = threading.Barrier(n)
    got, errors = [None] * n, []

    def run(i):
        try:
            start.wait()
            got[i] = fn()
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors, errors
    return got


def test_four_threads_one_build_one_library(fake_toolchain):
    calls, opened = fake_toolchain
    libs = _at_once(4, lambda: build.load("k"))
    assert len(calls.read_text().splitlines()) == 1      # one compile
    assert len(opened) == 1                              # one library
    assert all(lib is libs[0] for lib in libs)
    assert build.library_path("k").exists()
    assert not list(build.BUILD_DIR.glob("*.tmp"))
    # the temporary file carried the process and the thread
    (tmp,) = calls.read_text().split()
    assert re.search(rf"\.{os.getpid()}-\d+\.tmp$", tmp), tmp
    assert build.load("k") is libs[0]                    # loaded: cached


def test_builds_of_two_threads_do_not_share_a_temporary_file(
        fake_toolchain):
    """``build`` called directly by two threads (each may compile: the
    library is missing for both): every compile writes its own
    temporary file and the library lands whole."""
    calls, _opened = fake_toolchain
    _at_once(2, lambda: build.build(["k"]))
    tmps = calls.read_text().split()
    assert 1 <= len(tmps) == len(set(tmps))
    assert build.library_path("k").read_text() == "lib\n"


def test_signatures_are_set_once(fake_toolchain):
    lib = build.load("k")
    seen = []

    def set_signatures(lib_):
        seen.append(threading.get_ident())
        lib_.entry = ctypes.c_int

    got = _at_once(4, lambda: build.typed(lib, set_signatures))
    assert len(seen) == 1 and all(g is lib for g in got)
    assert lib._typed and lib.entry is ctypes.c_int


def test_launch_counts_are_exact_under_threads():
    """The wrappers' counts change under their lock: 8 threads x 500
    increments through the counting helper lose none."""
    import torch

    from quintnet_tpu_torch.ops import flash_kernels
    from quintnet_tpu_torch.ops.paged_attention import paged_attention

    q = torch.zeros(1, dtype=torch.float32)
    with flash_kernels.flash_fwd.count_lock:
        before = flash_kernels.flash_fwd.launches
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)          # switch threads as often as can be
    try:
        _at_once(8, lambda: [flash_kernels._counted(flash_kernels.flash_fwd,
                                                    q) for _ in range(500)])
    finally:
        sys.setswitchinterval(interval)
    assert flash_kernels.flash_fwd.launches == before + 4000
    with flash_kernels.flash_fwd.count_lock:
        flash_kernels.flash_fwd.launches = before
        flash_kernels.flash_fwd.launches_by_dtype["f32"] -= 4000
    assert isinstance(paged_attention.count_lock, type(threading.Lock()))
    assert hasattr(paged_attention, "launches_by_thread")

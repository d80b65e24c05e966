"""The kernel build and load of the port (``ops/_build.py``) under threads.

There is no ``nvcc`` here: the compiler, its process and ``ctypes.CDLL``
are replaced by fakes that write the library file and sleep, so threads
that first touch one kernel together overlap inside the build.
"""

import ctypes
import os
import threading
import time

import pytest

from spark_rapids_ml_tpu_torch.ops import _build


class _FakeProc:
    """An ``nvcc`` process: writes its ``-o`` file after a pause."""

    def __init__(self, cmd, log, **kw):
        self.cmd, self.returncode = cmd, 0
        self._out = cmd[cmd.index("-o") + 1]
        log.append(self._out)

    def communicate(self):
        time.sleep(0.2)
        with open(self._out, "wb") as f:
            f.write(b"\x7fELF")
        return "ptxas info: 0 registers", None


class _FakeFunc:
    argtypes = None
    restype = None


class _FakeLib:
    def __init__(self, path, loads):
        loads.append(path)
        time.sleep(0.1)
        self._funcs = {}

    def __getattr__(self, symbol):
        if symbol.startswith("_"):
            raise AttributeError(symbol)
        return self._funcs.setdefault(symbol, _FakeFunc())


@pytest.fixture
def fake_toolchain(monkeypatch, tmp_path):
    builds, loads = [], []
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "_FUNCS", {})
    monkeypatch.setattr(_build, "nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", lambda cmd, **kw: _FakeProc(cmd, builds, **kw))
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: _FakeLib(path, loads))
    return builds, loads


def _run_threads(n, target):
    barrier = threading.Barrier(n)
    out, errors = [None] * n, []

    def run(i):
        barrier.wait()
        try:
            out[i] = target(i)
        except Exception as e:  # surfaced by the assertion below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    return out


def test_concurrent_first_use_builds_once(fake_toolchain):
    builds, loads = fake_toolchain
    fns = _run_threads(4, lambda i: _build.function("shifted_gram", "shifted_gram_launch", [ctypes.c_void_p]))
    assert len(builds) == 1 and len(loads) == 1
    assert all(fn is fns[0] for fn in fns)
    assert fns[0].argtypes == [ctypes.c_void_p] and fns[0].restype is ctypes.c_int
    assert _build.library_path("shifted_gram").exists()
    # built and loaded: later calls build and load nothing more
    assert _build.function("shifted_gram", "shifted_gram_launch", [ctypes.c_void_p]) is fns[0]
    _build.function("shifted_gram", "shifted_gram_blocks_per_sm", [ctypes.c_void_p])
    assert len(builds) == 1 and len(loads) == 1


def test_builds_outside_the_lock_write_their_own_files(fake_toolchain):
    """``build`` itself takes no lock: two threads that build one kernel
    write temporary files of their own, and the library lands whole."""
    builds, _ = fake_toolchain
    _run_threads(2, lambda i: _build.build(["lloyd_step"]))
    assert len(builds) == 2 and builds[0] != builds[1]
    assert all(f".{os.getpid()}." in b and b.endswith(".tmp") for b in builds)
    assert _build.library_path("lloyd_step").read_bytes() == b"\x7fELF"
    assert _build.build(["lloyd_step"]) == {"lloyd_step": 0.0}

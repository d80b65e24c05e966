"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds, not minutes). Libraries go into
``spark_rapids_ml_tpu_torch/_build/`` on first use, named by a digest of
their source and flags, so an edited source is rebuilt and an unchanged one
is not. :func:`build` starts one ``nvcc`` per source, all at once.

Nothing here runs at import: a machine without ``nvcc`` (CPU-only test
runs) imports every module and never builds. Pointers and the stream pass
as ``ctypes.c_void_p``, sizes as ``c_int``/``c_int64``; every C entry
point returns ``cudaGetLastError()`` after its launches, and
:func:`check` raises when that is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Sequence

SOURCES = (
    "shifted_gram", "lloyd_step", "logreg_loss_grad", "knn_topk", "umap_sgd_epoch", "rf_hist",
    "rf_traverse", "rf_byte_gather",
)

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

# loaded libraries and bound functions, per process (a loaded shared
# library cannot be unloaded, so the cache lives as long as the process)
_LIBS: Dict[str, ctypes.CDLL] = {}
_FUNCS: Dict[str, ctypes._CFuncPtr] = {}
# covers function()'s check, build and load: threads of one process that
# first touch a kernel together build and load it once
_LOCK = threading.Lock()


def nvcc() -> str:
    """Path of ``nvcc``: ``PATH`` first, then ``$CUDA_HOME/bin``, then the
    toolkit's conventional install prefix."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}.{digest}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every named kernel that is not built yet, one ``nvcc`` per
    source, all started together. Returns seconds per name (0.0 when the
    library already existed); the compiler's ``-Xptxas -v`` report goes to
    ``_build/<name>.log``. Raises with the compiler's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    seconds: Dict[str, float] = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        # by process and thread: no other build writes this file
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd: List[str] = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    failed = []
    for name, out, tmp, t0, proc in procs:
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        (BUILD_DIR / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (rc {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return seconds


def function(name: str, symbol: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C entry point ``symbol`` of kernel library ``name`` (built on
    first use), with its argument types declared."""
    key = f"{name}:{symbol}"
    with _LOCK:
        fn = _FUNCS.get(key)
        if fn is None:
            lib = _LIBS.get(name)
            if lib is None:
                build([name])
                lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
            fn = getattr(lib, symbol)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _FUNCS[key] = fn
    return fn


def check(name: str, code: int) -> None:
    """Raise when a launch function returned a CUDA error."""
    if code != 0:
        err = function(name, "kernel_error_string", [ctypes.c_int])
        err.restype = ctypes.c_char_p
        raise RuntimeError(
            f"{name} kernel launch failed: CUDA error {code} "
            f"({err(code).decode()})"
        )

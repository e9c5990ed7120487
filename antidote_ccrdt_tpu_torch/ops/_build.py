"""Build the package's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` exports plain C functions (no PyTorch headers, so
one nvcc call takes seconds) that take raw device pointers, sizes and a
stream handle and return ``cudaGetLastError()``; ``csrc/*.cuh`` holds
device helpers the sources share. ``load(name, argtypes, symbol)``
compiles the source into ``build/lib<name>.so`` for ``sm_90a`` when the
library is missing or older than its source or a header, and returns its
C function ``symbol`` (default ``name``) with its argument types
declared. ``build_all()`` starts one nvcc per source at once.

Nothing here runs when the package is imported: the CPU tests import every
module on a machine without nvcc.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Optional

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
SOURCES = ("scatter_max_rows", "delta_place", "sort_slots")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

# ptxas register/spill report of each build in this process, by source.
BUILD_LOG: Dict[str, str] = {}

_fns: Dict[str, ctypes._CFuncPtr] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _paths(name: str):
    return CSRC_DIR / f"{name}.cu", BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    src, lib = _paths(name)
    newest = max(p.stat().st_mtime for p in (src, *CSRC_DIR.glob("*.cuh")))
    return not lib.exists() or lib.stat().st_mtime < newest


def _start(name: str) -> subprocess.Popen:
    src, lib = _paths(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Build under a private name and rename: concurrent processes never
    # load a half-written library.
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    proc.tmp_path = tmp  # type: ignore[attr-defined]
    proc.lib_path = lib  # type: ignore[attr-defined]
    return proc


def _finish(name: str, proc: subprocess.Popen) -> None:
    out, _ = proc.communicate()
    BUILD_LOG[name] = out
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu (rc {proc.returncode}):\n{out}")
    os.replace(proc.tmp_path, proc.lib_path)  # type: ignore[attr-defined]


def build_all(names: Iterable[str] = SOURCES) -> None:
    """Compile every stale source, one nvcc per source, all at once."""
    names = [n for n in names if _stale(n)]
    procs: List[subprocess.Popen] = [_start(n) for n in names]
    errors: List[str] = []
    for n, p in zip(names, procs):
        try:
            _finish(n, p)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str, argtypes: List[type], symbol: Optional[str] = None) -> ctypes._CFuncPtr:
    """The C function `symbol` (default `name`) of ``csrc/<name>.cu``
    (built first if needed), taking `argtypes` and returning a CUDA error
    code."""
    symbol = symbol or name
    with _lock:
        fn: Optional[ctypes._CFuncPtr] = _fns.get(symbol)
        if fn is None:
            if _stale(name):
                _finish(name, _start(name))
            fn = getattr(ctypes.CDLL(str(_paths(name)[1])), symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _fns[symbol] = fn
        return fn


def check(rc: int, what: str) -> None:
    """Raise if a kernel's C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")

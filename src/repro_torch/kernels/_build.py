"""Build and load the port's CUDA kernels.

Every ``src/repro_torch/csrc/*.cu`` is compiled by ``nvcc`` for
``sm_90a`` into an object of its own (one ``nvcc`` per source, all
started together), and the objects are linked into
``build/kernels/libmadlib_kernels.so`` at the repository root.  The
library has a plain C interface and is loaded with ``ctypes``: no
PyTorch headers are compiled, so a build takes seconds.  The build runs
at first use and again whenever a source is newer than the library.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises when that is not 0.
"""

from __future__ import annotations

import ctypes
import fcntl
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
LIB_PATH = BUILD_DIR / "libmadlib_kernels.so"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_SIGNATURES = {
    "madlib_xtx": [_P, _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_longlong, _P],
    "madlib_xtx_narrow": [_P, _P, _P, _P, _P, ctypes.c_longlong,
                          ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_int, ctypes.c_int, _P],
    "madlib_xtx_narrow_ctas_per_sm": [ctypes.c_int, ctypes.c_int,
                                      ctypes.c_int],
    "madlib_column_stats": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                            ctypes.c_longlong, ctypes.c_int,
                            ctypes.c_longlong, ctypes.c_longlong,
                            ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                            ctypes.c_int, ctypes.c_int, ctypes.c_int,
                            ctypes.c_longlong, _P],
    "madlib_segment_linregr": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                               ctypes.c_int, ctypes.c_int, ctypes.c_int,
                               ctypes.c_int, ctypes.c_int, ctypes.c_int, _P],
    "madlib_countmin": [_P, _P, _P, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_int, ctypes.c_longlong, _P],
    "madlib_segment_countmin": [_P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
                                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                ctypes.c_int, _P],
    "madlib_segment_fm": [_P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int, ctypes.c_int, ctypes.c_int, _P],
    "madlib_kmeans_assign": [_P, _P, _P, _P, _P, _P, _P, _P,
                             ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                             ctypes.c_int, _P],
    "madlib_flash_attention": [_P, _P, _P, _P, _P, ctypes.c_int,
                               ctypes.c_int, ctypes.c_int, ctypes.c_int,
                               ctypes.c_int, ctypes.c_int,
                               *[ctypes.c_longlong] * 12, ctypes.c_float,
                               ctypes.c_int, _P],
    "madlib_flash_attention_tc": [_P, _P, _P, _P, _P, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int, *[ctypes.c_longlong] * 12,
                                  ctypes.c_float, ctypes.c_int, _P],
    "madlib_flash_attention_bwd": [*[_P] * 10, *[ctypes.c_int] * 6,
                                   *[ctypes.c_longlong] * 24, ctypes.c_float,
                                   ctypes.c_int, _P],
    "madlib_flash_attention_bwd_tc": [*[_P] * 10, *[ctypes.c_int] * 5,
                                      *[ctypes.c_longlong] * 24,
                                      ctypes.c_float, ctypes.c_int, _P],
}

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
# what the last build printed: seconds, and ptxas' registers/spills lines
last_build: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card, from the CUDA toolkit")


def build(force: bool = False) -> Path:
    """Compile the sources (in parallel) and link the library; returns its
    path.  Raises with the compiler's output when a step fails.

    The objects and the temporary library have fixed names, so the whole
    build holds an exclusive ``flock`` on ``build/kernels/.lock``: a
    second process waits, then finds the library fresh and returns."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            return _build_locked(force)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _build_locked(force: bool) -> Path:
    sources = sorted(CSRC.glob("*.cu"))
    headers = sorted(CSRC.glob("*.cuh"))
    newest = max(p.stat().st_mtime for p in sources + headers)
    if not force and LIB_PATH.exists() and LIB_PATH.stat().st_mtime >= newest:
        return LIB_PATH
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src in sources:
        obj = BUILD_DIR / (src.stem + ".o")
        cmd = [nvcc, *ARCH, *FLAGS, "-I", str(CSRC), "-c", str(src),
               "-o", str(obj)]
        jobs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs = []
    for src, _obj, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{out}")
        logs.append(out)
    tmp = LIB_PATH.with_suffix(".so.tmp")
    link = subprocess.run(
        [nvcc, *ARCH, "-shared", "-o", str(tmp),
         *(str(obj) for _src, obj, _p in jobs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    tmp.replace(LIB_PATH)
    last_build.clear()
    last_build.update(
        seconds=time.perf_counter() - t0,
        ptxas=[line.strip() for log in logs for line in log.splitlines()
               if "registers" in line or "spill" in line
               or "Compiling entry" in line])
    return LIB_PATH


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIB = handle
        return _LIB


def check(name: str, err: int) -> None:
    """Raise when a C entry point reports a launch error."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")

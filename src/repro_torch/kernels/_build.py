"""Build and load the CUDA kernels of ``csrc/`` with ``nvcc`` and ``ctypes``.

Each ``csrc/<name>.cu`` compiles to its own shared library with a plain C
interface (``nvcc -gencode arch=compute_90a,code=sm_90a -O3``, IEEE division
and rounding: no ``--use_fast_math``). All sources build together, one
``nvcc`` process each, at the first launch of any kernel; a library is
rebuilt when the hash of its sources changes. Nothing here runs at import
time, so the CPU tests import every module without a compiler.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
SOURCES = ("table_precompute", "lut_mpgemm", "fused_lut_mpgemm",
           "dequant_mpgemm")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# C signature of each library's launch function (see csrc/*.cu)
_SIGNATURES = {
    "table_precompute": ("table_precompute_launch",
                         [_P, _P, _P, _P, _I, _I, _I, _I, _P]),
    "lut_mpgemm": ("lut_mpgemm_launch",
                   [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _I, _I,
                    _I, _I, _P]),
    "fused_lut_mpgemm": ("fused_lut_mpgemm_launch",
                         [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P,
                          _I, _I, _I, _I, _P]),
    "dequant_mpgemm": ("dequant_mpgemm_launch",
                       [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _I, _I, _P]),
}

_loaded: Dict[str, object] = {}  # name -> ctypes launch function
build_seconds = None  # wall time of the last build_all(), for reports


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def build_all() -> Dict[str, Path]:
    """Compile every stale source in parallel; return name -> library path.

    Raises RuntimeError with the compiler's output if any build fails. The
    compiler's resource report (``-Xptxas -v``) is kept beside each library
    as ``<name>.ptxas.txt``.
    """
    global build_seconds
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in SOURCES:
        lib = _lib_path(name)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        (BUILD_DIR / f"{name}.ptxas.txt").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    build_seconds = time.perf_counter() - t0
    return {name: _lib_path(name) for name in SOURCES}


def launcher(name: str):
    """The ctypes launch function of kernel library ``name`` (built on first
    use). It returns the launch's ``cudaGetLastError()`` as an int."""
    fn = _loaded.get(name)
    if fn is None:
        paths = build_all()
        for lib_name, path in paths.items():
            symbol, argtypes = _SIGNATURES[lib_name]
            f = getattr(ctypes.CDLL(str(path)), symbol)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
            _loaded[lib_name] = f
        fn = _loaded[name]
    return fn


def check(name: str, rc: int):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with "
                           f"cudaError {rc}")

"""Build and load the CUDA kernels of ``csrc/`` with ``nvcc`` and ``ctypes``.

Each ``csrc/<name>.cu`` compiles to its own shared library with a plain C
interface (``nvcc -gencode arch=compute_90a,code=sm_90a -O3``, IEEE division
and rounding: no ``--use_fast_math``). All sources build together, one
``nvcc`` process each, at the first launch of any kernel; a library is
rebuilt when the hash of its sources changes. A variant of one source,
built with extra ``-D`` defines, gets a library of its own (``library``).
Nothing here runs at import time, so the CPU tests import every module
without a compiler.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
SOURCES = ("table_precompute", "lut_mpgemm", "fused_lut_mpgemm",
           "dequant_mpgemm")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# C signature of each launch function (see csrc/*.cu), by entry name: a
# library's own launch function, or a second entry of a library (``_LIBRARY``)
_SIGNATURES = {
    "table_precompute": ("table_precompute_launch",
                         [_P, _P, _P, _P, _I, _I, _I, _I, _P]),
    "lut_mpgemm": ("lut_mpgemm_launch",
                   [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _I,
                    _I, _I, _I, _I, _P]),
    "fused_lut_mpgemm": ("fused_lut_mpgemm_launch",
                         [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P,
                          _I, _I, _I, _I, _I, _P]),
    "dequant_mpgemm": ("dequant_mpgemm_launch",
                       [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _I, _I,
                        _I, _P]),
    "row_scale": ("row_scale_launch", [_P, _P, _I, _I, _I, _P]),
}
# entry name -> the library that holds it, where the two names differ
_LIBRARY = {"row_scale": "table_precompute"}

_libs: Dict[Tuple[str, Tuple[str, ...]], ctypes.CDLL] = {}  # (name, defines)
_loaded: Dict[str, object] = {}  # name -> ctypes launch function
build_seconds = None  # wall time of the last build_all(), for reports


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def _digest(name: str, defines: Sequence[str] = ()) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + tuple(defines)).encode())
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _lib_path(name: str, defines: Sequence[str] = ()) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name, defines)}.so"


def _compile(jobs: Sequence[Tuple[str, Tuple[str, ...]]]) -> None:
    """Compile the stale (source, defines) jobs in parallel, one ``nvcc``
    each. Raises RuntimeError with the compiler's output if any fails; the
    compiler's resource report (``-Xptxas -v``) of a build without defines
    is kept as ``<name>.ptxas.txt``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = []
    for name, defines in jobs:
        lib = _lib_path(name, defines)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, *defines, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs.append((name, defines, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, lib))
    failed = []
    for name, defines, proc, tmp, lib in procs:
        log, _ = proc.communicate()
        if not defines:
            (BUILD_DIR / f"{name}.ptxas.txt").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- {name} {' '.join(defines)} (nvcc exit "
                          f"{proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))


def build_all() -> Dict[str, Path]:
    """Compile every stale source in parallel; return name -> library path."""
    global build_seconds
    t0 = time.perf_counter()
    _compile([(name, ()) for name in SOURCES])
    build_seconds = time.perf_counter() - t0
    return {name: _lib_path(name) for name in SOURCES}


def library(name: str, defines: Sequence[str] = ()) -> ctypes.CDLL:
    """The loaded library of kernel source ``name``, built on first use
    (with ``defines``, e.g. ``("-DDEQUANT_TERMS=2",)``, that source alone;
    without, every source)."""
    key = (name, tuple(defines))
    if key not in _libs:
        if defines:
            _compile([key])
            _libs[key] = ctypes.CDLL(str(_lib_path(name, defines)))
        else:
            for lib_name, path in build_all().items():
                _libs.setdefault((lib_name, ()), ctypes.CDLL(str(path)))
    return _libs[key]


def launcher(name: str, defines: Sequence[str] = ()):
    """The ctypes launch function of entry ``name`` (``_SIGNATURES``; its
    library built on first use). It returns the launch's
    ``cudaGetLastError()`` as an int."""
    fn = None if defines else _loaded.get(name)
    if fn is None:
        symbol, argtypes = _SIGNATURES[name]
        fn = getattr(library(_LIBRARY.get(name, name), defines), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        if not defines:
            _loaded[name] = fn
    return fn


def check(name: str, rc: int):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with "
                           f"cudaError {rc}")

"""Compile-on-first-use loader for the port's native C++ host helpers
(port of ``dpsvm_tpu/native/build.py``).

``csv_loader.cpp`` becomes one shared library, built with g++ (JAX's flags:
``-O3 -shared -fPIC -std=gnu++17``) the first time a loader needs it, into ``dpsvm_tpu_torch/_build/`` (listed in .gitignore).
The file name carries a hash of the source and the flags, as the CUDA
libraries' names do (``dpsvm_tpu_torch/build.py``), so an edited source is
rebuilt and a stale library is never loaded. ctypes binds the C ABI.

This is host parsing, not a device kernel, so it degrades as the JAX
package's does: with no compiler, a failed build or ``DPSVM_NO_NATIVE``
set, ``load_native_lib`` returns None and the callers take their
pure-Python paths. The choice stays visible: every data load records the
path it took, and ``last_path()`` reports the latest. ``build_native``
is the strict entry (it raises on failure) for callers that must have the
library, such as ``chip_smoke.py``'s build phase.
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
from typing import Optional

PACKAGE_DIR = Path(__file__).resolve().parents[1]
SOURCE = Path(__file__).resolve().parent / "csv_loader.cpp"
BUILD_DIR = PACKAGE_DIR / "_build"
# gnu++17 (not c++17): the strict dialect hides POSIX prototypes such as
# getline(3) that the loader depends on.
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=gnu++17"]

_lock = threading.Lock()
_cached: Optional[ctypes.CDLL] = None
_failed = False
# The path the latest data load took: "native" or "python".
_LAST = {"path": None}


def note_path(path: str) -> None:
    """Record the path ("native" or "python") a data load just took."""
    _LAST["path"] = path


def last_path() -> Optional[str]:
    """"native" or "python": the path the latest data load took (None
    before the first one)."""
    return _LAST["path"]


def _compiler() -> Optional[str]:
    return shutil.which("g++") or shutil.which("c++") or shutil.which(
        "clang++")


def library_path() -> Path:
    tag = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libdpsvm_native-{tag}.so"


def build_native() -> dict:
    """Build the library unless it exists; returns its path and the
    seconds g++ took (0.0 when already built). Raises ``RuntimeError``
    when there is no compiler or the build fails."""
    out = library_path()
    if out.exists():
        return {"path": str(out), "seconds": 0.0, "log": ""}
    cxx = _compiler()
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++, c++ or clang++) on PATH: "
                           "the native host helpers cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"native build failed ({cxx} exit "
                           f"{proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return {"path": str(out), "seconds": time.perf_counter() - t0,
            "log": proc.stderr}


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_float_p = ctypes.POINTER(ctypes.c_float)
    c_int_p = ctypes.POINTER(ctypes.c_int)
    c_long_p = ctypes.POINTER(ctypes.c_long)

    lib.dpsvm_csv_shape.argtypes = [ctypes.c_char_p, c_long_p, c_long_p]
    lib.dpsvm_csv_shape.restype = ctypes.c_int
    lib.dpsvm_parse_csv.argtypes = [ctypes.c_char_p, c_float_p, c_int_p,
                                    ctypes.c_long, ctypes.c_long]
    lib.dpsvm_parse_csv.restype = ctypes.c_long
    lib.dpsvm_libsvm_stats.argtypes = [ctypes.c_char_p, ctypes.c_long,
                                       c_long_p]
    lib.dpsvm_libsvm_stats.restype = ctypes.c_long
    lib.dpsvm_parse_libsvm.argtypes = [ctypes.c_char_p, c_float_p,
                                       c_float_p, ctypes.c_long,
                                       ctypes.c_long]
    lib.dpsvm_parse_libsvm.restype = ctypes.c_long
    return lib


def load_native_lib() -> Optional[ctypes.CDLL]:
    """The bound native library, built first if needed; None (remembered
    for the process) when it cannot be built or loaded, or when
    ``DPSVM_NO_NATIVE`` is set: callers then take their Python paths."""
    global _cached, _failed
    if os.environ.get("DPSVM_NO_NATIVE"):
        return None
    if _cached is not None or _failed:
        return _cached
    with _lock:
        if _cached is not None or _failed:
            return _cached
        try:
            _cached = _bind(ctypes.CDLL(build_native()["path"]))
        except (RuntimeError, OSError, AttributeError,
                subprocess.SubprocessError):
            _failed = True
            _cached = None
    return _cached


def reset() -> None:
    """Forget the loaded library and a remembered failure (tests that
    monkeypatch the compiler away)."""
    global _cached, _failed
    with _lock:
        _cached, _failed = None, False

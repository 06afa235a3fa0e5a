"""Build the port's CUDA sources with nvcc and load them through ctypes.

Each source under ``csrc/`` becomes one shared library with a plain C
interface, compiled for Hopper (``sm_90a``) at first use into
``dpsvm_tpu_torch/_build/`` (listed in .gitignore). The library's file name
carries a hash of the source and the flags, so an edited source is rebuilt
and a stale library is never loaded. ``build_all`` starts one nvcc per
source, all at once, and waits for them together; each build is one
``build:<library>`` observation (``observability/compilewatch``), which a
run in progress records in its trace.

Nothing here runs at import time: the CPU tests import every module and
have no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional

from dpsvm_tpu_torch.observability import compilewatch

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Every source of the port, by library name.
SOURCES = {"fused_step": "fused_step.cu", "subsolve": "subsolve.cu"}

_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are built at first use "
        "from dpsvm_tpu_torch/csrc (needs the CUDA toolkit on PATH or "
        "under /usr/local/cuda)")


def _target(name: str) -> Path:
    src = (CSRC_DIR / SOURCES[name]).read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build_all(names: Optional[List[str]] = None) -> Dict[str, dict]:
    """Compile every missing library in parallel. Returns, per library,
    its path, the seconds its nvcc took (0.0 when already built) and the
    compiler's resource report (``-Xptxas -v``). Raises on any failure."""
    names = list(SOURCES) if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    report = {}
    for name in names:
        out = _target(name)
        if out.exists():
            report[name] = {"path": str(out), "seconds": 0.0, "log": ""}
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
        report[name] = {"path": str(out), "seconds": secs, "log": log}
        # one build is one compile record of the run trace in progress
        compilewatch.observe(f"build:{name}", secs,
                             signature=SOURCES[name])
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return report


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if it is missing."""
    lib = _LOADED.get(name)
    if lib is None:
        out = _target(name)
        if not out.exists():
            build_all([name])
        lib = ctypes.CDLL(str(out))
        _LOADED[name] = lib
    return lib

"""The model file's writer and reader: the port's Python ones against the
C++ ones of its native helper (``dpsvm_write_model``, ``dpsvm_model_shape``
and ``dpsvm_parse_model`` in ``dpsvm_tpu_torch/native/csv_loader.cpp``,
which the port does not call: this script binds them itself).

Writes one reference-layout RBF model (default: 8310 support vectors x
784 features, the shape of chip_smoke.py's float32 fused model, random
alphas and rows from a seed) both ways, checks the two files are the same
bytes and read back to the same arrays both ways, and prints one JSON line
with the seconds of each save and load (the best of ``--reps``).

    python3 scripts/model_file_io.py [--n-sv 8310] [--d 784] [--reps 3]
"""

import argparse
import ctypes
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _bind(lib):
    f, i, lo = (ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_long))
    d = ctypes.POINTER(ctypes.c_double)
    lib.dpsvm_write_model.argtypes = [ctypes.c_char_p, ctypes.c_double,
                                      ctypes.c_double, f, i, f,
                                      ctypes.c_long, ctypes.c_long]
    lib.dpsvm_write_model.restype = ctypes.c_long
    lib.dpsvm_model_shape.argtypes = [ctypes.c_char_p, lo, lo,
                                      ctypes.POINTER(ctypes.c_int), d, d]
    lib.dpsvm_model_shape.restype = ctypes.c_int
    lib.dpsvm_parse_model.argtypes = [ctypes.c_char_p, f, i, f,
                                      ctypes.c_long, ctypes.c_long,
                                      ctypes.c_int]
    lib.dpsvm_parse_model.restype = ctypes.c_long
    return lib


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _native_save(lib, m, path):
    x = np.ascontiguousarray(m.x_sv, np.float32)
    got = lib.dpsvm_write_model(
        path.encode(), float(m.gamma), float(m.b),
        _ptr(np.ascontiguousarray(m.alpha, np.float32), ctypes.c_float),
        _ptr(np.ascontiguousarray(m.y_sv, np.int32), ctypes.c_int),
        _ptr(x, ctypes.c_float), x.shape[0], x.shape[1])
    if got < 0:
        raise RuntimeError(f"dpsvm_write_model: {got}")


def _native_load(lib, path):
    n, d, hb = ctypes.c_long(), ctypes.c_long(), ctypes.c_int()
    g, b = ctypes.c_double(), ctypes.c_double()
    rc = lib.dpsvm_model_shape(path.encode(), ctypes.byref(n),
                               ctypes.byref(d), ctypes.byref(hb),
                               ctypes.byref(g), ctypes.byref(b))
    if rc != 0:
        raise RuntimeError(f"dpsvm_model_shape: {rc}")
    alpha = np.empty(n.value, np.float32)
    y = np.empty(n.value, np.int32)
    x = np.empty((n.value, d.value), np.float32)
    got = lib.dpsvm_parse_model(path.encode(), _ptr(alpha, ctypes.c_float),
                                _ptr(y, ctypes.c_int),
                                _ptr(x, ctypes.c_float), n.value, d.value,
                                hb.value)
    if got != n.value:
        raise RuntimeError(f"dpsvm_parse_model: {got}")
    return x, alpha, y, b.value, g.value


def _best(fn, reps):
    out, best = None, float("inf")
    for _ in range(reps):
        t = time.perf_counter()
        out = fn()
        best = min(best, time.perf_counter() - t)
    return out, best


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-sv", type=int, default=8310)
    ap.add_argument("--d", type=int, default=784)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    from dpsvm_tpu_torch.convert import model_from_numpy
    from dpsvm_tpu_torch.models.io import load_model, save_model
    from dpsvm_tpu_torch.native import build as nbuild

    lib = nbuild.load_native_lib()
    if lib is None:
        raise SystemExit("the native helper did not build")
    lib = _bind(lib)
    rng = np.random.default_rng(args.seed)
    x = rng.standard_normal((args.n_sv, args.d)).astype(np.float32)
    alpha = rng.uniform(1e-3, 10.0, args.n_sv).astype(np.float32)
    y = np.where(rng.random(args.n_sv) < 0.5, -1, 1).astype(np.int32)
    m = model_from_numpy(x, alpha, y, -0.123456789, 0.25)
    with tempfile.TemporaryDirectory() as tmp:
        pp, pn = os.path.join(tmp, "py.model"), os.path.join(tmp, "c.model")
        _, save_py = _best(lambda: save_model(m, pp), args.reps)
        _, save_c = _best(lambda: _native_save(lib, m, pn), args.reps)
        back_py, load_py = _best(lambda: load_model(pp), args.reps)
        back_c, load_c = _best(lambda: _native_load(lib, pn), args.reps)
        same_bytes = open(pp, "rb").read() == open(pn, "rb").read()
        same = (np.array_equal(back_py.x_sv, back_c[0])
                and np.array_equal(back_py.alpha, back_c[1])
                and np.array_equal(back_py.y_sv, back_c[2])
                and back_py.b == back_c[3] and back_py.gamma == back_c[4]
                and np.array_equal(back_py.x_sv, x))
        size = os.path.getsize(pp)
    print(json.dumps({"n_sv": args.n_sv, "d": args.d, "bytes": size,
                      "reps": args.reps,
                      "save_python_seconds": save_py,
                      "save_native_seconds": save_c,
                      "load_python_seconds": load_py,
                      "load_native_seconds": load_c,
                      "same_bytes": same_bytes, "same_arrays": bool(same)}))
    if not (same_bytes and same):
        raise SystemExit(1)


if __name__ == "__main__":
    main()

"""Dataset loaders (port of ``dpsvm_tpu/data/loader.py``, numpy only).

Three forms, told apart by ``load_dataset``:

* dense CSV, lines ``label,f1,...,fd`` (the reference's ``populate_data``,
  ``parse.cpp:10-43``);
* libsvm / svmlight, lines ``label idx:val ...`` with 1-based indices and
  absent features 0 (``sniff_format`` tells the two apart);
* a shard directory written by ``convert shards`` (``data/stream.py``),
  read through its manifest-CRC integrity path.

Either file format becomes a row-major float32 matrix x (n, d) and an
int32 label vector y, or with ``float_labels`` a float32 target vector
(regression). The hot parse of both file formats runs in the native C++
helper (``native/csv_loader.cpp``), as in the JAX package; the pure-Python
parsers are the fallback (no compiler) and the source of line-numbered
error messages, and the CSV parse of ``float_labels`` stays in Python, as
there (the native path emits int labels). ``native.last_path()`` says
which path the latest load took. The shape comes from the file unless
given; NaN/Inf features are rejected with an error naming the row and
column unless ``allow_nonfinite``.
"""

from __future__ import annotations

import ctypes
import os
import sys
from typing import Optional, Tuple

import numpy as np

from dpsvm_tpu_torch.native import load_native_lib, note_path


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def csv_shape(path: str) -> Tuple[int, int]:
    """(num_examples, num_attributes) of a dense CSV; the label column is
    not an attribute."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    lib = load_native_lib()
    if lib is not None:
        rows, cols = ctypes.c_long(), ctypes.c_long()
        if lib.dpsvm_csv_shape(path.encode(), ctypes.byref(rows),
                               ctypes.byref(cols)) == 0:
            return int(rows.value), max(0, int(cols.value) - 1)
    n = d = 0
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            if n == 0:
                d = line.count(",")
            n += 1
    return n, d


def load_csv(path: str, num_examples: Optional[int] = None,
             num_attributes: Optional[int] = None,
             float_labels: bool = False, allow_nonfinite: bool = False
             ) -> Tuple[np.ndarray, np.ndarray]:
    """Load a dense ``label,f1,...,fd`` CSV into (x float32, y int32).
    With explicit shape arguments (the reference's ``-x`` / ``-a``), only
    that many rows / columns are read, and a short file is an error.
    ``float_labels=True`` keeps y as float32 (regression targets; the
    Python parse, as in the JAX package). ``allow_nonfinite`` loads NaN /
    Inf features with a warning instead of refusing the file."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    if num_examples is None or num_attributes is None:
        n_file, d_file = csv_shape(path)
        n = num_examples if num_examples is not None else n_file
        d = num_attributes if num_attributes is not None else d_file
    else:
        n, d = num_examples, num_attributes
    if n <= 0 or d <= 0:
        raise ValueError(f"empty dataset: {path!r} has shape ({n}, {d})")
    lib = None if float_labels else load_native_lib()
    if lib is not None:
        x = np.empty((n, d), dtype=np.float32)
        y = np.empty((n,), dtype=np.int32)
        got = lib.dpsvm_parse_csv(
            path.encode(), _f32p(x),
            y.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), n, d)
        if got == n:
            note_path("native")
            return _check_finite(x, path, allow_nonfinite), y
        # A malformed or short file: the Python parse names the line.
    note_path("python")
    xs = np.empty((n, d), dtype=np.float32)
    ys = np.empty((n,), dtype=np.float32 if float_labels else np.int32)
    i = 0
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            if i >= n:
                break
            line = line.strip()
            if not line:
                continue
            parts = line.split(",")
            if len(parts) < d + 1:
                raise ValueError(
                    f"{path}:{lineno}: expected {d + 1} fields, got "
                    f"{len(parts)}")
            try:
                lab = float(parts[0])
                xs[i] = np.asarray(parts[1:d + 1], dtype=np.float32)
            except ValueError as e:
                raise ValueError(f"{path}:{lineno}: {e}") from e
            ys[i] = lab if float_labels else int(lab)
            i += 1
    if i < n:
        raise ValueError(f"{path}: expected {n} rows, found {i}")
    return _check_finite(xs, path, allow_nonfinite), ys


def _load_libsvm_native(lib, path, num_examples, num_attributes,
                        float_labels, allow_nonfinite=False):
    """The C++ fast path of ``load_libsvm``; None falls back to Python
    (hard parse errors, so that the message names the line, and the
    label checks the scalar return code cannot carry)."""
    if num_examples is not None and num_attributes is not None:
        # Both shapes known: the fill pass's row count covers short files.
        n, d = num_examples, num_attributes
    else:
        max_idx = ctypes.c_long(0)
        n_found = lib.dpsvm_libsvm_stats(path.encode(),
                                         int(num_examples or 0),
                                         ctypes.byref(max_idx))
        if n_found <= 0:
            return None
        n = num_examples if num_examples is not None else int(n_found)
        if n_found < n:
            return None
        d = (num_attributes if num_attributes is not None
             else int(max_idx.value))
    if d <= 0:
        return None
    x = np.zeros((n, d), dtype=np.float32)
    y = np.empty((n,), dtype=np.float32)
    if lib.dpsvm_parse_libsvm(path.encode(), _f32p(x), _f32p(y), n, d) != n:
        return None
    if np.any(np.abs(y) >= 2 ** 24):
        return None                     # float32 labels stop being exact
    if not float_labels:
        yi = y.astype(np.int32)
        if not np.array_equal(yi.astype(np.float32), y):
            return None                 # non-integer labels: Python error
        y = yi
    return _check_finite(x, path, allow_nonfinite), y


def sniff_format(path: str) -> str:
    """"libsvm" or "csv" from the first non-empty data line."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            return "csv" if "," in line else "libsvm"
    return "csv"


def load_libsvm(path: str, num_examples: Optional[int] = None,
                num_attributes: Optional[int] = None,
                float_labels: bool = False, allow_nonfinite: bool = False
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Load a libsvm/svmlight sparse file ``<label> idx:val ...``.

    Indices are 1-based; absent features are 0. Labels are kept as
    integers, as by the CSV loader (the binary trainer's own +/-1 check
    still applies); a non-integer label is an error unless
    ``float_labels`` keeps them as float32 (regression targets). An explicit
    ``num_attributes`` fixes the width: wider pads with zeros, narrower
    drops the higher indices (as ``-a`` narrows a CSV).
    ``num_examples`` reads only that many rows and, as ``load_csv``, is an
    error for a shorter file. Errors name the line. The native parse runs
    first; the Python one (a text-only pass for the shape, then the fill
    of the float32 matrix) is the fallback and owns the error messages."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    if num_examples is not None and num_examples <= 0:
        raise ValueError(f"empty dataset: {path!r} "
                         f"(num_examples={num_examples})")
    lib = load_native_lib()
    if lib is not None:
        out = _load_libsvm_native(lib, path, num_examples, num_attributes,
                                  float_labels, allow_nonfinite)
        if out is not None:
            note_path("native")
            return out
    note_path("python")
    n_rows = 0
    max_idx = 0
    if num_examples is None or num_attributes is None:
        with open(path, "r") as f:
            for lineno, line in enumerate(f, 1):
                if num_examples is not None and n_rows >= num_examples:
                    break
                parts = line.split()
                if not parts or parts[0].startswith("#"):
                    continue
                n_rows += 1
                if num_attributes is None:
                    for tok in parts[1:]:
                        try:
                            idx = int(tok.split(":", 1)[0])
                        except ValueError:
                            continue     # the fill pass owns the error
                        if idx < 1:
                            raise ValueError(
                                f"{path}:{lineno}: feature indices "
                                "are 1-based")
                        max_idx = max(max_idx, idx)
        if n_rows == 0:
            raise ValueError(f"empty dataset: {path!r}")
        if num_examples is not None and n_rows < num_examples:
            raise ValueError(f"{path}: expected {num_examples} rows, "
                             f"found {n_rows}")
        n = num_examples if num_examples is not None else n_rows
    else:
        n = num_examples
    d = num_attributes if num_attributes is not None else max_idx
    if d <= 0:
        raise ValueError(f"{path}: no features found")
    x = np.zeros((n, d), dtype=np.float32)
    ys = np.empty((n,), dtype=np.float32 if float_labels else np.int32)
    i = 0
    with open(path, "r") as f:
        for lineno, line in enumerate(f, 1):
            if i >= n:
                break
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            try:
                lab_f = float(parts[0])
            except ValueError as e:
                raise ValueError(
                    f"{path}:{lineno}: bad label {parts[0]!r}") from e
            if float_labels:
                ys[i] = lab_f
            else:
                lab = int(lab_f)
                if lab != lab_f:
                    raise ValueError(
                        f"{path}:{lineno}: non-integer label {parts[0]!r} "
                        "(classification labels must be integers; "
                        "regression loads with float_labels=True)")
                ys[i] = lab
            for tok in parts[1:]:
                try:
                    idx_s, val_s = tok.split(":", 1)
                    idx = int(idx_s)
                    val = np.float32(val_s)
                except ValueError as e:
                    raise ValueError(
                        f"{path}:{lineno}: bad feature token {tok!r}") from e
                if idx < 1:
                    raise ValueError(
                        f"{path}:{lineno}: feature indices are 1-based")
                if idx <= d:     # narrowing drops higher indices
                    x[i, idx - 1] = val
            i += 1
    if i == 0:
        raise ValueError(f"empty dataset: {path!r}")
    if i < n:
        raise ValueError(f"{path}: expected {n} rows, found {i}")
    return _check_finite(x, path, allow_nonfinite), ys


def load_dataset(path: str, num_examples: Optional[int] = None,
                 num_attributes: Optional[int] = None,
                 float_labels: bool = False, allow_nonfinite: bool = False,
                 mem_budget_mb: Optional[float] = None,
                 on_bad_shard: str = "raise"
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Load a dataset in any supported form: the one source API train,
    test and CV read through.

    ``path`` is a dense CSV, a libsvm file (sniffed) or a shard directory
    (``convert shards``): its reads go through the manifest-CRC integrity
    path with bounded retry and the ``on_bad_shard`` policy. Files honour
    the reference's ``-x`` / ``-a`` shape overrides (short files error);
    a shard directory takes ``-x`` as a row prefix and refuses a ``-a``
    that differs from its width. ``mem_budget_mb`` refuses, up front and
    naming the shard-count math (``stream.MemBudgetError``), a load whose
    arrays would not fit; training on data that must not materialize is
    ``approx.primal.fit_approx_stream`` over the directory itself."""
    from dpsvm_tpu_torch.data import stream as streamlib
    if os.path.isdir(path):
        ds = streamlib.ShardedDataset.open(path)
        if num_attributes is not None and num_attributes != ds.d:
            raise ValueError(
                f"{path}: shard dataset is {ds.d} wide; -a "
                f"{num_attributes} cannot re-shape fixed shards "
                "(re-convert the source instead)")
        x, y = ds.materialize(mem_budget_mb=mem_budget_mb,
                              on_bad_shard=on_bad_shard,
                              allow_nonfinite=allow_nonfinite)
        if num_examples is not None:
            if num_examples > len(y):
                raise ValueError(f"{path}: expected {num_examples} "
                                 f"rows, found {len(y)}")
            x, y = x[:num_examples], y[:num_examples]
        if float_labels:
            y = np.asarray(y, np.float32)
        return x, y
    if mem_budget_mb:
        n_est, d_est, _fmt = streamlib.source_shape(path)
        streamlib.check_materialize_budget(
            mem_budget_mb,
            n=num_examples if num_examples is not None else n_est,
            d=num_attributes if num_attributes is not None else d_est,
            what=path)
    if sniff_format(path) == "libsvm":
        return load_libsvm(path, num_examples, num_attributes,
                           float_labels, allow_nonfinite)
    return load_csv(path, num_examples, num_attributes, float_labels,
                    allow_nonfinite)


def _check_finite(x: np.ndarray, path: str,
                  allow: bool = False) -> np.ndarray:
    """NaN/Inf features would poison f and never converge; fail at load
    time, naming the first offending cell. ``allow`` (the
    ``--allow-nonfinite`` escape hatch) turns the refusal into a warning.
    The clean path is two reductions (NaN survives min, inf max), so it
    allocates nothing; the mask is built only to name the cell."""
    if x.size and np.isfinite(x.min()) and np.isfinite(x.max()):
        return x
    if not np.isfinite(x).all():
        bad = np.argwhere(~np.isfinite(x))[0]
        msg = (f"{path}: non-finite feature value at row {int(bad[0])}, "
               f"column {int(bad[1])} (x[{int(bad[0])},{int(bad[1])}] = "
               f"{x[bad[0], bad[1]]})")
        if not allow:
            raise ValueError(
                msg + " — rejected at load; pass --allow-nonfinite / "
                "allow_nonfinite=True to load anyway")
        n_bad = int((~np.isfinite(x)).sum())
        print(f"WARNING: {msg}; loading anyway with {n_bad} "
              "non-finite value(s) (--allow-nonfinite)",
              file=sys.stderr, flush=True)
    return x

"""Dataset loaders (port of ``dpsvm_tpu/data/loader.py``, numpy only).

Two formats, told apart by ``sniff_format``:

* dense CSV, lines ``label,f1,...,fd`` (the reference's ``populate_data``,
  ``parse.cpp:10-43``);
* libsvm / svmlight, lines ``label idx:val ...`` with 1-based indices and
  absent features 0 (``load_libsvm``, the JAX package's pure-Python
  parser; its C++ fast path is not ported).

Either becomes a row-major float32 matrix x (n, d) and an int32 label
vector y, or with ``float_labels`` a float32 target vector (regression). The shape comes from the file unless given; NaN/Inf features
are rejected with an error naming the row and column. Shard directories
are not ported.
"""

from __future__ import annotations

import os
import warnings
from typing import Optional, Tuple

import numpy as np


def csv_shape(path: str) -> Tuple[int, int]:
    """(num_examples, num_attributes) of a dense CSV; the label column is
    not an attribute."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
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
             float_labels: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """Load a dense ``label,f1,...,fd`` CSV into (x float32, y int32).
    With explicit shape arguments (the reference's ``-x`` / ``-a``), only
    that many rows / columns are read, and a short file is an error.
    ``float_labels=True`` keeps y as float32 (regression targets)."""
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
    xs = np.empty((n, d), dtype=np.float32)
    ys = np.empty((n,), dtype=np.float32 if float_labels else np.int32)
    i = 0
    with open(path) as f, warnings.catch_warnings():
        # np.fromstring warns (and stops) at a malformed field; the
        # length check below turns that into a line-numbered error.
        warnings.simplefilter("ignore", DeprecationWarning)
        for lineno, line in enumerate(f, 1):
            if i >= n:
                break
            line = line.strip()
            if not line:
                continue
            vals = np.fromstring(line, dtype=np.float64, sep=",")
            if vals.shape[0] < d + 1 or vals.shape[0] != line.count(",") + 1:
                raise ValueError(
                    f"{path}:{lineno}: expected {d + 1} numeric fields, "
                    f"got {line.count(',') + 1}")
            ys[i] = vals[0] if float_labels else int(vals[0])
            xs[i] = vals[1:d + 1]
            i += 1
    if i < n:
        raise ValueError(f"{path}: expected {n} rows, found {i}")
    return _check_finite(xs, path), ys


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
                float_labels: bool = False
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Load a libsvm/svmlight sparse file ``<label> idx:val ...``.

    Indices are 1-based; absent features are 0. Labels are kept as
    integers, as by the CSV loader (the binary trainer's own +/-1 check
    still applies); a non-integer label is an error unless
    ``float_labels`` keeps them as float32 (regression targets). An explicit
    ``num_attributes`` fixes the width: wider pads with zeros, narrower
    drops the higher indices (as ``-a`` narrows a CSV).
    ``num_examples`` reads only that many rows and, as ``load_csv``, is an
    error for a shorter file. Errors name the line. A first, text-only
    pass finds the shape; the second fills the float32 matrix."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    if num_examples is not None and num_examples <= 0:
        raise ValueError(f"empty dataset: {path!r} "
                         f"(num_examples={num_examples})")
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
    return _check_finite(x, path), ys


def load_dataset(path: str, num_examples: Optional[int] = None,
                 num_attributes: Optional[int] = None,
                 float_labels: bool = False
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Load a dataset file: dense CSV or libsvm (``sniff_format``), with
    the reference's ``-x`` / ``-a`` shape overrides; ``float_labels``
    keeps the targets as float32. Shard directories are not ported yet
    (ROADMAP Queue 1 item 10)."""
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path}: shard directories are not ported to dpsvm_tpu_torch "
            "yet (ROADMAP Queue 1 item 10)")
    if sniff_format(path) == "libsvm":
        return load_libsvm(path, num_examples, num_attributes,
                           float_labels)
    return load_csv(path, num_examples, num_attributes, float_labels)


def _check_finite(x: np.ndarray, path: str) -> np.ndarray:
    """NaN/Inf features would poison f and never converge; fail at load
    time, naming the first offending cell."""
    if x.size and np.isfinite(x.min()) and np.isfinite(x.max()):
        return x
    bad = np.argwhere(~np.isfinite(x))[0]
    raise ValueError(
        f"{path}: non-finite feature value at row {int(bad[0])}, column "
        f"{int(bad[1])} (x[{int(bad[0])},{int(bad[1])}] = "
        f"{x[bad[0], bad[1]]}) — rejected at load")

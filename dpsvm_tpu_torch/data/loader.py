"""Dense-CSV dataset loader (port of ``dpsvm_tpu/data/loader.py``, numpy
only).

A file of lines ``label,f1,...,fd`` (the reference's ``populate_data``,
``parse.cpp:10-43``) becomes a row-major float32 matrix x (n, d) and an
int32 label vector y. The shape comes from the file unless given; NaN/Inf
features are rejected with an error naming the row and column. The
libsvm sparse format is not ported yet.
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
             num_attributes: Optional[int] = None
             ) -> Tuple[np.ndarray, np.ndarray]:
    """Load a dense ``label,f1,...,fd`` CSV into (x float32, y int32).
    With explicit shape arguments (the reference's ``-x`` / ``-a``), only
    that many rows / columns are read, and a short file is an error."""
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
    ys = np.empty((n,), dtype=np.int32)
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
            ys[i] = int(vals[0])
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


def load_dataset(path: str, num_examples: Optional[int] = None,
                 num_attributes: Optional[int] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Load a dataset file: dense CSV. Other forms are not ported yet."""
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path}: shard directories are not ported to dpsvm_tpu_torch "
            "yet")
    if sniff_format(path) == "libsvm":
        raise NotImplementedError(
            f"{path}: the libsvm sparse format is not ported to "
            "dpsvm_tpu_torch yet; convert it to dense CSV")
    return load_csv(path, num_examples, num_attributes)


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

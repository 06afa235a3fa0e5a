"""Feature scaling with LIBSVM-compatible range files (svm-scale; port
of ``dpsvm_tpu/data/scale.py``).

The reference repo has no scaling tool, but its workflow assumes one:
RBF kernels are scale-sensitive and the LIBSVM guide's first
preprocessing step is ``svm-scale -l -1 -u 1 -s train.range``. This is
that tool for the formats the loaders accept (dense CSV or libsvm),
writing/reading LIBSVM's own ``.range`` file format so parameter files
interoperate with stock svm-scale:

    x
    <lower> <upper>
    <index> <feature_min> <feature_max>        (1-based, one per feature)

Stock svm-scale's semantics are matched exactly where they are
observable: features with min == max (constant at train time) scale to
0 — svm-scale.c's output() skips them, i.e. emits value 0 — and its
range files may OMIT such features entirely, which the loader accepts
(restoring them as constant) given the data's feature count. Labels are
preserved verbatim (svm-scale never touches the label field).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


class ScaleParams:
    """Per-feature affine scaling to [lower, upper]."""

    def __init__(self, lower: float, upper: float,
                 fmin: np.ndarray, fmax: np.ndarray):
        self.lower = float(lower)
        self.upper = float(upper)
        self.fmin = np.asarray(fmin, np.float32)
        self.fmax = np.asarray(fmax, np.float32)

    @classmethod
    def fit(cls, x: np.ndarray, lower: float = -1.0,
            upper: float = 1.0) -> "ScaleParams":
        if lower >= upper:
            raise ValueError(f"need lower < upper, got [{lower}, {upper}]")
        x = np.asarray(x, np.float32)
        return cls(lower, upper, x.min(axis=0), x.max(axis=0))

    def transform(self, x: np.ndarray) -> np.ndarray:
        """Affine map; constant features scale to 0 (svm-scale.c's
        output() skips them, i.e. emits the value 0); test values
        outside the train range extrapolate beyond [lower, upper], as
        in stock svm-scale."""
        x = np.asarray(x, np.float32)
        if x.shape[1] != len(self.fmin):
            raise ValueError(f"data has {x.shape[1]} features, scaling "
                             f"params have {len(self.fmin)}")
        span = self.fmax - self.fmin
        safe = np.where(span > 0, span, 1.0)
        out = self.lower + (self.upper - self.lower) * (x - self.fmin) / safe
        return np.where(span > 0, out, np.float32(0.0)).astype(np.float32)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write("x\n")
            f.write(f"{self.lower:.9g} {self.upper:.9g}\n")
            for j, (lo, hi) in enumerate(zip(self.fmin, self.fmax), 1):
                f.write(f"{j} {lo:.9g} {hi:.9g}\n")

    @classmethod
    def load(cls, path: str,
             num_features: Optional[int] = None) -> "ScaleParams":
        """Read a range file. Stock svm-scale OMITS constant features
        from its files, so the true feature count is not always
        recoverable from the file alone — pass ``num_features`` (the
        data's width) to restore omitted columns as constants (they
        scale to 0, stock behavior). Omitted-index lines without a
        ``num_features`` hint error rather than guessing."""
        with open(path) as f:
            lines = [ln.strip() for ln in f if ln.strip()]
        if not lines or lines[0] != "x":
            raise ValueError(f"{path}: not a svm-scale range file "
                             "(first line must be 'x'; y-scaling files "
                             "are not supported)")
        if len(lines) < 2:
            raise ValueError(f"{path}: truncated range file (missing "
                             "the lower/upper line)")
        try:
            lower, upper = (float(v) for v in lines[1].split())
        except ValueError as e:
            raise ValueError(f"{path}: bad lower/upper line "
                             f"{lines[1]!r}") from e
        idx, mins, maxs = [], [], []
        for ln in lines[2:]:
            parts = ln.split()
            if len(parts) != 3:
                raise ValueError(f"{path}: bad range line {ln!r}")
            idx.append(int(parts[0]))
            mins.append(float(parts[1]))
            maxs.append(float(parts[2]))
        max_idx = max(idx) if idx else 0
        d = num_features if num_features is not None else max_idx
        if max_idx > d:
            raise ValueError(f"{path}: range file has feature index "
                             f"{max_idx}, data has {d} features")
        if num_features is None and idx != list(range(1, max_idx + 1)):
            raise ValueError(
                f"{path}: range file omits some feature indices (stock "
                "svm-scale drops constant features); the data's feature "
                "count is needed to restore them — load with "
                "num_features, or use scale_file which passes it")
        # omitted features restore as constants (min == max -> scale
        # to 0, stock behavior)
        fmin = np.zeros(d, np.float32)
        fmax = np.zeros(d, np.float32)
        for i, lo, hi in zip(idx, mins, maxs):
            fmin[i - 1] = lo
            fmax[i - 1] = hi
        return cls(lower, upper, fmin, fmax)


def scale_file(src: str, dst: str, *,
               lower: float = -1.0, upper: float = 1.0,
               save_params: Optional[str] = None,
               restore_params: Optional[str] = None) -> Tuple[int, int]:
    """svm-scale for one file: fit (or restore) params, write a scaled
    dense CSV. Returns (rows, features).

    Labels are preserved verbatim like stock svm-scale: they load as
    floats and write back as ints when integral (so classification
    files keep the reference's integer-label format and regression
    targets survive untruncated)."""
    from dpsvm_tpu_torch.data.loader import load_dataset
    from dpsvm_tpu_torch.data.synthetic import save_csv

    if save_params and restore_params:
        raise ValueError("pass save_params or restore_params, not both "
                         "(svm-scale -s vs -r)")
    x, y = load_dataset(src, float_labels=True)
    if np.all(y == np.round(y)):
        y = y.astype(np.int32)
    if restore_params:
        params = ScaleParams.load(restore_params,
                                  num_features=x.shape[1])
    else:
        params = ScaleParams.fit(x, lower, upper)
    if save_params:
        params.save(save_params)
    save_csv(dst, params.transform(x), y)
    return x.shape

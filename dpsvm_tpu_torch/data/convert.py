"""Dataset format converters (port of ``dpsvm_tpu/data/convert.py``).

Python-3 equivalents of the reference's Py2 scripts:

* ``libsvm_to_dense_csv`` — ``scripts/convert_adult.py:23-33``: libsvm
  sparse lines ``<label> idx:val ...`` (1-based indices) to the dense
  ``label,f1,...,fd`` CSV the loaders expect, labels normalized to +/-1.
* ``mnist_to_odd_even_csv`` — ``scripts/convert_mnist_to_odd_even.py:23-29``:
  a ``digit,p1,...,p784`` CSV to an even/odd +/-1 problem with pixels
  scaled into [0, 1] by /255.
"""

from __future__ import annotations

from typing import Optional


def libsvm_to_dense_csv(src: str, dst: str,
                        num_attributes: Optional[int] = None) -> int:
    """Convert a libsvm sparse file to dense CSV. Returns rows written.

    When num_attributes is None it is inferred as the max feature index
    seen in the file (the adult/a9a converter hard-codes 123). Labels
    are normalized to +/-1 by sign, exactly like the reference script
    (``convert_adult.py:23``); loading without that normalization is
    what ``loader.load_libsvm`` (the shared parser used here) is for.
    """
    import numpy as np

    from dpsvm_tpu_torch.data.loader import load_libsvm

    x, y = load_libsvm(src, num_attributes=num_attributes)
    y = np.where(y > 0, 1, -1)
    with open(dst, "w") as out:
        for label, row in zip(y, x):
            out.write(f"{int(label)}," + ",".join(map(str, row)) + "\n")
    return len(y)


def mnist_to_odd_even_csv(src: str, dst: str, scale: float = 255.0,
                          has_header: bool = False) -> int:
    """Convert a digit-labelled CSV to the even(+1)/odd(-1) binary problem."""
    n = 0
    with open(src) as f, open(dst, "w") as out:
        for i, line in enumerate(f):
            if has_header and i == 0:
                continue
            parts = line.strip().split(",")
            if len(parts) < 2:
                continue
            digit = int(float(parts[0]))
            label = 1 if digit % 2 == 0 else -1
            pixels = (repr(float(p) / scale) for p in parts[1:])
            out.write(f"{label}," + ",".join(pixels) + "\n")
            n += 1
    return n

"""Solver diagnostics (port of ``dpsvm_tpu/ops/diagnostics.py``, the
streamed kernel pass only): ``kv = K . coef`` in row blocks, without ever
holding K, which ``api.warm_start`` uses to rebuild f from alpha."""

from __future__ import annotations

import numpy as np
import torch

from dpsvm_tpu_torch.ops.kernels import (KernelSpec, exact_f32, kernel_rows,
                                         row_norms_sq)


def _stream_kv(x: np.ndarray, coef: np.ndarray, spec, block: int,
               device: torch.device) -> np.ndarray:
    """kv = K @ coef in row blocks of ``block`` rows, on ``device``:
    O(block * n) device memory beyond X. For a precomputed kernel x is K
    and a block's rows are its kernel rows."""
    spec = KernelSpec.coerce(spec)
    xd = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)
    x2 = row_norms_sq(xd)
    cf = torch.from_numpy(np.asarray(coef, np.float32)).to(device)
    n = x.shape[0]
    kv = np.empty((n,), np.float32)
    with exact_f32():
        for lo in range(0, n, block):
            hi = min(lo + block, n)
            k = kernel_rows(xd[lo:hi], x2[lo:hi], xd, x2, spec)
            kv[lo:hi] = torch.matmul(k, cf).cpu().numpy()
    return kv

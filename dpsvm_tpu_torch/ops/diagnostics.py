"""Solver diagnostics (port of ``dpsvm_tpu/ops/diagnostics.py``, the
streamed kernel pass only): ``kv = K . coef`` in row blocks, without ever
holding K. ``api.warm_start`` rebuilds f from alpha with ``_stream_kv``;
the shrinking manager rebuilds the inactive rows' f with
``_stream_kv_against`` (``dpsvm_tpu/solver/shrink.py:137-154``). Both are
a ``torch.matmul`` and the kernel's epilogue, as the JAX package computes
them outside any Pallas kernel."""

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
    return _stream_kv_against(x, x, coef, spec, block, device)


def _stream_kv_against(x_rows: np.ndarray, x_sv: np.ndarray,
                       coef_sv: np.ndarray, spec, block: int,
                       device: torch.device) -> np.ndarray:
    """K(x_rows, x_sv) @ coef_sv in row blocks of ``block`` rows of
    ``x_rows``, on ``device``: O(block * len(x_sv)) device memory beyond
    the two inputs. Norms are taken on the device, as the JAX package
    does."""
    spec = KernelSpec.coerce(spec)
    xs = torch.from_numpy(np.ascontiguousarray(x_sv, np.float32)).to(device)
    s2 = row_norms_sq(xs)
    cf = torch.from_numpy(np.asarray(coef_sv, np.float32)).to(device)
    m = x_rows.shape[0]
    out = np.empty((m,), np.float32)
    with exact_f32():
        for lo in range(0, m, block):
            hi = min(lo + block, m)
            xb = torch.from_numpy(np.ascontiguousarray(
                x_rows[lo:hi], np.float32)).to(device)
            k = kernel_rows(xb, row_norms_sq(xb), xs, s2, spec)
            out[lo:hi] = torch.matmul(k, cf).cpu().numpy()
    return out

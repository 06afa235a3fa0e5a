"""Solver diagnostics (port of ``dpsvm_tpu/ops/diagnostics.py``): the
dual objective, the duality gap and the KKT residual, for validation
(train's ``--check-kkt``), never the hot loop:

  dual     D(alpha) = sum(alpha) - 1/2 sum_ij alpha_i alpha_j y_i y_j K_ij
  primal   P(alpha) = 1/2 |w|^2 + sum_i C_i max(0, 1 - y_i (f_w(x_i) - b))
  gap      P - D >= 0, -> 0 at the optimum.

K is never held: ``kv = K . coef`` streams in row blocks
(``_stream_kv``), computed once and shared by every metric
(``optimality_report``). ``api.warm_start`` rebuilds f from alpha with
``_stream_kv``; the shrinking manager rebuilds the inactive rows' f with
``_stream_kv_against`` (``dpsvm_tpu/solver/shrink.py:137-154``). Both are
a ``torch.matmul`` and the kernel's epilogue, as the JAX package computes
them outside any Pallas kernel."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from dpsvm_tpu_torch.device import resolve_device
from dpsvm_tpu_torch.ops.kernels import (KernelSpec, exact_f32, kernel_rows,
                                         row_norms_sq)
from dpsvm_tpu_torch.ops.selection import iup_ilow_masks_np


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


@dataclasses.dataclass
class OptimalityReport:
    dual: float            # Lagrangian L(alpha, b), see optimality_report
    primal: float          # P at (w(alpha), b)
    gap: float             # primal - dual
    kkt_residual: float    # b_lo - b_hi recomputed from fresh f
    eq_residual: float     # sum(alpha * y): the independent clip's drift


def optimality_report(x: np.ndarray, y: np.ndarray, alpha: np.ndarray,
                      gamma, c, b: float = 0.0, block: int = 4096,
                      device=None) -> OptimalityReport:
    """Every post-train optimality metric from one streamed kernel pass on
    ``device`` (None means the GPU).

    ``gamma`` is a float (RBF) or a ``KernelSpec``; ``c`` a scalar or the
    per-example (n,) box (class weights). The primal's hinge is taken at
    f_w(x) - b: pass the solver's intercept for a tight certificate (b = 0
    overstates the gap by up to C sum_i |b|). With the reference's
    independent clip alpha drifts off sum_i alpha_i y_i = 0, and the
    textbook dual is then off by b sum(alpha y); the reported dual is the
    Lagrangian sum(alpha) - 1/2 quad + b sum(alpha y), so the gap goes to
    0 at eps-KKT convergence whatever the drift. ``kkt_residual`` is
    b_lo - b_hi with f = kv - y recomputed from scratch: against the
    solver's incremental gap it bounds the accumulated f drift."""
    x = np.asarray(x, np.float32)
    yf = np.asarray(y, np.float32)
    al = np.asarray(alpha, np.float32)
    c_vec = np.asarray(c, np.float32)
    coef = al * yf
    kv = _stream_kv(x, coef, gamma, block, resolve_device(device))

    quad = float(coef @ kv)
    hinge = float(np.sum(np.broadcast_to(c_vec, yf.shape)
                         * np.maximum(0.0, 1.0 - yf * (kv - b))))
    eq_residual = float(np.sum(coef))
    dual = float(np.sum(al)) - 0.5 * quad + float(b) * eq_residual
    primal = 0.5 * quad + hinge

    f = kv - yf
    in_up, in_low = iup_ilow_masks_np(al, yf, c_vec)
    b_hi = f[in_up].min() if in_up.any() else np.inf
    b_lo = f[in_low].max() if in_low.any() else -np.inf
    return OptimalityReport(dual=dual, primal=primal, gap=primal - dual,
                            kkt_residual=float(b_lo - b_hi),
                            eq_residual=eq_residual)


def dual_objective_and_gap(x: np.ndarray, y: np.ndarray, alpha: np.ndarray,
                           gamma, c, b: float = 0.0, block: int = 4096,
                           device=None) -> Tuple[float, float, float]:
    """(dual objective, primal objective, duality gap); see
    ``optimality_report`` for ``c`` and ``b``."""
    r = optimality_report(x, y, alpha, gamma, c, b, block, device)
    return r.dual, r.primal, r.gap


def kkt_violation(x: np.ndarray, y: np.ndarray, alpha: np.ndarray,
                  gamma, c, device=None) -> float:
    """b_lo - b_hi recomputed from fresh f; see ``optimality_report``."""
    return optimality_report(x, y, alpha, gamma, c,
                             device=device).kkt_residual

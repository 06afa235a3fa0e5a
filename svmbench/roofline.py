"""The yardstick's peaks and operation counts, frozen here so that a later
change to the program cannot move them.

Peaks: NVIDIA's H100 SXM data sheet, dense rates at the full 700 W power
limit (the card's own limit is printed beside every run): 3.35 TB/s of
HBM3 and 67 TFLOP/s of float32 outside the tensor cores. The program's
float32 paths keep TF32 off, so that is the peak their products run at.
"""

from __future__ import annotations

#: HBM3 bytes a second, H100 SXM data sheet
HBM_BYTES_PER_S = 3.35e12
#: float32 FLOP a second outside the tensor cores, H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12


def kernel_a_work(n: int, d: int, el: int) -> dict:
    """One iteration of kernel A (``csrc/fused_step.cu``) on an (n, d) X
    stored in ``el`` bytes an element: X read once, the two selected rows,
    five float32 vectors (alpha, f, y, the norms in, f out) and 32 bytes
    of scalars; two dot products and the f update, 4 n d operations.
    Frozen copy of the bound column of ``chip_smoke.py`` (lines
    7150-7153)."""
    return {"bytes": float(n * d * el + 2 * d * el + 5 * n * 4 + 8 * 4),
            "flops": 4.0 * n * d}


def kernel_a_bound_s(n: int, d: int, el: int) -> float:
    """The least time of one iteration of kernel A: the larger of its bytes
    at the HBM peak and its operations at the float32 peak."""
    w = kernel_a_work(n, d, el)
    return max(w["bytes"] / HBM_BYTES_PER_S, w["flops"] / FP32_FLOPS_PER_S)


def score_bound_s(rows: int, n_sv: int, d: int) -> float:
    """The least time to score ``rows`` rows of width ``d`` against an RBF
    model of ``n_sv`` support vectors in float32: the larger of 2 n_sv d
    operations a row at the float32 peak, and every byte read or written
    once (the rows in, the SV rows, their norms and coefficients, one
    decision a row out) at the HBM peak. Padding rows and the exp epilogue
    are not counted."""
    flops = 2.0 * rows * n_sv * d
    bytes_ = 4.0 * (rows * d + n_sv * d + 2 * n_sv + rows)
    return max(flops / FP32_FLOPS_PER_S, bytes_ / HBM_BYTES_PER_S)

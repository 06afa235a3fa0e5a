"""The plain reference: an RBF kernel SVM's decision values and optimality
conditions in float64, in plain PyTorch.

It imports nothing of the program and takes nothing the program made
except the outputs it judges (the solver's alpha and b, the compacted
model, the served decisions). It works on whatever device it is given, in
blocks of rows, so that it fits beside nothing: the harness runs it after
the window has closed, the peak memory has been read and the program's
state is freed. TF32 plays no part: every product is float64.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

BLOCK = 8192


def _t(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=torch.float64, device=device)


def rbf_sums(x: np.ndarray, sv: np.ndarray, coef: np.ndarray, gamma: float,
             device, block: int = BLOCK) -> Tuple[np.ndarray, np.ndarray]:
    """For every row x_i: (sum_j coef_j K(x_i, sv_j), sum_j |coef_j|
    K(x_i, sv_j)) with K(a, b) = exp(-gamma ||a - b||^2), in float64. The
    second sum is the scale of the first one's terms, against which a
    float32 computation's rounding is measured."""
    s = _t(sv, device)
    s2 = (s * s).sum(1)
    c = torch.stack([_t(coef, device), _t(np.abs(coef), device)], dim=1)
    out = []
    for lo in range(0, x.shape[0], block):
        a = _t(x[lo:lo + block], device)
        d2 = (a * a).sum(1)[:, None] + s2[None, :] - 2.0 * (a @ s.T)
        k = torch.exp(-float(gamma) * d2.clamp_(min=0.0))
        out.append(k @ c)
    both = torch.cat(out).cpu().numpy()
    return both[:, 0], both[:, 1]


def in_up_low(alpha: np.ndarray, y: np.ndarray, c: float):
    """Membership of I_up and I_low: an interior alpha is in both; alpha
    = 0 is in I_up for y = +1 and in I_low for y = -1; alpha = C the other
    way round."""
    pos = np.asarray(y) > 0
    at0 = alpha == 0.0
    atc = alpha == c
    interior = ~at0 & ~atc
    return (interior | (at0 & pos) | (atc & ~pos),
            interior | (at0 & ~pos) | (atc & pos))


def kkt(x: np.ndarray, y: np.ndarray, alpha: np.ndarray, sv: np.ndarray,
        coef: np.ndarray, c: float, gamma: float, device) -> dict:
    """The optimality conditions of a dual point: f_i = sum_j coef_j
    K(x_i, sv_j) - y_i over every training row in float64, b_hi = min f
    over I_up, b_lo = max f over I_low; ``gap`` = b_lo - b_hi (at an
    eps-optimum at most 2 eps) and ``b`` = their midpoint."""
    kv, _ = rbf_sums(x, sv, coef, gamma, device)
    f = kv - np.asarray(y, np.float64)
    up, low = in_up_low(np.asarray(alpha), y, c)
    b_hi = float(f[up].min()) if up.any() else float("inf")
    b_lo = float(f[low].max()) if low.any() else float("-inf")
    return {"gap": b_lo - b_hi, "b": (b_lo + b_hi) / 2.0}

"""The SMO alpha pair step (port of ``dpsvm_tpu/ops/update.py``).

Two clip rules:

* "independent" — the reference's (``svmTrainMain.cpp:289-295``): a_hi'
  computed from the UNCLIPPED a_lo', then both clipped to their boxes
  separately. This is the clip of the ported training path.
* "pairwise" — the textbook/LIBSVM joint box: a_lo' clipped to the
  feasible segment of the equality-constraint line through the pair,
  a_hi' moved along it.

The constants are made on the operands' device by fills, never copied
from the host, so that a captured CUDA graph can hold the step.
"""

from __future__ import annotations

import torch


def alpha_pair_step(a_hi, a_lo, y_hi, y_lo, b_hi, b_lo_sel, eta,
                    c_hi, c_lo, pairwise: bool):
    """Returns (a_hi_new, a_lo_new). Arguments are float32 tensors of one
    shape (or Python floats for the box bounds)."""
    s = y_lo * y_hi
    a_lo_u = a_lo + y_lo * (b_hi - b_lo_sel) / eta
    if pairwise:
        # When the joint clip binds, the partner lands on the LITERAL
        # corner value: the I-set masks test alpha == 0 / == C exactly.
        c_hi = _on_device(c_hi, a_lo)
        c_lo = _on_device(c_lo, a_lo)
        zero = a_lo.new_zeros(())
        pos = s > 0
        ssum = a_lo + a_hi                   # conserved when s > 0
        diff = a_hi - a_lo                   # conserved when s < 0
        lo_b = torch.maximum(zero, torch.where(pos, ssum - c_hi, a_lo - a_hi))
        hi_b = torch.minimum(c_lo, torch.where(pos, ssum, a_lo + c_hi - a_hi))
        a_lo_n = torch.minimum(torch.maximum(a_lo_u, lo_b), hi_b)
        hi_at_lo = torch.where(pos,
                               torch.where(lo_b > 0, c_hi, ssum),
                               torch.where(lo_b > 0, zero, diff))
        hi_at_hi = torch.where(pos,
                               torch.where(hi_b < c_lo, zero, ssum - c_lo),
                               torch.where(hi_b < c_lo, c_hi, diff + c_lo))
        a_hi_n = torch.where(a_lo_u <= lo_b, hi_at_lo,
                             torch.where(a_lo_u >= hi_b, hi_at_hi,
                                         a_hi + s * (a_lo - a_lo_u)))
    else:
        a_hi_u = a_hi + s * (a_lo - a_lo_u)      # uses UNCLIPPED a_lo'
        a_lo_n = _clip(a_lo_u, c_lo)
        a_hi_n = _clip(a_hi_u, c_hi)
    return a_hi_n, a_lo_n


def _on_device(c, like: torch.Tensor) -> torch.Tensor:
    """A box bound as a float32 tensor on ``like``'s device."""
    if isinstance(c, torch.Tensor):
        return c.to(torch.float32)
    return like.new_full((), c, dtype=torch.float32)


def _clip(v: torch.Tensor, hi) -> torch.Tensor:
    """jnp.clip(v, 0, hi), NaN-propagating, for a float or tensor bound."""
    if isinstance(hi, torch.Tensor):
        return torch.minimum(torch.clamp(v, min=0.0), hi)
    return torch.clamp(v, 0.0, hi)

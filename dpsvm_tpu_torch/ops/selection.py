"""Working-set selection: Keerthi index sets + first-order extrema
(port of ``dpsvm_tpu/ops/selection.py``).

Membership follows ``svmTrain.cu:54-91``; non-members get the +/-1e9
sentinels, and the joint (argmin, argmax) keeps the first index on ties,
as ``jnp.argmin`` / ``torch.argmin`` do. Rows with ``valid`` False belong
to neither set.

The decomposition's outer selection (``dpsvm_tpu/solver/decomp.py``) adds
two fixed-shape helpers: ``top_k_first``, ``lax.top_k`` with its tie rule,
and ``unique_padded``, ``jnp.unique(..., size=, fill_value=-1)``. Neither
reads anything back to the host.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from dpsvm_tpu_torch.config import SENTINEL


def iup_ilow_masks(alpha: torch.Tensor, y: torch.Tensor, c
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Membership in I_up / I_low. Exact ==0 / ==C comparisons mirror the
    reference; clipping writes exactly 0.0 or C so they are well posed."""
    at0 = alpha == 0.0
    atc = alpha == c
    interior = ~at0 & ~atc
    pos = y > 0
    in_up = interior | (at0 & pos) | (atc & ~pos)
    in_low = interior | (at0 & ~pos) | (atc & pos)
    return in_up, in_low


def masked_scores_and_masks(alpha: torch.Tensor, y: torch.Tensor,
                            f: torch.Tensor, c,
                            valid: Optional[torch.Tensor] = None):
    """(f_up, f_low, in_up, in_low): sentinel-masked scores plus the
    membership masks."""
    in_up, in_low = iup_ilow_masks(alpha, y, c)
    if valid is not None:
        in_up = in_up & valid
        in_low = in_low & valid
    sent = torch.tensor(SENTINEL, dtype=torch.float32, device=f.device)
    f_up = torch.where(in_up, f, sent)
    f_low = torch.where(in_low, f, -sent)
    return f_up, f_low, in_up, in_low


def masked_scores(alpha: torch.Tensor, y: torch.Tensor, f: torch.Tensor, c,
                  valid: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(f_up, f_low): f with non-members pushed to +/-SENTINEL."""
    return masked_scores_and_masks(alpha, y, f, c, valid)[:2]


def masked_extrema(alpha: torch.Tensor, y: torch.Tensor, f: torch.Tensor,
                   c, valid: Optional[torch.Tensor] = None):
    """(i_hi, b_hi, i_lo, b_lo) as 0-d tensors: the first-order working
    set. A NaN score wins its extremum, as in ``jnp.argmin``."""
    f_up, f_low = masked_scores(alpha, y, f, c, valid)
    i_hi = torch.argmin(f_up)
    i_lo = torch.argmax(f_low)
    return i_hi, f_up[i_hi], i_lo, f_low[i_lo]


def top_k_first(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest scores, largest first and the lower index
    first among equal scores: the order of ``lax.top_k``. A stable sort
    gives that order; ``torch.topk`` promises none among ties, and the
    sentinel-scored rows are often exactly such ties."""
    return torch.sort(scores, descending=True, stable=True).indices[:k]


def unique_padded(idx: torch.Tensor, size: int) -> torch.Tensor:
    """``jnp.unique(idx, size=size, fill_value=-1)`` for non-negative
    indices, at a fixed shape: the distinct values in increasing order,
    then -1 up to ``size``. Duplicates are pushed past every real index
    by a second sort, so the length never depends on the data."""
    s = torch.sort(idx).values
    dup = torch.zeros_like(s, dtype=torch.bool)
    dup[1:] = s[1:] == s[:-1]
    top = torch.iinfo(s.dtype).max
    s = torch.sort(torch.where(dup, top, s)).values
    s = torch.where(s == top, -1, s)
    if s.shape[0] < size:
        s = torch.cat([s, s.new_full((size - s.shape[0],), -1)])
    return s[:size]

"""Working-set selection: Keerthi index sets + first-order extrema
(port of ``dpsvm_tpu/ops/selection.py``).

Membership follows ``svmTrain.cu:54-91``; non-members get the +/-1e9
sentinels, and the joint (argmin, argmax) keeps the first index on ties,
as ``jnp.argmin`` / ``torch.argmin`` do. Rows with ``valid`` False belong
to neither set. ``masked_extrema_packed`` gives the same answer as one
min and one max over 64-bit (value, index) keys.

The decomposition's outer selection (``dpsvm_tpu/solver/decomp.py``) adds
two fixed-shape helpers: ``top_k_first``, ``lax.top_k`` with its tie rule,
and ``unique_padded``, ``jnp.unique(..., size=, fill_value=-1)``. Neither
reads anything back to the host.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from dpsvm_tpu_torch.config import SENTINEL


def box_sides(y: torch.Tensor, c) -> Tuple[torch.Tensor, torch.Tensor]:
    """(up_side, low_side): for each example the one alpha value that
    keeps it out of I_up (C for y > 0, 0 otherwise) and out of I_low (0
    for y > 0, C otherwise). Membership is then one exact comparison,
    ``alpha != side`` (``iup_ilow_masks``). ``c`` is C or the per-example
    (n,) box."""
    if not isinstance(c, torch.Tensor):
        c = torch.full((), c, dtype=torch.float32, device=y.device)
    zero = torch.zeros((), dtype=torch.float32, device=y.device)
    pos = y > 0
    return torch.where(pos, c, zero), torch.where(pos, zero, c)


def iup_ilow_masks(alpha: torch.Tensor, y: torch.Tensor, c
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Membership in I_up / I_low (svmTrain.cu:54-91): an interior alpha is
    in both, alpha == 0 in I_up for y > 0 and in I_low otherwise, alpha ==
    C the other way round. With C > 0 that is ``alpha != C`` / ``alpha !=
    0`` for y > 0 and the reverse for y <= 0, every alpha (NaN is in
    both). The exact comparisons mirror the reference; clipping writes
    exactly 0.0 or C so they are well posed."""
    up_side, low_side = box_sides(y, c)
    return alpha != up_side, alpha != low_side


def iup_ilow_masks_np(alpha, y, c):
    """NumPy twin of ``iup_ilow_masks`` for the host: the shrinking
    manager's shrink rule and its full-problem check at unshrink. ``c``
    is C or the per-example (n,) box."""
    import numpy as np

    at0 = alpha == 0.0
    atc = alpha == c
    interior = ~at0 & ~atc
    pos = np.asarray(y) > 0
    in_up = interior | (at0 & pos) | (atc & ~pos)
    in_low = interior | (at0 & ~pos) | (atc & pos)
    return in_up, in_low


def valid_rows(n: int, n_valid, device) -> torch.Tensor:
    """The (n,) mask of rows below ``n_valid`` (an int or a 0-d device
    tensor, which a captured graph reads at each replay): the shrinking
    manager's padded capacities keep their padding rows out of every
    index set with it."""
    return torch.arange(n, dtype=torch.int32, device=device) < n_valid


def sided_scores(alpha: torch.Tensor, f: torch.Tensor,
                 up_side: torch.Tensor, low_side: torch.Tensor,
                 valid: Optional[torch.Tensor] = None):
    """(f_up, f_low, in_low) from ``box_sides``, made once for a loop
    whose y and C never change: four elementwise operations, two more
    with a ``valid`` mask (rows where it is False are in neither set)."""
    in_low = alpha != low_side
    in_up = alpha != up_side
    if valid is not None:
        in_up = in_up & valid
        in_low = in_low & valid
    f_up = torch.where(in_up, f, SENTINEL)
    return f_up, torch.where(in_low, f, -SENTINEL), in_low


def masked_scores_and_masks(alpha: torch.Tensor, y: torch.Tensor,
                            f: torch.Tensor, c,
                            valid: Optional[torch.Tensor] = None):
    """(f_up, f_low, in_up, in_low): sentinel-masked scores plus the
    membership masks."""
    in_up, in_low = iup_ilow_masks(alpha, y, c)
    if valid is not None:
        in_up = in_up & valid
        in_low = in_low & valid
    f_up = torch.where(in_up, f, SENTINEL)
    f_low = torch.where(in_low, f, -SENTINEL)
    return f_up, f_low, in_up, in_low


def masked_scores(alpha: torch.Tensor, y: torch.Tensor, f: torch.Tensor, c,
                  valid: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(f_up, f_low): f with non-members pushed to +/-SENTINEL."""
    return masked_scores_and_masks(alpha, y, f, c, valid)[:2]


def pick(v: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """v[i] for a 0-d index tensor, as a 0-d tensor, by ``index_select``:
    nothing is read back to the host, so a captured CUDA graph can hold
    it."""
    return v.index_select(0, i.reshape(1)).reshape(())


def extrema_of(f_up: torch.Tensor, f_low: torch.Tensor):
    """(i_hi, b_hi, i_lo, b_lo) of masked scores, first index on ties."""
    i_hi = torch.argmin(f_up)
    i_lo = torch.argmax(f_low)
    return i_hi, pick(f_up, i_hi), i_lo, pick(f_low, i_lo)


def masked_extrema(alpha: torch.Tensor, y: torch.Tensor, f: torch.Tensor,
                   c, valid: Optional[torch.Tensor] = None):
    """(i_hi, b_hi, i_lo, b_lo) as 0-d tensors: the first-order working
    set. A NaN score wins its extremum, as in ``jnp.argmin``."""
    return extrema_of(*masked_scores(alpha, y, f, c, valid))


def _ordered_bits(v: torch.Tensor) -> torch.Tensor:
    """float32 -> int64 whose integer order is the floats' order: the bit
    pattern, with the magnitude bits of negative values flipped. -0.0 is
    made +0.0 first, since the two compare equal."""
    b = (v + 0.0).view(torch.int32).to(torch.int64)
    return torch.where(b < 0, b ^ 0x7FFFFFFF, b)


def masked_extrema_packed(alpha: torch.Tensor, y: torch.Tensor,
                          f: torch.Tensor, c,
                          valid: Optional[torch.Tensor] = None):
    """``masked_extrema`` as one min and one max over packed keys (the
    JAX package's 4-operand ``lax.reduce``, the reference's ``my_maxmin``
    reduce): the ordered value bits in the high 32 bits and the index (for
    the max, its complement) in the low 32, so the smallest key is the
    smallest score at its first index, and the largest key the largest
    score at its first index. On finite scores (the sentinels included)
    the answer equals ``masked_extrema``'s bit for bit.

    NaN differs: ``argmin``/``argmax`` let a NaN win, the JAX package's
    packed comparator never lets one win (every comparison with NaN is
    false), and here a NaN is given the key that loses, so it wins only
    when every score is NaN (then index 0, where JAX's reduce keeps its
    int32-max initial index). The host training loop stops a run whose
    b's are not finite either way."""
    return packed_extrema_of(*masked_scores(alpha, y, f, c, valid))


def packed_extrema_of(f_up: torch.Tensor, f_low: torch.Tensor):
    """``extrema_of`` through packed keys (see ``masked_extrema_packed``)."""
    idx = torch.arange(f_up.shape[0], dtype=torch.int64, device=f_up.device)
    worst = torch.iinfo(torch.int64)
    up = torch.where(torch.isnan(f_up), worst.max,
                     (_ordered_bits(f_up) << 32) | idx)
    low = torch.where(torch.isnan(f_low), worst.min,
                      (_ordered_bits(f_low) << 32) | (0xFFFFFFFF - idx))
    i_hi = torch.min(up) & 0xFFFFFFFF
    i_lo = 0xFFFFFFFF - (torch.max(low) & 0xFFFFFFFF)
    return i_hi, pick(f_up, i_hi), i_lo, pick(f_low, i_lo)


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

"""Fixed-shape device kernel-row cache (port of ``dpsvm_tpu/ops/rowcache.py``).

The reference keeps ``max_size`` device vectors of kernel-row dot products,
a key map and an LRU list (``cache.cu:49-105``). Here, as in the JAX
package, the cache is fixed-shape device tensors carried by the solver:

* ``rows``   (lines, n)  cached dot-product rows (the RBF epilogue is always
                         re-applied, as the reference's ``update_functor``),
* ``keys``   (lines,)    the working-set index each line holds (-1 empty),
* ``stamps`` (lines,)    last-use tick for LRU eviction,

plus the 0-d ``tick`` and the lifetime ``hits`` / ``misses`` counters, which
ride the poll's packed stats (one pair fetch is two lookups, so ``hits +
misses == 2 * fetches``).

The line choice is the JAX package's, step for step: a hit takes the first
line holding the key, a miss evicts the first line of the smallest stamp;
b's hit line is masked out of a's eviction scan (and a's line out of b's);
``key_a == key_b`` shares one line; a mixed hit and miss recomputes both
rows in one ``(2, d) @ (d, n)`` product, and only a double hit skips it.
Every "first index of the smallest" here is a min over 64-bit (value,
index) keys, so the answer does not depend on a reduction's order.

``cache_fetch_pair`` is the functional form (the eager loop's; a double
hit skips ``compute_both`` after one host read of the hit flags, as
``lax.cond`` skips it). Inside a captured CUDA graph nothing may be read
back to the host, so the general pair's graph body uses the pieces:
``pair_plan`` for the lines, ``cached_pair`` for the rows they hold, and
``commit_pair_`` to write the fetch in place, gated on the body's
condition; there the product runs every body and a double hit selects the
cached rows (``solver/smo.py``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

_INT32_MAX = 2**31 - 1


class RowCache(NamedTuple):
    keys: torch.Tensor      # (lines,) int32, -1 = empty
    stamps: torch.Tensor    # (lines,) int32 last-use tick
    rows: torch.Tensor      # (lines, n) float32 dot products
    tick: torch.Tensor      # () int32
    hits: torch.Tensor      # () int32
    misses: torch.Tensor    # () int32

    def clone(self) -> "RowCache":
        return RowCache(*(t.clone() for t in self))


def cache_init(lines: int, n: int, dtype=None, device=None) -> RowCache:
    """An empty cache of ``lines`` rows of length n, on ``device``."""
    i32 = dict(dtype=torch.int32, device=device)
    return RowCache(
        keys=torch.full((lines,), -1, **i32),
        stamps=torch.zeros((lines,), **i32),
        rows=torch.zeros((lines, n), dtype=dtype or torch.float32,
                         device=device),
        tick=torch.zeros((), **i32),
        hits=torch.zeros((), **i32),
        misses=torch.zeros((), **i32))


def first_min(v: torch.Tensor) -> torch.Tensor:
    """The first index of the smallest value of a 1-D int32 tensor, as a
    0-d int64 tensor: one min over (value, index) keys."""
    idx = torch.arange(v.shape[0], dtype=torch.int64, device=v.device)
    return (torch.min((v.to(torch.int64) << 32) | idx) & 0xFFFFFFFF)


def first_true(mask: torch.Tensor) -> torch.Tensor:
    """The first index where ``mask`` holds (0 when it holds nowhere):
    ``jnp.argmax`` of a bool vector."""
    return first_min((~mask).to(torch.int32))


def _masked_at(v: torch.Tensor, i: torch.Tensor, on: torch.Tensor):
    """v with v[i] set to int32 max where ``on``, else v (a new tensor)."""
    out = v.clone()
    cur = out.index_select(0, i.reshape(1))
    out.index_copy_(0, i.reshape(1),
                    torch.where(on, torch.full_like(cur, _INT32_MAX), cur))
    return out


class PairPlan(NamedTuple):
    line_a: torch.Tensor    # () int64
    line_b: torch.Tensor
    hit_a: torch.Tensor     # () bool
    hit_b: torch.Tensor     # () bool (key_b == key_a counts as a hit)


def pair_plan(cache: RowCache, key_a: torch.Tensor,
              key_b: torch.Tensor) -> PairPlan:
    """The two lines a pair fetch reads or fills, and whether each key
    hit; nothing is read back to the host."""
    same = key_b == key_a
    hm_a = cache.keys == key_a
    hm_b = cache.keys == key_b
    hit_a = hm_a.any()
    any_b = hm_b.any()
    line_b_hit = first_true(hm_b)
    # a's eviction scan must not victimise b's hit line
    stamps_a = _masked_at(cache.stamps, line_b_hit, any_b & ~same)
    line_a = torch.where(hit_a, first_true(hm_a), first_min(stamps_a))
    stamps_b = _masked_at(cache.stamps, line_a, torch.ones_like(hit_a))
    line_b = torch.where(same, line_a,
                         torch.where(any_b, line_b_hit,
                                     first_min(stamps_b)))
    return PairPlan(line_a, line_b, hit_a, any_b | same)


def cached_pair(cache: RowCache, plan: PairPlan) -> torch.Tensor:
    """The (2, n) rows the plan's lines hold now."""
    return cache.rows.index_select(0, torch.stack([plan.line_a,
                                                   plan.line_b]))


def commit_pair_(cache: RowCache, key_a: torch.Tensor, key_b: torch.Tensor,
                 plan: PairPlan, rows: torch.Tensor,
                 go: Optional[torch.Tensor] = None) -> None:
    """Write the fetch into the cache in place: keys and stamps of both
    lines (a's first, then b's: the shared line of ``key_a == key_b``
    ends with b's row, the same values), the tick and the counters. With
    ``go`` (a 0-d bool tensor) False every write puts back what it read,
    so the cache is unchanged bit for bit."""
    tick = cache.tick + 1
    nh = plan.hit_a.to(torch.int32) + plan.hit_b.to(torch.int32)
    for line, key, row in ((plan.line_a, key_a, rows[0]),
                           (plan.line_b, key_b, rows[1])):
        li = line.reshape(1)
        for dst, new in ((cache.keys, key.to(torch.int32).reshape(1)),
                         (cache.stamps, tick.reshape(1)),
                         (cache.rows, row.reshape(1, -1))):
            if go is not None:
                new = torch.where(go, new, dst.index_select(0, li))
            dst.index_copy_(0, li, new)
    if go is None:
        cache.tick.copy_(tick)
        cache.hits.add_(nh)
        cache.misses.add_(2 - nh)
    else:
        g = go.to(torch.int32)
        cache.tick.add_(g)
        cache.hits.add_(nh * g)
        cache.misses.add_((2 - nh) * g)


def cache_fetch_pair(cache: RowCache, key_a: torch.Tensor,
                     key_b: torch.Tensor,
                     compute_both: Callable[[], torch.Tensor]
                     ) -> Tuple[torch.Tensor, RowCache]:
    """The dot-product rows (2, n) of both working-set keys and the
    updated cache (a new one; the given cache is not changed).
    ``compute_both`` runs unless both keys hit."""
    key_a = torch.as_tensor(key_a, device=cache.keys.device)
    key_b = torch.as_tensor(key_b, device=cache.keys.device)
    plan = pair_plan(cache, key_a, key_b)
    if bool(plan.hit_a & plan.hit_b):
        rows = cached_pair(cache, plan)
    else:
        rows = compute_both()
    new = cache.clone()
    commit_pair_(new, key_a, key_b, plan, rows)
    return rows, new


def cache_fetch(cache: RowCache, key: torch.Tensor,
                compute: Callable[[], torch.Tensor]
                ) -> Tuple[torch.Tensor, RowCache]:
    """The dot-product row (n,) of one key and the updated cache (a new
    one): ``SvmTrain::lookup_cache``, a hit or an LRU line refilled by
    ``compute``."""
    key = torch.as_tensor(key, device=cache.keys.device)
    hit_mask = cache.keys == key
    hit = hit_mask.any()
    line = torch.where(hit, first_true(hit_mask), first_min(cache.stamps))
    if bool(hit):
        row = cache.rows.index_select(0, line.reshape(1))[0]
    else:
        row = compute()
    new = cache.clone()
    tick = new.tick + 1
    li = line.reshape(1)
    new.keys.index_copy_(0, li, key.to(torch.int32).reshape(1))
    new.stamps.index_copy_(0, li, tick.reshape(1))
    new.rows.index_copy_(0, li, row.reshape(1, -1))
    new.tick.copy_(tick)
    h = hit.to(torch.int32)
    new.hits.add_(h)
    new.misses.add_(1 - h)
    return row, new

"""Selection and update primitives of the PyTorch port against the JAX
package's, on the same float32 inputs made with numpy.

Tolerance: none. The primitives are elementwise float32 arithmetic and
comparisons in the same order, and an argmin/argmax with the same
first-index rule, so the results must be equal bit for bit. The inputs
carry ties, alpha exactly at 0 and at C, and invalid (y == 0) rows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpsvm_tpu.ops import selection as jsel
from dpsvm_tpu.ops import update as jupd
from dpsvm_tpu_torch.ops import selection as tsel
from dpsvm_tpu_torch.ops import update as tupd

C = 1.5


def _state(seed: int, n: int = 257):
    """alpha at 0 / C / inside, y in {-1, +1} with some 0 (invalid), and f
    drawn from a few values so that ties are everywhere."""
    rng = np.random.default_rng(seed)
    alpha = rng.choice([0.0, C, -1.0], size=n)
    inner = alpha < 0
    alpha[inner] = rng.uniform(0.01, C - 0.01, inner.sum())
    y = rng.choice([-1.0, 1.0], size=n)
    y[rng.random(n) < 0.05] = 0.0
    f = rng.choice(np.round(rng.normal(size=7), 2), size=n)
    return (alpha.astype(np.float32), y.astype(np.float32),
            f.astype(np.float32))


@pytest.mark.parametrize("seed", range(4))
def test_masks_equal_jax(seed):
    alpha, y, f = _state(seed)
    up_j, low_j = jsel.iup_ilow_masks(jnp.asarray(alpha), jnp.asarray(y), C)
    up_t, low_t = tsel.iup_ilow_masks(torch.from_numpy(alpha),
                                      torch.from_numpy(y), C)
    np.testing.assert_array_equal(np.asarray(up_j), up_t.numpy())
    np.testing.assert_array_equal(np.asarray(low_j), low_t.numpy())


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("with_valid", [False, True])
def test_masked_scores_equal_jax(seed, with_valid):
    alpha, y, f = _state(seed)
    valid_j = jnp.asarray(y) != 0 if with_valid else None
    valid_t = torch.from_numpy(y) != 0 if with_valid else None
    out_j = jsel.masked_scores_and_masks(jnp.asarray(alpha), jnp.asarray(y),
                                         jnp.asarray(f), C, valid=valid_j)
    out_t = tsel.masked_scores_and_masks(torch.from_numpy(alpha),
                                         torch.from_numpy(y),
                                         torch.from_numpy(f), C,
                                         valid=valid_t)
    for a, b in zip(out_j, out_t):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    fu_j, fl_j = jsel.masked_scores(jnp.asarray(alpha), jnp.asarray(y),
                                    jnp.asarray(f), C, valid=valid_j)
    fu_t, fl_t = tsel.masked_scores(torch.from_numpy(alpha),
                                    torch.from_numpy(y),
                                    torch.from_numpy(f), C, valid=valid_t)
    np.testing.assert_array_equal(np.asarray(fu_j), fu_t.numpy())
    np.testing.assert_array_equal(np.asarray(fl_j), fl_t.numpy())


@pytest.mark.parametrize("seed", range(6))
def test_masked_extrema_equal_jax(seed):
    alpha, y, f = _state(seed)
    valid = y != 0
    got_j = jsel.masked_extrema(jnp.asarray(alpha), jnp.asarray(y),
                                jnp.asarray(f), C,
                                valid=jnp.asarray(valid))
    got_t = tsel.masked_extrema(torch.from_numpy(alpha), torch.from_numpy(y),
                                torch.from_numpy(f), C,
                                valid=torch.from_numpy(valid))
    assert [float(v) for v in got_j] == [float(v) for v in got_t]
    # ties are real: the chosen index is the FIRST holder of its value
    i_hi = int(got_t[0])
    f_up = np.where(tsel.masked_scores(
        torch.from_numpy(alpha), torch.from_numpy(y), torch.from_numpy(f), C,
        valid=torch.from_numpy(valid))[0].numpy() == f[i_hi], 1, 0)
    assert i_hi == int(np.argmax(f_up))


def test_masked_extrema_nan_wins_like_jax():
    alpha, y, f = _state(9)
    f[40] = np.nan
    got_j = jsel.masked_extrema(jnp.asarray(alpha), jnp.asarray(y),
                                jnp.asarray(f), C)
    got_t = tsel.masked_extrema(torch.from_numpy(alpha), torch.from_numpy(y),
                                torch.from_numpy(f), C)
    assert int(got_j[0]) == int(got_t[0]) and int(got_j[2]) == int(got_t[2])
    assert np.isnan(float(got_t[1])) or np.isnan(float(got_t[3]))


def _pairs(seed: int, n: int = 2000):
    rng = np.random.default_rng(seed)
    a_hi = rng.choice([0.0, C, -1.0], size=n)
    a_lo = rng.choice([0.0, C, -1.0], size=n)
    for a in (a_hi, a_lo):
        a[a < 0] = rng.uniform(0.0, C, (a < 0).sum())
    y_hi = rng.choice([-1.0, 1.0], size=n)
    y_lo = rng.choice([-1.0, 1.0], size=n)
    b_hi = rng.normal(size=n)
    b_lo = b_hi + rng.exponential(size=n)
    eta = rng.uniform(1e-3, 2.0, size=n)
    return [v.astype(np.float32) for v in
            (a_hi, a_lo, y_hi, y_lo, b_hi, b_lo, eta)]


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("pairwise", [False, True])
def test_alpha_pair_step_equal_jax(seed, pairwise):
    args = _pairs(seed)
    hi_j, lo_j = jupd.alpha_pair_step(*[jnp.asarray(v) for v in args],
                                      C, C, pairwise)
    hi_t, lo_t = tupd.alpha_pair_step(*[torch.from_numpy(v) for v in args],
                                      C, C, pairwise)
    np.testing.assert_array_equal(np.asarray(hi_j), hi_t.numpy())
    np.testing.assert_array_equal(np.asarray(lo_j), lo_t.numpy())
    # the clip lands exactly on the box where it binds
    assert np.any(hi_t.numpy() == 0.0) and np.any(lo_t.numpy() == np.float32(C))


def test_alpha_pair_step_per_example_bounds_equal_jax():
    args = _pairs(7)
    rng = np.random.default_rng(7)
    c_hi = rng.choice([1.0, 2.5], size=args[0].shape).astype(np.float32)
    c_lo = rng.choice([1.0, 2.5], size=args[0].shape).astype(np.float32)
    hi_j, lo_j = jupd.alpha_pair_step(*[jnp.asarray(v) for v in args],
                                      jnp.asarray(c_hi), jnp.asarray(c_lo),
                                      False)
    hi_t, lo_t = tupd.alpha_pair_step(*[torch.from_numpy(v) for v in args],
                                      torch.from_numpy(c_hi),
                                      torch.from_numpy(c_lo), False)
    np.testing.assert_array_equal(np.asarray(hi_j), hi_t.numpy())
    np.testing.assert_array_equal(np.asarray(lo_j), lo_t.numpy())

"""The port's kernel-row cache (``ops/rowcache.py``) and the general pair
that carries it (``solver/smo.py``, ``cache_size > 0``), on the CPU,
against the JAX package.

Bars, and why:

* the cache on its own: after the same key sequence the port's ``keys``,
  ``stamps``, ``rows``, ``tick``, ``hits`` and ``misses`` equal the JAX
  cache's exactly (the line choice is integer logic; the rows are the
  values given to both), and a double hit never runs the compute (a
  poisoned compute would leave NaN);
* a training run: the cached run is bitwise the uncached one (alpha, f's
  b's, n_iter): a cached row is the output of the same product. Its
  hits + misses are two a fetch;
* against the JAX ``train`` with the same ``cache_size``: the same
  n_iter, hits and misses (read from the JAX run trace's summary), and
  alpha within 1e-5, on problems where both runs select the same pairs.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpsvm_tpu.api import train as jtrain
from dpsvm_tpu.config import SVMConfig as JConfig
from dpsvm_tpu.data.synthetic import make_blobs, make_planted
from dpsvm_tpu.ops import rowcache as jrc
from dpsvm_tpu_torch import SVMConfig, fit, train
from dpsvm_tpu_torch.ops import rowcache as trc
from dpsvm_tpu_torch.solver import smo as tsmo

CPU = torch.device("cpu")


class Both:
    """One key sequence applied to the JAX cache and the port's."""

    def __init__(self, lines, x):
        self.x = np.asarray(x, np.float32)
        self.j = jrc.cache_init(lines, self.x.shape[0])
        self.t = trc.cache_init(lines, self.x.shape[0])

    def pair(self, a, b, poison=False):
        x = self.x

        def rows():
            return np.stack([x @ x[a], x @ x[b]]).astype(np.float32)

        if poison:
            jr, self.j = jrc.cache_fetch_pair(
                self.j, jnp.int32(a), jnp.int32(b),
                lambda: jnp.full((2, x.shape[0]), jnp.nan))
            tr, self.t = trc.cache_fetch_pair(
                self.t, torch.tensor(a), torch.tensor(b),
                lambda: torch.full((2, x.shape[0]), float("nan")))
        else:
            jr, self.j = jrc.cache_fetch_pair(
                self.j, jnp.int32(a), jnp.int32(b),
                lambda: jnp.asarray(rows()))
            tr, self.t = trc.cache_fetch_pair(
                self.t, torch.tensor(a), torch.tensor(b),
                lambda: torch.from_numpy(rows()))
        np.testing.assert_array_equal(np.asarray(jr), tr.numpy())
        self.check()
        return tr.numpy()

    def one(self, key):
        x = self.x
        jr, self.j = jrc.cache_fetch(self.j, jnp.int32(key),
                                     lambda: jnp.asarray(x @ x[key]))
        tr, self.t = trc.cache_fetch(self.t, torch.tensor(key),
                                     lambda: torch.from_numpy(x @ x[key]))
        np.testing.assert_array_equal(np.asarray(jr), tr.numpy())
        self.check()

    def check(self):
        for name in trc.RowCache._fields:
            np.testing.assert_array_equal(
                np.asarray(getattr(self.j, name)),
                getattr(self.t, name).numpy(), err_msg=name)

    @property
    def keys(self):
        return set(self.t.keys.numpy().tolist())


def test_pair_fetch_basic_and_hit():
    rng = np.random.default_rng(0)
    c = Both(4, rng.normal(size=(10, 4)))
    rows1 = c.pair(2, 5)
    np.testing.assert_allclose(rows1[0], c.x @ c.x[2], rtol=1e-6)
    assert c.keys - {-1} == {2, 5}
    rows2 = c.pair(2, 5, poison=True)      # a double hit runs no compute
    assert not np.isnan(rows2).any()
    np.testing.assert_array_equal(rows2, rows1)


def test_same_key_shares_line():
    c = Both(4, np.eye(6))
    c.pair(3, 3)
    assert (c.t.keys.numpy() == 3).sum() == 1
    assert (int(c.t.hits), int(c.t.misses)) == (1, 1)


def test_lru_eviction_prefers_oldest():
    c = Both(4, np.eye(8))
    c.pair(0, 1)
    c.pair(2, 3)
    c.pair(0, 1)                     # 2 and 3 become the oldest
    c.pair(4, 5)
    assert c.keys == {0, 1, 4, 5}


def test_miss_a_must_not_evict_bs_hit_line():
    c = Both(2, np.eye(8))
    c.pair(0, 1)
    rows = c.pair(5, 0)
    assert c.keys == {0, 5}
    np.testing.assert_allclose(rows[0], c.x @ c.x[5])
    assert not np.isnan(c.pair(5, 0, poison=True)).any()


def test_mixed_hit_miss_recomputes_both_correctly():
    rng = np.random.default_rng(1)
    c = Both(3, rng.normal(size=(12, 5)))
    c.pair(1, 2)
    rows = c.pair(1, 7)
    np.testing.assert_allclose(rows[1], c.x @ c.x[7], rtol=1e-6)
    assert 7 in c.keys


@pytest.mark.parametrize("seed", range(4))
def test_random_key_sequences_match_jax(seed):
    """Random pairs and single fetches over few keys and fewer lines: every
    hit, eviction and tie of the stamps (both lines of a fetch share its
    tick) lands on the JAX package's line."""
    rng = np.random.default_rng(seed)
    lines = int(rng.integers(2, 6))
    c = Both(lines, rng.normal(size=(9, 3)))
    for _ in range(40):
        if rng.random() < 0.2:
            c.one(int(rng.integers(0, 9)))
        else:
            c.pair(*(int(v) for v in rng.integers(0, 9, size=2)))
    assert int(c.t.hits) + int(c.t.misses) > 0


def test_first_min_and_first_true():
    v = torch.tensor([3, 1, 2, 1, 1], dtype=torch.int32)
    assert int(trc.first_min(v)) == 1
    assert int(trc.first_true(v == 1)) == 1
    assert int(trc.first_true(v == 9)) == 0        # jnp.argmax of all-False


PAIR_CASES = {
    "first-order": {},
    "packed": dict(select_impl="packed"),
    "pairwise": dict(clip="pairwise"),
    "weighted": dict(weight_pos=2.0, weight_neg=0.5),
    "bf16": dict(matmul_precision="default"),
    "poly": dict(kernel="poly", gamma=0.05, coef0=1.0),
    "sigmoid": dict(kernel="sigmoid", gamma=0.01, coef0=-1.0),
    "linear": dict(kernel="linear"),
}


@pytest.mark.parametrize("case", PAIR_CASES)
def test_cached_run_is_bitwise_the_uncached_run(case):
    x, y = make_planted(300, 16, 0.25, seed=2)
    kw = dict(c=10.0, gamma=0.25, epsilon=1e-3, chunk_iters=64)
    kw.update(PAIR_CASES[case])
    off = tsmo.train_single_device(x, y, SVMConfig(**kw), CPU)
    on = tsmo.train_single_device(x, y, SVMConfig(cache_size=10, **kw),
                                  CPU)
    assert on.converged and on.n_iter == off.n_iter
    np.testing.assert_array_equal(on.alpha, off.alpha)
    assert (on.b_lo, on.b_hi) == (off.b_lo, off.b_hi)
    assert on.cache_hits + on.cache_misses == 2 * on.n_iter
    assert on.cache_hits > 0 and (off.cache_hits, off.cache_misses) == (0, 0)


def test_cache_routes_to_the_general_pair_and_fit_carries_counts():
    from dpsvm_tpu_torch.experimental import fused_step
    x, y = make_blobs(n=96, d=6, seed=3)
    before = dict(fused_step.LAUNCHES)
    tsmo.reset_counts()
    model, res = fit(x, y, SVMConfig(cache_size=8), device="cpu")
    assert tsmo.COUNTS["reads"] > 0 and fused_step.LAUNCHES == before
    assert res.converged and res.cache_hits + res.cache_misses == (
        2 * res.n_iter)
    plain = train(x, y, SVMConfig(), device="cpu")    # the fused pair
    assert model.n_sv == plain.n_sv


def _jax_counts(x, y, tmp_path, **kw):
    path = os.path.join(tmp_path, "trace.jsonl")
    res = jtrain(x, y, JConfig(trace_out=path, **kw))
    with open(path) as f:
        summ = [json.loads(ln) for ln in f if '"summary"' in ln][-1]
    return res, summ["cache_hits"], summ["cache_misses"]


@pytest.mark.parametrize("data,kw", [
    ("blobs", dict(cache_size=8, clip="pairwise")),
    ("blobs", dict(cache_size=16)),
    ("planted", dict(cache_size=8, clip="pairwise")),
    ("planted", dict(cache_size=4, clip="pairwise", weight_pos=2.0)),
    ("planted", dict(cache_size=16)),
    ("planted", dict(cache_size=6, kernel="poly", gamma=0.1, coef0=1.0,
                     clip="pairwise")),
])
def test_hits_and_misses_match_jax_train(tmp_path, data, kw):
    x, y = (make_blobs(n=96, d=6, seed=3) if data == "blobs"
            else make_planted(200, 16, 0.25, seed=2))
    kw = dict(dict(c=1.0, gamma=0.25, epsilon=1e-3, chunk_iters=64), **kw)
    rj, hits, misses = _jax_counts(x, y, str(tmp_path), **kw)
    rt = train(x, y, SVMConfig(**kw), device="cpu")
    assert rt.n_iter == rj.n_iter
    assert (rt.cache_hits, rt.cache_misses) == (hits, misses)
    np.testing.assert_allclose(rt.alpha, np.asarray(rj.alpha), atol=1e-5)


def test_cache_rejections_match_jax():
    """The guard rows that keep the cache on the first-order branch of the
    general pair, message for message."""
    for kw in (dict(cache_size=4, selection="second-order"),
               dict(cache_size=4, kernel="precomputed"),
               dict(cache_size=4, shrinking=True),
               dict(cache_size=4, working_set=8),
               dict(cache_size=-1)):
        msgs = []
        for cls in (JConfig, SVMConfig):
            with pytest.raises(ValueError) as e:
                cls(**kw).validate()
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1], msgs
    cfg = SVMConfig(cache_size=4)
    assert cfg.smo_incompatibility() is None
    assert "cache" in cfg.fused_incompatibility()


def test_cached_fit_runs_on_the_card_by_default():
    x, y = make_blobs(n=40, d=3, seed=0)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fit(x, y, SVMConfig(cache_size=4))

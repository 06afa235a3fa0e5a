"""The port's checkpoints and resume (``utils/checkpoint.py``,
``solver/driver.py``, and resume on the three solver paths) on the CPU,
against the JAX package.

Bars, and why:

* files cross both ways: a checkpoint either package writes loads in the
  other with every field equal, and the fixtures of the older formats load
  as the JAX package loads them;
* a port run killed at K and resumed lands bitwise on the port's straight
  run (alpha, f's b's, n_iter): the saved state is the whole solver state
  and the CPU paths are deterministic;
* resumed across packages: the JAX package's general pair and the port's
  paths walk the same trajectory on the planted problem for a few hundred
  iterations (tests/test_torch_smo.py, tests/test_torch_train.py), so a
  2K-iteration run resumed at K in the other package matches the other's
  straight run within rtol 1e-4 / atol 1e-5 on alpha with the same n_iter;
  converged, the models are held to the LibSVM bar (n_sv within 2% or 3,
  accuracy within one example);
* the loop's schedule with checkpoints on is held to the JAX loop's own
  (``host_training_loop`` of both packages driven by the same fake
  runners), call for call.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dpsvm_tpu.api import train as jtrain
from dpsvm_tpu.config import SVMConfig as JConfig
from dpsvm_tpu.data.synthetic import make_blobs, make_planted, save_csv
from dpsvm_tpu.solver import decomp as jdecomp
from dpsvm_tpu.solver import driver as jdriver
from dpsvm_tpu.utils import checkpoint as jckpt
from dpsvm_tpu_torch import SVMConfig, evaluate, train, warm_start
from dpsvm_tpu_torch.experimental import fused as tfused
from dpsvm_tpu_torch.models.svm import SVMModel
from dpsvm_tpu_torch.solver import driver as tdriver
from dpsvm_tpu_torch.solver import smo as tsmo
from dpsvm_tpu_torch.utils import checkpoint as tckpt
from torch_threads import one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "fixtures"
CPU = torch.device("cpu")

# The three paths, by the config that routes to each (api.train).
PATHS = {
    "fused": dict(),
    "pair": dict(selection="second-order"),
    "decomp": dict(working_set=32, inner_iters=16),
}
BASE = dict(c=10.0, gamma=0.5, epsilon=1e-3, chunk_iters=40)


@pytest.fixture(scope="module")
def problem():
    return make_planted(400, 20, 0.5, seed=1)


def _cfg(cls=SVMConfig, path="fused", **kw):
    return cls(**{**BASE, **PATHS[path], **kw})


def _same(a, b):
    return (np.array_equal(a.alpha, b.alpha) and a.n_iter == b.n_iter
            and (a.b_lo, a.b_hi) == (b.b_lo, b.b_hi)
            and a.converged == b.converged)


# ------------------------------------------------------------- the format

def _fields(ck):
    return {k: (np.asarray(v).tolist() if isinstance(v, np.ndarray) else v)
            for k, v in dataclasses.asdict(ck).items()}


@pytest.mark.parametrize("name", ["ckpt_pre_elastic.npz", "ckpt_v2.npz"])
def test_fixtures_load_as_in_jax(name):
    path = str(FIXTURES / name)
    got, want = tckpt.load_checkpoint(path), jckpt.load_checkpoint(path)
    assert _fields(got) == _fields(want)
    assert got.host_count == 1 and got.host_id == 0


def test_files_cross_both_ways(tmp_path):
    rng = np.random.default_rng(0)
    fields = dict(alpha=rng.random(16).astype(np.float32),
                  f=rng.standard_normal(16).astype(np.float32),
                  n_iter=123, b_lo=0.5, b_hi=-0.5, c=1.0, gamma=0.25,
                  epsilon=1e-3, n=16, d=4, kernel="poly", coef0=1.0,
                  degree=2, weight_pos=2.0)
    for writer, reader in ((tckpt, jckpt), (jckpt, tckpt)):
        path = str(tmp_path / f"{writer.__name__}.npz")
        writer.save_checkpoint(path, writer.SolverCheckpoint(**fields))
        got = reader.load_checkpoint(path)
        assert _fields(got) == _fields(writer.load_checkpoint(path))
        assert got.verify_shard_crcs() == []
    # a 4-shard JAX file loads as the global state
    path = str(tmp_path / "mesh4.npz")
    jckpt.save_checkpoint(path, jckpt.SolverCheckpoint(**fields, shards=4))
    got = tckpt.load_checkpoint(path)
    assert got.shards == 4 and got.verify_shard_crcs() == []


def test_rotation_keeps_n_slots(tmp_path):
    path = str(tmp_path / "state.npz")
    ck = tckpt.SolverCheckpoint(alpha=np.zeros(4, np.float32),
                                f=np.zeros(4, np.float32), n_iter=0,
                                b_lo=1.0, b_hi=0.0, c=1.0, gamma=1.0,
                                epsilon=1e-3, n=4, d=2)
    for it in range(5):
        tckpt.save_checkpoint(path, dataclasses.replace(ck, n_iter=it),
                              keep=3)
    assert tckpt.checkpoint_candidates(path) == [
        path, tckpt.rotation_path(path, 1), tckpt.rotation_path(path, 2)]
    assert [tckpt.load_checkpoint(p).n_iter
            for p in tckpt.checkpoint_candidates(path)] == [4, 3, 2]
    assert tckpt.rotation_path(path, 1) == jckpt.rotation_path(path, 1)
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".tmp")]


@pytest.mark.parametrize("damage", ["truncate", "bitflip", "empty"])
def test_damaged_files_raise_corrupt(tmp_path, damage):
    path = str(tmp_path / "s.npz")
    ck = tckpt.SolverCheckpoint(alpha=np.arange(64, dtype=np.float32),
                                f=np.ones(64, np.float32), n_iter=7,
                                b_lo=1.0, b_hi=0.0, c=1.0, gamma=1.0,
                                epsilon=1e-3, n=64, d=2)
    tckpt.save_checkpoint(path, ck)
    size = os.path.getsize(path)
    with open(path, "r+b") as fh:
        if damage == "truncate":
            fh.truncate(size // 2)
        elif damage == "empty":
            fh.truncate(0)
        else:
            fh.seek(size // 3)
            byte = fh.read(1)
            fh.seek(-1, os.SEEK_CUR)
            fh.write(bytes([byte[0] ^ 0xFF]))
    for mod in (tckpt, jckpt):
        with pytest.raises(mod.CheckpointCorruptError):
            mod.load_checkpoint(path)
    with pytest.raises(FileNotFoundError):
        tckpt.load_checkpoint(str(tmp_path / "missing.npz"))


# ------------------------------------------------------- kill and resume

@pytest.mark.parametrize("path", sorted(PATHS))
def test_kill_and_resume_is_bitwise(path, problem, tmp_path):
    """2K straight against K with checkpoints, then resumed to 2K."""
    x, y = problem
    k = 160
    straight = train(x, y, _cfg(path=path, max_iter=2 * k), device="cpu")
    ck = str(tmp_path / "state.npz")
    first = train(x, y, _cfg(path=path, max_iter=k, checkpoint_path=ck,
                             checkpoint_every=k), device="cpu")
    assert first.n_iter == k == tckpt.load_checkpoint(ck).n_iter
    resumed = train(x, y, _cfg(path=path, max_iter=2 * k, resume_from=ck),
                    device="cpu")
    assert _same(resumed, straight) and resumed.n_iter == 2 * k


@pytest.mark.parametrize("path", sorted(PATHS))
def test_corrupt_newest_slot_falls_back(path, problem, tmp_path, capsys):
    """Saves every 40 iterations, two slots kept; the newest is cut short,
    so the run resumes from the slot before it and still lands bitwise."""
    x, y = problem
    straight = train(x, y, _cfg(path=path, max_iter=240), device="cpu")
    ck = str(tmp_path / "state.npz")
    train(x, y, _cfg(path=path, max_iter=160, checkpoint_path=ck,
                     checkpoint_every=40), device="cpu")
    assert tckpt.load_checkpoint(tckpt.rotation_path(ck, 1)).n_iter == 120
    with open(ck, "r+b") as fh:
        fh.truncate(os.path.getsize(ck) // 2)
    capsys.readouterr()
    resumed = train(x, y, _cfg(path=path, max_iter=240, resume_from=ck),
                    device="cpu")
    assert "resuming from rotation slot" in capsys.readouterr().err
    assert _same(resumed, straight)
    open(tckpt.rotation_path(ck, 1), "wb").close()
    with pytest.raises(tckpt.CheckpointError, match="no intact checkpoint"):
        train(x, y, _cfg(path=path, resume_from=ck), device="cpu")


@pytest.mark.parametrize("path", sorted(PATHS))
def test_checkpoint_of_another_config_raises(path, problem, tmp_path):
    x, y = problem
    ck = str(tmp_path / "state.npz")
    train(x, y, _cfg(path=path, max_iter=80, checkpoint_path=ck,
                     checkpoint_every=40), device="cpu")
    for kw, what in ((dict(c=5.0), "checkpoint c=10.0 != configured c=5.0"),
                     (dict(gamma=0.25), "gamma"),
                     (dict(epsilon=1e-2), "epsilon")):
        with pytest.raises(tckpt.CheckpointMismatchError, match=what):
            train(x, y, _cfg(path=path, resume_from=ck, **kw), device="cpu")
    with pytest.raises(ValueError, match="data is \\(399, 20\\)"):
        train(x[:-1], y[:-1], _cfg(path=path, resume_from=ck), device="cpu")
    msgs = []
    for mod, cls in ((tckpt, SVMConfig), (jckpt, JConfig)):
        with pytest.raises(ValueError) as e:
            mod.load_checkpoint(ck).validate_against(
                400, 20, _cfg(cls, path, kernel="linear"), 0.5)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def _pair_checkpoint_before_the_end(x, y, tmp_path):
    """The general pair's checkpoint one body before it converges: its
    stored b's (the last body's selection) still show an open gap, while
    the selection recomputed from its (alpha, f) is already closed."""
    pair = dict(**BASE, selection="first-order", clip="independent")
    done = tsmo.train_single_device(x, y, SVMConfig(**pair), CPU)
    ck = str(tmp_path / "pair.npz")
    tsmo.train_single_device(x, y, SVMConfig(
        **pair, max_iter=done.n_iter - 1, checkpoint_path=ck,
        checkpoint_every=1), CPU)
    return done, ck


def test_fused_resume_mirrors_the_pair_body(problem, tmp_path):
    """The fused pair resumed from that checkpoint runs one body (the
    mirror) and keeps the recomputed b's: it ends where the general pair
    ended, as the JAX fused path does."""
    x, y = problem
    done, ck = _pair_checkpoint_before_the_end(x, y, tmp_path)
    got = train(x, y, _cfg(resume_from=ck), device="cpu")
    assert got.n_iter == done.n_iter and got.converged
    np.testing.assert_allclose(got.alpha, done.alpha, rtol=1e-5, atol=1e-6)
    assert abs(got.b - done.b) <= 1e-5


def test_resume_saved_at_max_iter_spends_no_update(problem, tmp_path):
    """A checkpoint saved at max_iter resumes to zero updates on every
    path, the fused mirror included. The fused pair reports the gap of
    the selection it recomputed (closed here), the other two the saved
    one, as in the JAX package."""
    x, y = problem
    done, ck = _pair_checkpoint_before_the_end(x, y, tmp_path)
    saved = tckpt.load_checkpoint(ck)
    for path in sorted(PATHS):
        got = train(x, y, _cfg(path=path, max_iter=saved.n_iter,
                               resume_from=ck), device="cpu")
        assert got.n_iter == saved.n_iter, path
        assert got.converged == (path == "fused"), path
        np.testing.assert_array_equal(got.alpha, saved.alpha)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_finished_checkpoint_returns_without_a_body(path, problem,
                                                    tmp_path, monkeypatch):
    x, y = problem
    ck = str(tmp_path / "done.npz")
    done = train(x, y, _cfg(path=path, checkpoint_path=ck,
                            checkpoint_every=1), device="cpu")
    saved = tckpt.load_checkpoint(ck)
    assert done.converged and saved.n_iter == done.n_iter
    if path == "fused":     # returned as it is: no chunk runs at all
        monkeypatch.setattr(tfused, "run_chunk_plain", None)
    got = train(x, y, _cfg(path=path, resume_from=ck), device="cpu")
    assert _same(got, done)


# ------------------------------------------------------ across packages

@pytest.mark.parametrize("path", sorted(PATHS))
def test_jax_checkpoint_resumes_in_the_port(path, problem, tmp_path):
    x, y = problem
    k = 160
    ck = str(tmp_path / "jax.npz")
    jtrain(x, y, _cfg(JConfig, path, max_iter=k, checkpoint_path=ck,
                      checkpoint_every=k))
    ref = jtrain(x, y, _cfg(JConfig, path, max_iter=2 * k))
    got = train(x, y, _cfg(path=path, max_iter=2 * k, resume_from=ck),
                device="cpu")
    assert got.n_iter == ref.n_iter == 2 * k
    np.testing.assert_allclose(got.alpha, ref.alpha, rtol=1e-4, atol=1e-5)
    full = train(x, y, _cfg(path=path, resume_from=ck), device="cpu")
    _assert_models_agree(full, jtrain(x, y, _cfg(JConfig, path)), x, y)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_port_checkpoint_resumes_in_jax(path, problem, tmp_path):
    x, y = problem
    k = 160
    ck = str(tmp_path / "port.npz")
    train(x, y, _cfg(path=path, max_iter=k, checkpoint_path=ck,
                     checkpoint_every=k), device="cpu")
    ref = train(x, y, _cfg(path=path, max_iter=2 * k), device="cpu")
    got = jtrain(x, y, _cfg(JConfig, path, max_iter=2 * k, resume_from=ck))
    assert got.n_iter == ref.n_iter == 2 * k
    np.testing.assert_allclose(got.alpha, ref.alpha, rtol=1e-4, atol=1e-5)
    full = jtrain(x, y, _cfg(JConfig, path, resume_from=ck))
    _assert_models_agree(train(x, y, _cfg(path=path), device="cpu"), full,
                         x, y)


def _assert_models_agree(a, b, x, y):
    assert a.converged and b.converged
    assert abs(a.n_sv - b.n_sv) <= max(0.02 * b.n_sv, 3)
    ma = SVMModel.from_train_result(x, y, a)
    mb = SVMModel.from_train_result(x, y, b)
    assert abs(evaluate(ma, x, y, device="cpu")
               - evaluate(mb, x, y, device="cpu")) <= 1.0 / len(y) + 1e-9


# ------------------------------------------------------------ the loop

class _Fake:
    """Chunk runners that only record their calls; the same for both
    packages' loops (the JAX one reads a packed-stats array)."""

    def __init__(self, jax_side: bool):
        self.calls, self.jax_side = [], jax_side

    def runner(self, tag):
        def run(carry, limit):
            self.calls.append((tag, limit))
            if self.jax_side:
                b = np.asarray([1.0, 0.0], np.float32).view(np.int32)
                return carry, np.asarray([limit, b[0], b[1], 0, 0, 0, 0],
                                         np.int32)
            return carry, tdriver.ChunkStats(limit, 1.0, 0.0, 0, 0, ())
        return run


@pytest.mark.parametrize("every", [0, 10, 20])
def test_loop_schedule_matches_jax(every, tmp_path):
    """Pipelined (no checkpoints): a runner the hook returns at the poll
    of 20 first runs one chunk later; in sequence (checkpoints on): from
    the next chunk. Saves at the same polls in both packages. The JAX
    loop, pipelined, also dispatches one chunk past the end, which its
    device loop turns into a no-op; the port's loop does not."""
    runs = []
    for jax_side in (True, False):
        fake = _Fake(jax_side)
        ck = str(tmp_path / f"s{int(jax_side)}{every}.npz")
        kw = dict(max_iter=60, chunk_iters=10, working_set=8,
                  checkpoint_path=ck if every else None,
                  checkpoint_every=every)

        def hook(n_iter, carry, stats):
            return fake.runner("grown") if n_iter == 20 else None

        host = lambda cr: (np.zeros(3, np.float32), np.zeros(3, np.float32))
        if jax_side:
            res = jdriver.host_training_loop(
                JConfig(**kw), 1.0, 3, 2, None, fake.runner("first"), host,
                poll_hook=hook)
        else:
            res = tdriver.host_training_loop(
                SVMConfig(**kw), 1.0, None, fake.runner("first"), host,
                poll_hook=hook, dims=(3, 2))
        saved = (tckpt.load_checkpoint(ck).n_iter if every else None)
        calls = fake.calls
        if jax_side and every == 0:
            assert calls[-1] == calls[-2]       # the speculative chunk
            calls = calls[:-1]
        runs.append((calls, res.n_iter, saved))
    assert runs[0] == runs[1]
    calls = runs[0][0]
    first_grown = [t for t, _ in calls].index("grown")
    assert calls[first_grown][1] == (40 if every == 0 else 30)


def test_only_checkpoint_polls_read_the_state(problem, tmp_path):
    x, y = problem
    for every, saves in ((0, 0), (40, 4)):
        before = dict(tdriver.CHECKPOINTS)
        kw = dict(checkpoint_path=str(tmp_path / "s.npz"),
                  checkpoint_every=every) if every else {}
        train(x, y, _cfg(path="pair", max_iter=160, **kw), device="cpu")
        got = {k: tdriver.CHECKPOINTS[k] - before[k]
               for k in ("saves", "pulls")}
        assert got == {"saves": saves, "pulls": saves}


def test_grow_working_set_with_checkpoints_follows_jax(tmp_path):
    """Growth with checkpoints on: both loops dispatch in sequence, so the
    grown runner takes over at the next chunk in both packages, and they
    grow through the same q. Past ~2000 updates the decomposition's
    trajectories part at near-ties (tests/test_torch_decomp.py), so the
    models are held to the model bar."""
    import contextlib
    import io
    import re

    x, y = make_blobs(n=1000, d=5, seed=2)
    grow = dict(c=10.0, gamma=0.5, epsilon=1e-3, max_iter=200_000,
                working_set=16, grow_working_set=True, verbose=True,
                checkpoint_every=2048)
    out = []
    for run in (
            lambda: train(x, y, SVMConfig(
                checkpoint_path=str(tmp_path / "t.npz"), **grow),
                device="cpu"),
            lambda: jdecomp.train_single_device_decomp(x, y, JConfig(
                checkpoint_path=str(tmp_path / "j.npz"), **grow))):
        err = io.StringIO()
        with contextlib.redirect_stderr(err), \
                contextlib.redirect_stdout(io.StringIO()):
            res = run()
        out.append((res, re.findall(r"-> q=(\d+)", err.getvalue())))
    (got, grew), (ref, grew_ref) = out
    assert grew == grew_ref and grew
    assert got.converged and ref.converged
    assert abs(got.n_sv - ref.n_sv) <= max(0.02 * ref.n_sv, 3)


# ------------------------------------------------------- config and CLI

@pytest.mark.parametrize("kw", [
    dict(checkpoint_every=-1), dict(checkpoint_every=10),
    dict(checkpoint_every=10, checkpoint_path="s.npz", checkpoint_keep=0),
    dict(checkpoint_path="s.npz", checkpoint_keep=1),
    dict(resume_from="s.npz"),
])
def test_validation_matches_jax(kw):
    outcome = []
    for cls in (JConfig, SVMConfig):
        try:
            cls(**kw).validate()
            outcome.append(None)
        except ValueError as e:
            outcome.append(str(e))
    assert outcome[0] == outcome[1], outcome


def test_warm_start_refuses_resume_from(problem):
    from dpsvm_tpu.api import warm_start as jwarm_start
    x, y = problem
    msgs = []
    for fn, cls, kw in ((warm_start, SVMConfig, dict(device="cpu")),
                        (jwarm_start, JConfig, {})):
        with pytest.raises(ValueError) as e:
            fn(x, y, np.zeros(len(y), np.float32),
               cls(resume_from="s.npz"), **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "resume_from" in msgs[0]


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, "-m", "dpsvm_tpu_torch", *args],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)


def test_cli_checkpoint_and_resume(problem, tmp_path):
    x, y = problem
    data = str(tmp_path / "d.csv")
    save_csv(data, x, y)
    ck = str(tmp_path / "state.npz")
    common = ["-f", data, "--device", "cpu", "-c", "10", "-g", "0.5", "-q"]
    for n in (100, 200, 300):       # one poll a run: three saves, kept
        out = _cli("train", *common, "-m", str(tmp_path / "a.svm"),
                   "--checkpoint", ck, "--checkpoint-every", "100",
                   "--checkpoint-keep", "3", "-n", str(n))
        assert out.returncode == 0, out.stderr
        assert "NOT converged" in out.stdout
    assert [tckpt.load_checkpoint(p).n_iter
            for p in tckpt.checkpoint_candidates(ck)] == [300, 200, 100]
    out = _cli("train", *common, "-m", str(tmp_path / "b.svm"),
               "--resume", ck)
    assert out.returncode == 0, out.stderr
    full = _cli("train", *common, "-m", str(tmp_path / "c.svm"))
    line = [ln for ln in full.stdout.splitlines()
            if ln.startswith("Training iterations")]
    assert line and line[0] in out.stdout.splitlines()
    out = _cli("train", *common, "-m", str(tmp_path / "d.svm"),
               "--resume", str(tmp_path / "nope.npz"))
    assert out.returncode == 2 and "no such checkpoint file" in out.stderr

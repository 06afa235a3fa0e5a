"""The port's profiler ranges (``dpsvm_tpu_torch/utils/timing.span``) on
the CPU.

* Off (no torch profiler recording on the thread): ``span`` hands back one
  shared null context and never builds a ``record_function``; a process
  without torch is not made to import it.
* On, under a caller's own ``torch.profiler.profile``: ``api.fit`` on the
  fused route exports ``fit`` around ``fit.check``, ``fit.upload``,
  ``train.loop`` (around the driver's ``dispatch`` and ``poll``),
  ``train.download`` and ``fit.compact``, properly nested and in that
  order; the decomposition its four ``decomp.*`` ranges inside a
  dispatch; a ``PredictionEngine`` ``engine.run`` around its pass spans on
  the single-pass and the many-pass path.
* ``train --profile-dir``'s sidecar takes its phase vocabulary from the
  driver's timer; ``record_function`` is called nowhere else in the port.
"""

import contextlib
import inspect
import json
import sys
import tokenize
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from torch_threads import one_thread  # noqa: F401

from dpsvm_tpu_torch import api
from dpsvm_tpu_torch.config import SVMConfig
from dpsvm_tpu_torch.experimental import fused
from dpsvm_tpu_torch.models.svm import SVMModel
from dpsvm_tpu_torch.observability.profiler import ProfileSession
from dpsvm_tpu_torch.serving.engine import PredictionEngine
from dpsvm_tpu_torch.utils import timing
from dpsvm_tpu_torch.utils.timing import PhaseTimer, span

PACKAGE = Path(__file__).resolve().parents[1] / "dpsvm_tpu_torch"
FIT_CHILDREN = ["fit.check", "fit.upload", "train.loop", "train.download",
                "fit.compact"]
PASSES = ["engine.pad", "engine.upload", "engine.replay", "engine.download"]


def _problem(n=160, d=6, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = np.where(x[:, 0] + 0.5 * x[:, 1] > 0, 1, -1).astype(np.int32)
    return x, y


def _model(n_sv=24, d=6, seed=1):
    rng = np.random.default_rng(seed)
    return SVMModel(x_sv=rng.normal(size=(n_sv, d)).astype(np.float32),
                    alpha=rng.uniform(0.1, 1.0, n_sv).astype(np.float32),
                    y_sv=np.where(rng.random(n_sv) < 0.5, 1,
                                  -1).astype(np.int32),
                    b=0.25, gamma=0.5, kernel="rbf")


def _spans(fn, tmp_path):
    """Run ``fn`` under a CPU profiler; the exported ``user_annotation``
    ranges as (name, start, end), in start order."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    if isinstance(events, dict):
        events = events["traceEvents"]
    out = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
           for e in events
           if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    return sorted(out, key=lambda s: (s[1], -s[2]))


def _inside(child, parent) -> bool:
    return parent[1] <= child[1] and child[2] <= parent[2]


def _one(spans, name):
    found = [s for s in spans if s[0] == name]
    assert len(found) == 1, (name, found)
    return found[0]


@pytest.fixture
def no_record_function(monkeypatch):
    """``record_function`` made to raise: off, nothing may build one."""
    def refuse(*_a, **_k):
        raise AssertionError("record_function built with no profiler on")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)


# -- off ---------------------------------------------------------------


def test_span_off_is_the_shared_null_context(no_record_function):
    assert not torch._C._autograd._profiler_enabled()
    first, second = span("fit"), span("engine.pad")
    assert first is second
    assert isinstance(first, contextlib.nullcontext)
    with span("fit"), span("fit"):      # re-entrant and reusable
        pass
    timer = PhaseTimer()
    with timer.phase("dispatch"):
        pass
    assert timer.counts == {"dispatch": 1}


def test_span_without_torch_imports_nothing(monkeypatch):
    monkeypatch.delitem(sys.modules, "torch")
    assert span("fit") is timing._OFF
    assert "torch" not in sys.modules


def test_fit_and_engine_build_no_range_with_no_profiler(no_record_function):
    x, y = _problem()
    model, res = api.fit(x, y, SVMConfig(c=1.0, gamma=0.5, chunk_iters=64),
                         device="cpu")
    assert res.converged and model.x_sv.shape[0] == res.n_sv
    eng = PredictionEngine(_model(), max_batch=16, device="cpu")
    try:
        assert eng.decision_values(x[:40]).shape == (40,)
    finally:
        eng.close()


def test_phase_timer_has_no_annotate_hook():
    assert list(inspect.signature(PhaseTimer).parameters) == []
    assert not hasattr(ProfileSession, "annotation")


def _code_tokens(path: Path):
    with open(path, "rb") as fh:
        for tok in tokenize.tokenize(fh.readline):
            if tok.type == tokenize.NAME:
                yield tok.string


def test_record_function_is_called_only_by_span():
    """Exactly one way to open a range: outside ``utils/timing.py`` no
    code of the port names ``record_function`` (comments and docstrings
    may)."""
    users = sorted(str(p.relative_to(PACKAGE))
                   for p in PACKAGE.rglob("*.py")
                   if "record_function" in _code_tokens(p))
    assert users == ["utils/timing.py"]


# -- on ----------------------------------------------------------------


def test_span_on_is_a_record_function():
    with profile(activities=[ProfilerActivity.CPU]):
        assert torch._C._autograd._profiler_enabled()
        assert span("a") is not span("a")
        assert not isinstance(span("a"), contextlib.nullcontext)
    assert span("a") is timing._OFF


def test_fit_exports_the_span_tree(tmp_path, monkeypatch):
    routes = []
    real = fused.train_single_device_fused

    def spy(*a, **k):
        routes.append("fused")
        return real(*a, **k)
    monkeypatch.setattr(fused, "train_single_device_fused", spy)
    x, y = _problem()
    got = {}

    def run():
        got["res"] = api.fit(x, y, SVMConfig(c=1.0, gamma=0.5,
                                             chunk_iters=64),
                             device="cpu")[1]
    spans = _spans(run, tmp_path)
    assert routes == ["fused"] and got["res"].converged
    fit = _one(spans, "fit")
    kids = [_one(spans, name) for name in FIT_CHILDREN]
    for kid in kids:
        assert _inside(kid, fit), kid
    # in call order, none overlapping the next
    for a, b in zip(kids, kids[1:]):
        assert a[2] <= b[1], (a, b)
    loop = kids[FIT_CHILDREN.index("train.loop")]
    phases = [s for s in spans if s[0] in ("dispatch", "poll")]
    dispatch = [s for s in phases if s[0] == "dispatch"]
    polls = [s for s in phases if s[0] == "poll"]
    assert len(dispatch) == len(polls) >= 2
    assert all(_inside(s, loop) for s in phases)
    # a poll follows each dispatch
    assert [s[0] for s in phases] == ["dispatch", "poll"] * len(polls)


def test_decomposition_ranges_nest_in_a_dispatch(tmp_path):
    x, y = _problem(n=120)
    cfg = SVMConfig(c=1.0, gamma=0.5, working_set=16, inner_iters=8,
                    chunk_iters=64)
    spans = _spans(lambda: api.fit(x, y, cfg, device="cpu"), tmp_path)
    dispatch = [s for s in spans if s[0] == "dispatch"]
    assert dispatch
    for name in ("decomp.select", "decomp.k_ww", "decomp.subsolve",
                 "decomp.rank_q"):
        found = [s for s in spans if s[0] == name]
        assert found, name
        assert all(any(_inside(s, d) for d in dispatch) for s in found)


@pytest.mark.parametrize("rows,passes", [(13, 1), (40, 3)])
def test_engine_exports_run_around_its_passes(tmp_path, rows, passes):
    eng = PredictionEngine(_model(), max_batch=16, device="cpu")
    try:
        assert len(eng._ladder.plan(rows)) == passes
        x = np.random.default_rng(2).normal(size=(rows, 6)).astype(
            np.float32)
        spans = _spans(lambda: eng.decision_values(x), tmp_path)
    finally:
        eng.close()
    run = _one(spans, "engine.run")
    want = PASSES + (["engine.gather"] if passes > 1 else [])
    kids = [_one(spans, name) for name in want]
    assert all(_inside(k, run) for k in kids)
    for a, b in zip(kids, kids[1:]):
        assert a[2] <= b[1], (a, b)
    assert {s[0] for s in spans} == {"engine.run", *want}


def test_profile_sidecar_takes_the_timers_phases(tmp_path):
    """``train --profile-dir``'s window: the phases' ranges land in its
    artifact, and the sidecar names the timer's phases."""
    session = ProfileSession(str(tmp_path), skip_polls=0, capture_polls=1,
                             solver="fused", device="cpu")
    timer = PhaseTimer()
    session.attach_timer(timer)
    with timer.phase("dispatch"):
        pass
    session.note_poll()                 # opens the window
    with timer.phase("dispatch"):
        pass
    with timer.phase("poll"):
        pass
    session.note_poll()                 # closes it
    with timer.phase("hook"):
        pass
    summary = json.loads(Path(session.close()).read_text())
    assert summary["annotations"] == ["dispatch", "poll", "hook"]
    assert summary["phases"]["poll"]["calls"] == 1
    assert summary["phases"]["dispatch"]["calls"] == 1
    [art] = summary["artifacts"]
    events = json.loads((tmp_path / art["path"]).read_text())
    events = events.get("traceEvents", events) if isinstance(
        events, dict) else events
    names = [e["name"] for e in events
             if e.get("cat") == "user_annotation"]
    assert sorted(names) == ["dispatch", "poll"]

"""CPU tests of the per-layer metrics that read the program's spans
(``fit_before_loop_ms``, ``fit_after_loop_ms``, ``poll_idle_us``,
``engine_pad_ms_per_krow``, ``engine_upload_ms_per_krow``), on a
``trace.Trace`` built by hand from synthetic profiler events: each reads
its value, and None where the trace holds none of its spans (a program
without them).

    python -m pytest svmbench/tests -q
"""

import types
from pathlib import Path

import pytest

from svmbench import core
from svmbench.trace import Trace

ROOT = Path(__file__).resolve().parents[2]


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _span(name, ts, dur):
    return _ev("user_annotation", name, ts, dur)


def _fit_events(spans=True):
    """A 1000 us profiled fit: ``fit`` [10, 990], ``train.loop``
    [100, 900] holding two polls; kernels busy [100, 400] and [450, 850]
    (inside the loop: 100 us idle) and a copy up at [20, 60]."""
    ev = [_span("svmbench.fit", 0, 1000),
          _ev("kernel", "fused_iter_kernel", 100, 200),
          _ev("kernel", "fused_iter_kernel", 250, 150),   # overlaps
          _ev("kernel", "fused_iter_kernel", 450, 400),
          _ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 20, 40),
          _ev("cpu_op", "aten::copy_", 15, 50)]
    if spans:
        ev += [_span("fit", 10, 980), _span("fit.upload", 12, 70),
               _span("train.loop", 100, 800),
               _span("dispatch", 110, 20), _span("poll", 400, 50),
               _span("dispatch", 455, 20), _span("poll", 850, 40),
               _span("poll", 950, 10),                 # after the loop
               _span("fit.compact", 910, 60)]
    return ev


def _score_events(spans=True):
    """A 2000 us profiled slice of two jobs, each padding 300 us and
    uploading 100 us on the host."""
    ev = [_span("svmbench.slice", 0, 2000),
          _ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 400, 90),
          _ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 1400, 90),
          _ev("kernel", "gemm", 500, 400), _ev("kernel", "gemm", 1500, 400)]
    if spans:
        for t in (0, 1000):
            ev += [_span("engine.run", t + 50, 900),
                   _span("engine.pad", t + 80, 300),
                   _span("engine.upload", t + 390, 100),
                   _span("engine.replay", t + 495, 400)]
    return ev


def _ctx(kind, events, slice_name, rows=0):
    cell = types.SimpleNamespace(kind=kind, slice_rows=lambda: rows)
    return types.SimpleNamespace(cell=cell,
                                 trace=Trace(events, slice_name))


FIT_READINGS = {"fit_before_loop_ms": 0.09, "fit_after_loop_ms": 0.09,
                # loop [100, 900] less busy [100, 400] and [450, 850]:
                # 100 us over the two polls inside it
                "poll_idle_us": 50.0}
SCORE_READINGS = {"engine_pad_ms_per_krow": 0.6 / 2.5,
                  "engine_upload_ms_per_krow": 0.2 / 2.5}


@pytest.mark.parametrize("name,value", sorted(FIT_READINGS.items()))
def test_fit_span_metric_reads_its_value(name, value):
    ctx = _ctx("fit", _fit_events(), "svmbench.fit")
    assert core.reader(ROOT, name)(ctx) == pytest.approx(value)


@pytest.mark.parametrize("name,value", sorted(SCORE_READINGS.items()))
def test_score_span_metric_reads_its_value(name, value):
    ctx = _ctx("score", _score_events(), "svmbench.slice", rows=2500)
    assert core.reader(ROOT, name)(ctx) == pytest.approx(value)


@pytest.mark.parametrize("name", sorted(FIT_READINGS) + sorted(
    SCORE_READINGS))
def test_span_metric_reads_none_without_the_spans(name):
    """A program without the spans (the parent's) reports nothing; so do
    a run with no trace and a cell of the other kind."""
    read = core.reader(ROOT, name)
    fit_kind = name in FIT_READINGS
    kind, events, slice_name = (
        ("fit", _fit_events, "svmbench.fit") if fit_kind
        else ("score", _score_events, "svmbench.slice"))
    assert read(_ctx(kind, events(spans=False), slice_name,
                     rows=2500)) is None
    assert read(types.SimpleNamespace(
        cell=types.SimpleNamespace(kind=kind, slice_rows=lambda: 2500),
        trace=None)) is None
    other = "score" if fit_kind else "fit"
    assert read(_ctx(other, events(), slice_name, rows=2500)) is None


def test_the_span_metrics_are_in_the_manifest():
    bench = core.load_bench(ROOT)
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for name in FIT_READINGS:
        m = per_layer[name]
        assert m["source"] == "program_span" and m["moves"] == "fit_s"
        assert m["workloads"] == ["mnist-evenodd.fit", "adult.fit"]
    for name in SCORE_READINGS:
        m = per_layer[name]
        assert m["source"] == "program_span"
        assert m["moves"] == "score_rows_per_s"
        assert m["workloads"] == ["mnist-evenodd.score"]

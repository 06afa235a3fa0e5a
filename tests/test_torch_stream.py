"""The port's shard directories and out-of-core training
(``dpsvm_tpu_torch/data/stream.py``, ``approx.primal.fit_approx_stream``,
``solver.cascade.fit_cascade_stream``) on the CPU, against the JAX
package's ``dpsvm_tpu/data/stream.py`` and its streaming paths.

Bars, and why:

* the shard format is shared: for the same source both packages write the
  same manifest, byte for byte, and each loads the other's directory to
  the same arrays; a conversion stopped (or SIGKILLed) mid-way resumes to
  that manifest;
* the integrity path (quarantine, raise, the bad-fraction abort, transient
  retry, truncation, non-finite rows) and the budget refusals behave as
  JAX's and raise its messages;
* ``fit_approx_stream`` against JAX's on the same directory, to the bars
  of ``tests/test_torch_approx.py`` (decisions within 5e-3, held-out
  accuracy within one example, n_iter within 5%): the two reduce in
  different orders;
* against the port's own in-memory full-batch steps over the same rows
  with the same step size (the streaming fit's, held first to the
  in-memory trace bound over those rows to 1e-6), w within 1e-5 of its
  largest entry over a 64-step prefix: the same float32 arithmetic summed
  shard by shard, the in-memory rows shuffled;
* a streaming run reads the packed stats exactly as often as an in-memory
  run (``primal.COUNTS["reads"]``), and a run cut at a checkpoint resumes
  bitwise (and from a JAX checkpoint to the fit bar);
* ``fit_cascade_stream`` against JAX's by the bar between paths (zero
  violators, kept rows within 1%, n_sv within 2% or 3, accuracy within
  one example);
* the CLI's ``convert``, ``train`` and ``test`` on shards, ``scale``, the
  refusals (``live=True``, ``shards != 1``, ``solver="exact"``) and the
  data selfcheck.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import time
from contextlib import redirect_stdout
from io import StringIO
from pathlib import Path

import numpy as np
import pytest
import torch

from dpsvm_tpu.approx import model as jmodel
from dpsvm_tpu.approx import primal as jprimal
from dpsvm_tpu.cli import main as jmain
from dpsvm_tpu.config import SVMConfig as JConfig
from dpsvm_tpu.data import stream as jstream
from dpsvm_tpu.data.loader import load_dataset as jload
from dpsvm_tpu.data.synthetic import make_blobs, save_csv
from dpsvm_tpu.resilience import faultinject as jfault
from dpsvm_tpu.solver import cascade as jcs
from dpsvm_tpu_torch.approx import model as tmodel
from dpsvm_tpu_torch.approx import primal as tprimal
from dpsvm_tpu_torch.approx.features import build_feature_map
from dpsvm_tpu_torch.cli import main as tmain
from dpsvm_tpu_torch.config import SVMConfig
from dpsvm_tpu_torch.data import stream as tstream
from dpsvm_tpu_torch.data.loader import load_dataset as tload
from dpsvm_tpu_torch.observability.metrics import (DataMetrics,
                                                   MetricsRegistry)
from dpsvm_tpu_torch.resilience import faultinject as tfault
from dpsvm_tpu_torch.solver import cascade as tcs
from dpsvm_tpu_torch.solver import driver

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's small eager steps: the tier-1
    run puts six workers on the cores, and a worker's BLAS threads then
    contend (tests/test_torch_approx.py measured 69 s against 1.2 s)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    monkeypatch.setenv("DPSVM_IO_RETRY_BACKOFF_S", "0.001")
    for mod in (jfault, tfault):
        mod.clear()
    yield
    for mod in (jfault, tfault):
        mod.clear()


def _in_memory_problem(x, y, cfg, fmap, lr, device=CPU):
    """The in-memory full-batch problem over the same rows, with the step
    size of the streaming fit: its ``lr`` (the trace curvature bound over
    the prologue's pass) is held first to the in-memory trace bound over
    these rows (``RUN["msq"]``), then set on the problem."""
    prob = tprimal.build_problem(x, np.asarray(y, np.float32), cfg, "svc",
                                 fmap, device)
    assert prob.n_batches == 1
    big_l = 1.0 / (cfg.c * len(y)) + 2.0 * tprimal.RUN["msq"]
    assert abs(float(lr) * big_l - 1.0) <= 1e-6
    return dataclasses.replace(prob, lr=torch.tensor(np.float32(lr),
                                                     device=device))


def _make(tmp_path, n=384, d=6, rows=96, seed=7, name="shards"):
    x, y = make_blobs(n=n, d=d, seed=seed)
    src = str(tmp_path / f"src_{name}.csv")
    save_csv(src, x, y)
    sdir = str(tmp_path / name)
    tstream.convert_to_shards(src, sdir, rows_per_shard=rows)
    return x.astype(np.float32), y, src, sdir


def _corrupt(sdir, k):
    """Flip one payload byte inside the npz member (the container still
    parses; the manifest CRC catches it)."""
    path = os.path.join(sdir, tstream.shard_filename(k))
    raw = bytearray(Path(path).read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    Path(path).write_bytes(bytes(raw))


def _manifest(sdir):
    return Path(sdir, tstream.MANIFEST_NAME).read_bytes()


def _errors(fn_t, fn_j, exc):
    msgs = []
    for fn in (fn_t, fn_j):
        with pytest.raises(exc) as e:
            fn()
        msgs.append(str(e.value))
    return msgs


# --- the shared on-disk format --------------------------------------------

def _libsvm_source(path, x, y):
    with open(path, "w") as fh:
        for i in range(len(y)):
            toks = " ".join(f"{j + 1}:{float(x[i, j])!r}"
                            for j in np.flatnonzero(x[i] > 0))
            fh.write(f"{int(y[i])} {toks}".rstrip() + "\n")


@pytest.mark.parametrize("case", ["csv-96", "csv-100-short", "libsvm-64",
                                  "float-labels", "narrowed"])
def test_shard_dirs_cross_both_ways(tmp_path, case):
    x, y = make_blobs(n=384, d=6, seed=11)
    src = str(tmp_path / "src")
    kw = dict(rows_per_shard=96)
    if case.startswith("libsvm"):
        _libsvm_source(src, x, y)
        kw = dict(rows_per_shard=64)
    else:
        save_csv(src, x, y)
    if case == "csv-100-short":
        kw = dict(rows_per_shard=100)       # a short final shard
    if case == "float-labels":
        kw["float_labels"] = True
    if case == "narrowed":
        kw["num_attributes"] = 4
    mt = tstream.convert_to_shards(src, str(tmp_path / "t"), **kw)
    mj = jstream.convert_to_shards(src, str(tmp_path / "j"), **kw)
    assert mt == mj
    assert _manifest(tmp_path / "t") == _manifest(tmp_path / "j")
    for a, b in ((tmp_path / "t", jload), (tmp_path / "j", tload)):
        got = b(str(a))
        want = (tload if b is jload else jload)(str(a))
        for u, v in zip(got, want):
            np.testing.assert_array_equal(u, v)
            assert u.dtype == v.dtype
    ds_t = tstream.ShardedDataset.open(str(tmp_path / "j"))
    ds_j = jstream.ShardedDataset.open(str(tmp_path / "t"))
    assert ds_t.verify() == ds_j.verify() == []
    idx = np.array([0, 5, 95, 96, 200, 383])
    np.testing.assert_array_equal(ds_t.gather_rows(idx),
                                  ds_j.gather_rows(idx))


def test_stop_and_resume_byte_identical_manifest(tmp_path):
    x, y = make_blobs(n=384, d=6, seed=7)
    src = str(tmp_path / "s.csv")
    save_csv(src, x, y)
    jstream.convert_to_shards(src, str(tmp_path / "oneshot"),
                              rows_per_shard=96)
    killed = str(tmp_path / "killed")
    part = tstream.convert_to_shards(src, killed, rows_per_shard=96,
                                     _stop_after_shards=2)
    assert part["rows_done"] == 192
    assert os.path.exists(os.path.join(killed, tstream.CURSOR_NAME))
    assert not tstream.is_shard_dir(killed)
    tstream.convert_to_shards(src, killed, rows_per_shard=96)
    assert _manifest(killed) == _manifest(tmp_path / "oneshot")
    assert not os.path.exists(os.path.join(killed, tstream.CURSOR_NAME))
    # a JAX cursor resumes in the port too
    jk = str(tmp_path / "jkilled")
    jstream.convert_to_shards(src, jk, rows_per_shard=96,
                              _stop_after_shards=1)
    tstream.convert_to_shards(src, jk, rows_per_shard=96)
    assert _manifest(jk) == _manifest(tmp_path / "oneshot")


def test_kill_mid_convert_subprocess_resumes(tmp_path):
    """SIGKILL a converting CLI process mid-flight, resume, and the
    manifest is byte-identical to an uninterrupted conversion's."""
    x, y = make_blobs(n=2000, d=16, seed=5)
    src = str(tmp_path / "big.csv")
    save_csv(src, x, y)
    one = str(tmp_path / "oneshot")
    jstream.convert_to_shards(src, one, rows_per_shard=100)
    kdir = str(tmp_path / "killed")
    env = dict(os.environ, PYTHONPATH=str(ROOT),
               DPSVM_FAULT_IO_SLOW_READ_MS="0")
    proc = subprocess.Popen(
        [sys.executable, "-m", "dpsvm_tpu_torch", "convert", "shards",
         src, kdir, "--rows-per-shard", "100"], cwd=str(ROOT), env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    deadline = time.time() + 60
    try:
        while time.time() < deadline:
            done = tstream.is_shard_dir(kdir)
            shards = ([f for f in os.listdir(kdir) if f.startswith("shard-")]
                      if os.path.isdir(kdir) else [])
            if done or len(shards) >= 3:
                break
            time.sleep(0.01)
        proc.send_signal(signal.SIGKILL)
    finally:
        proc.wait(30)
    if not tstream.is_shard_dir(kdir):          # killed in time
        assert os.path.exists(os.path.join(kdir, tstream.CURSOR_NAME))
        tstream.convert_to_shards(src, kdir, rows_per_shard=100)
    assert _manifest(kdir) == _manifest(one)
    assert tstream.ShardedDataset.open(kdir).verify() == []


@pytest.mark.parametrize("what", ["missing-key", "newer", "rows", "torn",
                                  "self-crc", "not-a-dir"])
def test_manifest_refusals_match_jax(tmp_path, what):
    _x, _y, _src, sdir = _make(tmp_path)
    mpath = os.path.join(sdir, tstream.MANIFEST_NAME)
    m = json.loads(Path(mpath).read_text())
    exc = tstream.StreamError
    if what == "missing-key":
        del m["rows_per_shard"]
    elif what == "newer":
        m["version"] = 9
    elif what == "rows":
        m["n"] = 999
    elif what == "self-crc":
        m["manifest_crc"] = 12345
    if what == "torn":
        Path(mpath).write_text("{ torn")
        Path(mpath + ".prev").write_text("{}")
    elif what == "not-a-dir":
        os.unlink(mpath)
        exc = FileNotFoundError
    else:
        Path(mpath).write_text(json.dumps(m))
    msgs = _errors(lambda: tstream.ShardedDataset.open(sdir),
                   lambda: jstream.ShardedDataset.open(sdir),
                   exc if exc is FileNotFoundError else Exception)
    assert msgs[0] == msgs[1]


def test_load_dataset_prefix_and_width_refusal_match_jax(tmp_path):
    x, y, _src, sdir = _make(tmp_path)
    xt, yt = tload(sdir, num_examples=100, float_labels=True)
    xj, yj = jload(sdir, num_examples=100, float_labels=True)
    np.testing.assert_array_equal(xt, xj)
    np.testing.assert_array_equal(yt, yj)
    assert yt.dtype == np.float32
    msgs = _errors(lambda: tload(sdir, num_attributes=5),
                   lambda: jload(sdir, num_attributes=5), ValueError)
    assert msgs[0] == msgs[1]
    msgs = _errors(lambda: tload(sdir, num_examples=999),
                   lambda: jload(sdir, num_examples=999), ValueError)
    assert msgs[0] == msgs[1]


# --- integrity: quarantine, retry, truncation, non-finite rows ----------

def test_corrupt_shard_raises_naming_shard(tmp_path):
    _x, _y, _src, sdir = _make(tmp_path)
    _corrupt(sdir, 1)
    msgs = _errors(lambda: tstream.ShardedDataset.open(sdir).materialize(),
                   lambda: jstream.ShardedDataset.open(sdir).materialize(),
                   Exception)
    assert msgs[0] == msgs[1] and msgs[0].startswith("shard 1:")


def test_quarantine_drops_counts_and_queues_the_event(tmp_path):
    _x, _y, _src, sdir = _make(tmp_path)
    _corrupt(sdir, 1)
    reg = MetricsRegistry()
    before = DataMetrics()._c_quar.value
    ds = tstream.ShardedDataset.open(sdir)
    events = []
    assert ds.read_shard_checked(
        1, on_bad_shard="quarantine",
        on_quarantine=lambda k, r: events.append((k, r))) is None
    assert 1 in ds.quarantined and events[0][0] == 1
    assert "CRC" in events[0][1]
    assert ds.read_shard_checked(1, on_bad_shard="quarantine") is None
    xm, ym = ds.materialize(on_bad_shard="quarantine")
    assert len(ym) == 384 - 96
    assert DataMetrics()._c_quar.value == before + 1
    # the default consumer: the driver's queue, drained at a poll
    ds2 = tstream.ShardedDataset.open(sdir)
    driver.drain_queued_events()
    assert ds2.read_shard_checked(1, on_bad_shard="quarantine") is None
    got = driver.drain_queued_events()
    assert got and got[0][0] == "quarantine"
    assert got[0][1]["shard"] == 1 and got[0][1]["rows"] == 96
    dm = DataMetrics(reg)
    dm.on_read(rows=5)
    dm.on_quarantine()
    dm.on_retry()
    dm.on_ingest_seconds(0.25)
    snap = reg.snapshot()
    for name in ("dpsvm_data_shards_read_total",
                 "dpsvm_data_rows_read_total",
                 "dpsvm_data_shards_quarantined_total",
                 "dpsvm_data_io_retries_total",
                 "dpsvm_data_ingest_seconds_total"):
        assert name in snap, name
    assert "dpsvm_data_rows_read_total 5" in reg.render_prometheus()


def test_bad_fraction_abort_matches_jax(tmp_path):
    _x, _y, _src, sdir = _make(tmp_path)
    for k in (0, 1):
        _corrupt(sdir, k)
    msgs = _errors(
        lambda: tstream.ShardedDataset.open(sdir).materialize(
            on_bad_shard="quarantine"),
        lambda: jstream.ShardedDataset.open(sdir).materialize(
            on_bad_shard="quarantine"), Exception)
    assert msgs[0] == msgs[1] and "bad-fraction" in msgs[0]


@pytest.mark.parametrize("knob", ["read_fail_once", "truncate"])
def test_io_faults_match_jax(tmp_path, knob):
    _x, _y, _src, sdir = _make(tmp_path)
    if knob == "read_fail_once":
        for mod in (tfault, jfault):
            mod.install(mod.FaultPlan(io_read_fail_once=1))
        x0, _ = tstream.ShardedDataset.open(sdir).read_shard(0)
        x1, _ = jstream.ShardedDataset.open(sdir).read_shard(0)
        np.testing.assert_array_equal(x0, x1)
        assert x0.shape == (96, 6)
        return
    for mod in (tfault, jfault):
        mod.install(mod.FaultPlan(io_truncate_shard=3))
    msgs = _errors(lambda: tstream.ShardedDataset.open(sdir).read_shard(2),
                   lambda: jstream.ShardedDataset.open(sdir).read_shard(2),
                   Exception)
    assert msgs[0] == msgs[1] and msgs[0].startswith("shard 2:")


def test_nonfinite_rows_name_the_row_and_take_the_escape_hatch(tmp_path):
    src = tmp_path / "bad.csv"
    rows = ["1," + ",".join(["0.5"] * 3)] * 7
    rows[5] = "-1,0.25,nan,0.5"
    src.write_text("\n".join(rows) + "\n")
    msgs = _errors(
        lambda: tstream.convert_to_shards(str(src), str(tmp_path / "r1"),
                                          rows_per_shard=4),
        lambda: jstream.convert_to_shards(str(src), str(tmp_path / "r2"),
                                          rows_per_shard=4), ValueError)
    assert msgs[0] == msgs[1] and "row 5, column 1" in msgs[0]
    sdir = str(tmp_path / "ok")
    tstream.convert_to_shards(str(src), sdir, rows_per_shard=4,
                              allow_nonfinite=True)
    msgs = _errors(
        lambda: tstream.ShardedDataset.open(sdir).read_shard_checked(1),
        lambda: jstream.ShardedDataset.open(sdir).read_shard_checked(1),
        Exception)
    assert msgs[0] == msgs[1] and "dataset row 5" in msgs[0]
    got = tstream.ShardedDataset.open(sdir).read_shard_checked(
        1, allow_nonfinite=True)
    assert got is not None and np.isnan(got[0][1, 1])
    ds = tstream.ShardedDataset.open(sdir)
    ds.max_bad_fraction = 0.6
    assert ds.read_shard_checked(1, on_bad_shard="quarantine") is None
    assert "row" in ds.quarantined[1]


def test_io_fault_knobs_parse_from_env(monkeypatch):
    monkeypatch.setenv("DPSVM_FAULT_IO_READ_FAIL_ONCE", "2")
    monkeypatch.setenv("DPSVM_FAULT_IO_CORRUPT_SHARD", "3")
    monkeypatch.setenv("DPSVM_FAULT_IO_TRUNCATE_SHARD", "4")
    monkeypatch.setenv("DPSVM_FAULT_IO_SLOW_READ_MS", "1")
    plan = tfault.plan_from_env()
    assert plan is not None and plan.any()
    assert (plan.io_read_fail_once, plan.io_corrupt_shard,
            plan.io_truncate_shard, plan.io_slow_read_ms) == (2, 3, 4, 1)
    assert plan.io_corrupt_now(2) and not plan.io_corrupt_now(1)
    assert plan.io_truncate_now(3)
    plan.io_read_begin(0)
    with pytest.raises(OSError, match="read #2"):
        plan.io_read_begin(1)
    plan.io_read_begin(2)                   # fires once


# --- memory-budget guards -------------------------------------------------

def test_materialize_refusal_names_shard_math(tmp_path):
    _x, _y, src, sdir = _make(tmp_path)
    msgs = _errors(
        lambda: tstream.ShardedDataset.open(sdir).materialize(
            mem_budget_mb=0.001),
        lambda: jstream.ShardedDataset.open(sdir).materialize(
            mem_budget_mb=0.001), Exception)
    assert msgs[0] == msgs[1]
    assert "rows-per-shard" in msgs[0] and "ceil(384/" in msgs[0]
    msgs = _errors(lambda: tload(src, mem_budget_mb=0.001),
                   lambda: jload(src, mem_budget_mb=0.001), Exception)
    assert msgs[0] == msgs[1] and "convert shards" in msgs[0]
    assert tload(sdir, mem_budget_mb=64)[0].shape == (384, 6)


def test_stream_budget_guard_matches_jax():
    kw = dict(n=1_000_000, d=784, rows_per_shard=65536, feat_dim=1024)
    msgs = _errors(lambda: tstream.check_stream_budget(1.0, **kw),
                   lambda: jstream.check_stream_budget(1.0, **kw),
                   Exception)
    assert msgs[0] == msgs[1] and "rows-per-shard <=" in msgs[0]
    tstream.check_stream_budget(512.0, n=1_000_000, d=784,
                                rows_per_shard=4096, feat_dim=1024)
    for mb, d in ((0.3, 24), (512.0, 784), (1e-6, 5)):
        assert (tstream.budget_admit_rows(mb, d)
                == jstream.budget_admit_rows(mb, d))


@pytest.mark.parametrize("kw", [dict(mem_budget_mb=0.0),
                                dict(mem_budget_mb=-1.0),
                                dict(on_bad_shard="skip")])
def test_config_fields_validate_as_jax(kw):
    msgs = _errors(lambda: SVMConfig(**kw).validate(),
                   lambda: JConfig(**kw).validate(), ValueError)
    assert msgs[0] == msgs[1]


# --- fit_approx_stream ----------------------------------------------------

def _kw(kind, **extra):
    return dict(solver=f"approx-{kind}", approx_dim=64, c=10.0,
                epsilon=5e-3, max_iter=800, chunk_iters=64, **extra)


def _svr_dir(tmp_path, x):
    rng = np.random.default_rng(1)
    t = (np.sin(x[:, 0]) + 0.1 * rng.standard_normal(len(x))).astype(
        np.float32)
    src = str(tmp_path / "reg.csv")
    save_csv(src, x, t)
    sdir = str(tmp_path / "reg")
    tstream.convert_to_shards(src, sdir, rows_per_shard=128,
                              float_labels=True)
    return t, sdir


@pytest.mark.parametrize("kind,task", [("rff", "svc"), ("nystrom", "svc"),
                                       ("rff", "svr"), ("nystrom", "svr")])
def test_stream_fit_matches_jax(tmp_path, kind, task):
    x, y = make_blobs(n=612, d=6, seed=3)
    xh, yh = x[512:], y[512:]
    x, y = x[:512], y[:512]
    if task == "svr":
        y, sdir = _svr_dir(tmp_path, x)
        kw = dict(_kw(kind), svr_epsilon=0.05)
    else:
        src = str(tmp_path / "s.csv")
        save_csv(src, x, y)
        sdir = str(tmp_path / "sh")
        tstream.convert_to_shards(src, sdir, rows_per_shard=128)
        kw = _kw(kind)
    mt, rt = tprimal.fit_approx_stream(tstream.ShardedDataset.open(sdir),
                                       SVMConfig(**kw), task=task,
                                       device=CPU)
    mj, rj = jprimal.fit_approx_stream(jstream.ShardedDataset.open(sdir),
                                       JConfig(**kw), task=task)
    assert rt.converged and rj.converged
    assert abs(rt.n_iter - rj.n_iter) <= max(2, 0.05 * rj.n_iter)
    for xs in (x, xh):
        dt = tmodel.decision_function(mt, xs, device=CPU)
        dj = np.asarray(jmodel.decision_function(mj, xs))
        assert float(np.max(np.abs(dt - dj))) < 5e-3
    if task == "svc":
        at = np.mean(np.where(tmodel.decision_function(
            mt, xh, device=CPU) < 0, -1, 1) == yh)
        aj = np.mean(np.where(np.asarray(jmodel.decision_function(
            mj, xh)) < 0, -1, 1) == yh)
        assert abs(at - aj) <= 1.0 / len(yh) + 1e-9 and at >= 0.95


def test_stream_steps_are_the_in_memory_full_batch_steps(tmp_path):
    """64 streamed steps against the port's in-memory full-batch steps
    with the streaming fit's step size over the same rows (n >= 2048, the
    full-batch regime), including a short shard."""
    x, y = make_blobs(n=2304, d=8, seed=4)
    src = str(tmp_path / "s.csv")
    save_csv(src, x, y)
    sdir = str(tmp_path / "sh")
    tstream.convert_to_shards(src, sdir, rows_per_shard=512)
    cfg = SVMConfig(solver="approx-rff", approx_dim=64, c=10.0,
                    epsilon=1e-9, max_iter=64, chunk_iters=32)
    ms, rs = tprimal.fit_approx_stream(tstream.ShardedDataset.open(sdir),
                                       cfg, device=CPU)
    assert rs.n_iter == 64 and tprimal.RUN["steps"] == 64
    lr = tprimal.RUN["lr"]
    fmap = build_feature_map("rff", x[:1], 64, 0, cfg.kernel_spec(8))
    prob = _in_memory_problem(x.astype(np.float32), y, cfg, fmap, lr)
    carry = tprimal.carry_to_device(tprimal.init_carry(65), CPU)
    step = tprimal.make_chunk_runner(carry, prob)
    _, st = step(carry, 64)
    w = tprimal.carry_to_host(step.carry).w
    assert st.n_iter == 64
    scale = max(1.0, float(np.max(np.abs(ms.w))))
    assert float(np.max(np.abs(w[:-1] - ms.w))) <= 1e-5 * scale
    assert abs(-float(w[-1]) - ms.b) <= 1e-5 * scale


@pytest.mark.parametrize("rows", [300, 150, 100, 64])
def test_read_ahead_at_any_shard_count(tmp_path, rows):
    """1, 2, 3 and 5 shards (the read-ahead window is at most one shard
    fewer than the shards): every shard read once a pass, in manifest
    order, and the same steps as the in-memory full-batch ones."""
    x, y, _src, sdir = _make(tmp_path, n=300, rows=rows, seed=5)
    cfg = SVMConfig(solver="approx-rff", approx_dim=32, c=10.0,
                    epsilon=1e-9, max_iter=16, chunk_iters=16)
    before = DataMetrics()._c_read.value
    ms, rs = tprimal.fit_approx_stream(tstream.ShardedDataset.open(sdir),
                                       cfg, device=CPU)
    shards = -(-300 // rows)
    reads = DataMetrics()._c_read.value - before
    # the prologue and 16 steps, and at most a window of reads ahead
    assert 17 * shards <= reads <= 17 * shards + max(1, shards - 1)
    lr = tprimal.RUN["lr"]
    fmap = build_feature_map("rff", x[:1], 32, 0, cfg.kernel_spec(6))
    prob = _in_memory_problem(x, y, cfg, fmap, lr)
    carry = tprimal.carry_to_device(tprimal.init_carry(33), CPU)
    step = tprimal.make_chunk_runner(carry, prob)
    step(carry, 16)
    w = tprimal.carry_to_host(step.carry).w
    assert rs.n_iter == 16
    assert float(np.max(np.abs(w[:-1] - ms.w))) <= 1e-5 * max(
        1.0, float(np.max(np.abs(ms.w))))


def test_poll_count_equals_an_in_memory_run(tmp_path):
    x, y, _src, sdir = _make(tmp_path, n=512, rows=128, seed=3)
    cfg = SVMConfig(solver="approx-rff", approx_dim=64, c=10.0,
                    epsilon=1e-9, max_iter=96, chunk_iters=32)
    counts = []
    for run in (lambda: tprimal.fit_approx_stream(
            tstream.ShardedDataset.open(sdir), cfg, device=CPU),
                lambda: tprimal.fit_approx(x, y, cfg, device=CPU)):
        tprimal.reset_counts()
        _, r = run()
        assert r.n_iter == 96
        counts.append(dict(tprimal.COUNTS))
    assert counts[0]["reads"] == counts[1]["reads"] == 3
    assert counts[0]["captures"] == counts[1]["captures"] == 0


def test_cut_at_a_checkpoint_resumes_bitwise_and_from_jax(tmp_path):
    """The port's cut-and-resume under a persistent corrupt shard
    (quarantined the same way both times) is bitwise its uncut run; a
    JAX checkpoint resumes in the port to the fit bar."""
    x, y, _src, sdir = _make(tmp_path, n=512, rows=64, seed=3)
    base = dict(solver="approx-rff", approx_dim=32, c=10.0, epsilon=1e-9,
                max_iter=64, chunk_iters=32, on_bad_shard="quarantine")
    tfault.install(tfault.FaultPlan(io_corrupt_shard=2))
    full, rf = tprimal.fit_approx_stream(tstream.ShardedDataset.open(sdir),
                                         SVMConfig(**base), device=CPU)
    assert any(e == "quarantine" and kw["shard"] == 1
               for e, kw in driver.EVENTS)
    ck = str(tmp_path / "ck.npz")
    tprimal.fit_approx_stream(
        tstream.ShardedDataset.open(sdir),
        SVMConfig(**dict(base, max_iter=32), checkpoint_path=ck,
                  checkpoint_every=32), device=CPU)
    res, rr = tprimal.fit_approx_stream(tstream.ShardedDataset.open(sdir),
                                        SVMConfig(resume_from=ck, **base),
                                        device=CPU)
    tfault.clear()
    assert rf.n_iter == rr.n_iter == 64
    np.testing.assert_array_equal(full.w, res.w)
    assert full.b == res.b
    assert any(e == "ingest_resume" and kw["n_iter"] == 32
               for e, kw in driver.EVENTS)
    jck = str(tmp_path / "j.npz")
    jb = {k: v for k, v in base.items() if k != "on_bad_shard"}
    jfull, _ = jprimal.fit_approx_stream(jstream.ShardedDataset.open(sdir),
                                         JConfig(**jb))
    jprimal.fit_approx_stream(jstream.ShardedDataset.open(sdir),
                              JConfig(**dict(jb, max_iter=32),
                                      checkpoint_path=jck,
                                      checkpoint_every=32))
    m, r = tprimal.fit_approx_stream(tstream.ShardedDataset.open(sdir),
                                     SVMConfig(resume_from=jck, **jb),
                                     device=CPU)
    assert r.n_iter == 64
    d = (tmodel.decision_function(m, x, device=CPU)
         - np.asarray(jmodel.decision_function(jfull, x)))
    assert float(np.max(np.abs(d))) < 5e-3


def test_init_w_warm_start_matches_jax(tmp_path):
    x, y, _src, sdir = _make(tmp_path, n=512, rows=128, seed=3)
    kw = _kw("rff")
    m0, _ = tprimal.fit_approx_stream(tstream.ShardedDataset.open(sdir),
                                      SVMConfig(**kw), device=CPU)
    w0 = tprimal.warm_start_vector(m0)
    mt, rt = tprimal.fit_approx_stream(tstream.ShardedDataset.open(sdir),
                                       SVMConfig(**kw), init_w=w0,
                                       device=CPU)
    mj, rj = jprimal.fit_approx_stream(jstream.ShardedDataset.open(sdir),
                                       JConfig(**kw), init_w=w0)
    assert rt.n_iter == rj.n_iter and rt.n_iter < 64
    d = (tmodel.decision_function(mt, x, device=CPU)
         - np.asarray(jmodel.decision_function(mj, x)))
    assert float(np.max(np.abs(d))) < 5e-3


@pytest.mark.parametrize("kw,task,exc", [
    (dict(solver="exact"), "svc", ValueError),
    (dict(solver="approx-rff", shards=2), "svc", ValueError),
    (dict(solver="approx-rff"), "oneclass", ValueError),
])
def test_refusals_match_jax(tmp_path, kw, task, exc):
    _x, _y, _src, sdir = _make(tmp_path)
    msgs = _errors(
        lambda: tprimal.fit_approx_stream(tstream.ShardedDataset.open(sdir),
                                          SVMConfig(**kw), task=task,
                                          device=CPU),
        lambda: jprimal.fit_approx_stream(jstream.ShardedDataset.open(sdir),
                                          JConfig(**kw), task=task), exc)
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("how", ["argument", "config"])
def test_live_is_refused_naming_its_item(tmp_path, how):
    _x, _y, _src, sdir = _make(tmp_path)
    ds = tstream.ShardedDataset.open(sdir)
    with pytest.raises(NotImplementedError, match="item 10c"):
        if how == "argument":
            tprimal.fit_approx_stream(ds, SVMConfig(solver="approx-rff"),
                                      live=True, device=CPU)
        else:
            tprimal.fit_approx_stream(
                ds, SVMConfig(solver="approx-rff", live=True), device=CPU)


def test_raise_policy_fails_fast(tmp_path):
    _x, _y, _src, sdir = _make(tmp_path)
    _corrupt(sdir, 0)
    with pytest.raises(tstream.ShardCorruptError, match="shard 0"):
        tprimal.fit_approx_stream(
            tstream.ShardedDataset.open(sdir),
            SVMConfig(solver="approx-rff", approx_dim=32, max_iter=32),
            device=CPU)


# --- fit_cascade_stream ---------------------------------------------------

def test_stream_cascade_matches_jax_under_budget(tmp_path, capsys):
    x, y = make_blobs(n=1000, d=16, seed=7)
    src = str(tmp_path / "data.csv")
    save_csv(src, x, y)
    sdir = str(tmp_path / "shards")
    tstream.convert_to_shards(src, sdir, rows_per_shard=100)
    budget = 0.05                      # MiB; the full (x, y) needs ~0.065
    with pytest.raises(tstream.MemBudgetError):
        tstream.ShardedDataset.open(sdir).materialize(mem_budget_mb=budget)
    kw = dict(solver="cascade", approx_dim=64, c=5.0, gamma=1.0 / 16,
              epsilon=1e-3, max_iter=200_000, mem_budget_mb=budget)
    mt, rt = tcs.fit_cascade_stream(tstream.ShardedDataset.open(sdir),
                                    SVMConfig(**kw), device=CPU)
    err = capsys.readouterr().err
    assert "screened subproblem" in err and "fits --mem-budget-mb" in err
    mj, rj = jcs.fit_cascade_stream(jstream.ShardedDataset.open(sdir),
                                    JConfig(**kw))
    for r in (rt, rj):
        assert r.converged and r.kkt_violators == 0
        assert r.n_kept < r.n_total == 1000
        assert tstream.materialize_bytes(r.n_kept, 16) <= budget * 2 ** 20
    assert len(rt.alpha) == rt.n_kept
    assert abs(rt.n_kept - rj.n_kept) <= 0.01 * rj.n_kept
    assert abs(mt.n_sv - mj.n_sv) <= max(3, 0.02 * mj.n_sv)
    from dpsvm_tpu.models.svm import decision_function as jdec
    from dpsvm_tpu_torch.models.svm import decision_function as tdec
    at = np.mean(np.where(tdec(mt, x, device=CPU) < 0, -1, 1) == y)
    aj = np.mean(np.where(np.asarray(jdec(mj, x)) < 0, -1, 1) == y)
    assert abs(at - aj) <= 1.0 / len(y) + 1e-9


def test_screen_cap_is_tightened_by_the_budget():
    for kw in (dict(), dict(screen_cap=50), dict(mem_budget_mb=0.01),
               dict(screen_cap=10_000, mem_budget_mb=0.01)):
        cfg_t = SVMConfig(solver="cascade", **kw)
        cfg_j = JConfig(solver="cascade", **kw)
        assert tcs._screen_cap(cfg_t, 24) == jcs._screen_cap(cfg_j, 24)


@pytest.mark.parametrize("kw", [dict(solver="approx-rff"),
                                dict(solver="cascade", shards=2)])
def test_stream_cascade_refusals_match_jax(tmp_path, kw):
    _x, _y, _src, sdir = _make(tmp_path)
    msgs = _errors(
        lambda: tcs.fit_cascade_stream(tstream.ShardedDataset.open(sdir),
                                       SVMConfig(**kw), device=CPU),
        lambda: jcs.fit_cascade_stream(jstream.ShardedDataset.open(sdir),
                                       JConfig(**kw)), ValueError)
    assert msgs[0] == msgs[1]


# --- CLI and selfcheck ----------------------------------------------------

def _cli(main, args):
    out = StringIO()
    with redirect_stdout(out):
        rc = main(args)
    return rc, out.getvalue()


def test_cli_convert_train_test_on_shards(tmp_path):
    x, y = make_blobs(n=400, d=6, seed=2)
    src = str(tmp_path / "t.csv")
    save_csv(src, x, y)
    got = {}
    for tag, main, dev in (("t", tmain, ["--device", "cpu"]),
                           ("j", jmain, [])):
        sdir = str(tmp_path / f"sh{tag}")
        rc, out = _cli(main, ["convert", "shards", src, sdir,
                              "--rows-per-shard", "128"])
        assert rc == 0 and "as 4 shard(s) of 128 rows" in out
        lines = [out.replace(sdir, "DIR")]
        # the streaming cascade is held to JAX's in-process above
        solvers = ((("approx-rff", "m.npz"), ("exact", "e.svm"))
                   + ((("cascade", "c.svm"),) if tag == "t" else ()))
        for solver, model in solvers:
            mp = str(tmp_path / f"{tag}{model}")
            rc, out = _cli(main, ["train", "-f", sdir, "-m", mp,
                                  "--solver", solver, "--approx-dim", "64",
                                  "-c", "10", "-e", "0.005",
                                  "--mem-budget-mb", "64", "-q", *dev]
                           if solver != "exact" else
                           ["train", "-f", sdir, "-m", mp, "-c", "10",
                            "-q", *dev])
            assert rc == 0, (tag, solver, out)
            acc = [ln for ln in out.splitlines() if "accuracy" in ln]
            rc, tout = _cli(main, ["test", "-f", sdir, "-m", mp, *dev])
            assert rc == 0
            lines.append((solver, acc, [ln for ln in tout.splitlines()
                                        if ln.startswith("Test accuracy")]))
        got[tag] = lines
    assert got["t"][0] == got["j"][0]
    for (st, at, tt), (sj, aj, tj) in zip(got["t"][1:], got["j"][1:]):
        assert st == sj and tt == tj and len(at) == len(aj) == 1
    assert got["t"][-1][0] == "cascade" and got["t"][-1][2]


def test_cli_refusals_are_one_line(tmp_path, capsys):
    x, y, src, sdir = _make(tmp_path)
    _corrupt(sdir, 0)
    for args in (["train", "-f", src, "-m", str(tmp_path / "m.svm"),
                  "--mem-budget-mb", "0.001", "-q"],
                 ["train", "-f", sdir, "-m", str(tmp_path / "m.npz"),
                  "--solver", "approx-rff", "-q"]):
        got = []
        for main, extra in ((tmain, ["--device", "cpu"]), (jmain, [])):
            rc = main(args + extra)
            got.append((rc, capsys.readouterr().err.strip().splitlines()
                        [-1]))
        assert got[0] == got[1] and got[0][0] == 2, got


def test_cli_scale_and_convert_libsvm_match_jax(tmp_path):
    x, y = make_blobs(n=60, d=5, seed=1)
    lib = str(tmp_path / "d.libsvm")
    _libsvm_source(lib, x, y)
    outs = {}
    for tag, main in (("t", tmain), ("j", jmain)):
        dst, rng = str(tmp_path / f"{tag}.csv"), str(tmp_path / f"{tag}.r")
        rc1, o1 = _cli(main, ["scale", lib, dst, "-l", "0", "-s", rng])
        csv = str(tmp_path / f"{tag}c.csv")
        rc2, o2 = _cli(main, ["convert", "libsvm", lib, csv])
        o1 = o1.replace(dst, "DST").replace(rng, "RNG")
        outs[tag] = (rc1, rc2, o1, o2.replace(csv, "CSV"),
                     *(Path(p).read_bytes() for p in (dst, rng, csv)))
    assert outs["t"] == outs["j"]


def test_data_selfcheck(tmp_path):
    from dpsvm_tpu_torch.data import selfcheck
    assert selfcheck(str(tmp_path), device="cpu") == []


def test_data_selfcheck_module_runs_on_the_cpu():
    p = subprocess.run([sys.executable, "-m", "dpsvm_tpu_torch.data",
                        "--selfcheck", "--device", "cpu"],
                       cwd=str(ROOT), capture_output=True, text=True,
                       timeout=300, env=dict(os.environ,
                                             OMP_NUM_THREADS="1"))
    assert p.returncode == 0, p.stderr
    assert "data selfcheck OK" in p.stdout

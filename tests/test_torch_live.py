"""The port's live shard log (``dpsvm_tpu_torch/data/live.py``) and live
streaming training (``approx.primal.fit_approx_stream(live=True)``) on
the CPU, against the JAX package's ``dpsvm_tpu/data/live.py`` and its
live fit.

Bars, and why:

* the append protocol is shared: for the same appends both packages
  publish the same manifest, byte for byte, with the same
  ``manifest_crc``, and each package's watcher admits a log the other
  appended to;
* the reader rules and the fault knobs behave as JAX's: a torn publish is
  held and repaired by the next append, a stale generation is refused, a
  rewritten prefix is refused, a crash before the publish leaves an
  orphan the next append overwrites; a SIGKILLed writer process never
  makes the watcher regress or admit an unreadable shard;
* the live fit against JAX's live fit on the same log: the same admitted
  generation and shard set, n_iter within 5%, decisions within 5e-3 (the
  streaming bar of ``tests/test_torch_stream.py``: the two reduce in
  different orders);
* against the port's own runs: a live fit reads the packed stats exactly
  as often as a frozen fit at the same budget; the read-ahead never reads
  past the admitted shard list and each pass reads in manifest order;
  a run cut at a checkpoint after an admission resumes bitwise;
* the CLI's ``train --live`` admits the shards a writer subprocess
  appends while it trains.
"""

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
from dpsvm_tpu.config import SVMConfig as JConfig
from dpsvm_tpu.data import live as jlive
from dpsvm_tpu.data import stream as jstream
from dpsvm_tpu.data.synthetic import make_blobs, save_csv
from dpsvm_tpu.resilience import faultinject as jfault
from dpsvm_tpu_torch.approx import model as tmodel
from dpsvm_tpu_torch.approx import primal as tprimal
from dpsvm_tpu_torch.cli import main as tmain
from dpsvm_tpu_torch.config import SVMConfig
from dpsvm_tpu_torch.data import live as tlive
from dpsvm_tpu_torch.data import stream as tstream
from dpsvm_tpu_torch.resilience import faultinject as tfault
from dpsvm_tpu_torch.solver import driver

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the small eager steps (the tier-1 run puts
    six workers on the cores)."""
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


def _make_log(tmp_path, n=256, d=4, rows=64, seed=7, name="log"):
    x, y = make_blobs(n=n, d=d, seed=seed)
    src = str(tmp_path / f"src_{name}.csv")
    save_csv(src, x, y)
    ldir = str(tmp_path / name)
    tstream.convert_to_shards(src, ldir, rows_per_shard=rows)
    return x.astype(np.float32), np.asarray(y), ldir


def _blob_rows(n, d, seed):
    x, y = make_blobs(n=n, d=d, seed=seed)
    return x.astype(np.float32), np.asarray(y, np.int32)


def _manifest_bytes(ldir):
    return Path(ldir, tstream.MANIFEST_NAME).read_bytes()


def _cfg(**over):
    base = dict(solver="approx-rff", approx_dim=32, c=10.0, epsilon=1e-9,
                max_iter=64, chunk_iters=32)
    base.update(over)
    return base


# --- the append protocol, both ways ----------------------------------------

def test_appends_publish_the_same_bytes_as_jax(tmp_path):
    _x, _y, tdir = _make_log(tmp_path, name="t")
    _x, _y, jdir = _make_log(tmp_path, name="j")
    assert _manifest_bytes(tdir) == _manifest_bytes(jdir)
    for s, rows in ((11, 64), (12, 20), (13, 64)):
        xa, ya = _blob_rows(rows, 4, seed=s)
        mt = tlive.append_shard(tdir, xa, ya)
        mj = jlive.append_shard(jdir, xa, ya)
        assert mt == mj
        assert _manifest_bytes(tdir) == _manifest_bytes(jdir)
        assert (Path(tdir, tlive.PREV_MANIFEST_NAME).read_bytes()
                == Path(jdir, jlive.PREV_MANIFEST_NAME).read_bytes())
        assert tlive.manifest_crc(mt) == jlive.manifest_crc(mj)
    assert mt["generation"] == 3 and mt["n"] == 256 + 148
    ds = tstream.ShardedDataset.open(tdir)
    assert ds.generation == 3 and ds.row_offset(5) == 256 + 64
    got = ds.gather_rows(np.array([0, 256 + 64 + 5, 256 + 84 + 3]))
    np.testing.assert_array_equal(got[1], _blob_rows(20, 4, 12)[0][5])
    np.testing.assert_array_equal(got[2], _blob_rows(64, 4, 13)[0][3])


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_watcher_admits_the_other_packages_log(tmp_path, writer):
    _x, _y, ldir = _make_log(tmp_path)
    t_ds = tstream.ShardedDataset.open(ldir)
    j_ds = jstream.ShardedDataset.open(ldir)
    t_ev, j_ev = [], []
    tw = tlive.ShardLogWatcher(t_ds, on_event=lambda e, **k: t_ev.append(
        (e, k)))
    jw = jlive.ShardLogWatcher(j_ds, on_event=lambda e, **k: j_ev.append(
        (e, k)))
    append = (tlive if writer == "port" else jlive).append_shard
    for s in (21, 22):
        append(ldir, *_blob_rows(64, 4, s))
    assert tw.poll() == jw.poll() == [4, 5]
    assert t_ds.generation == j_ds.generation == 2
    assert t_ds.n == j_ds.n == 384 and t_ds.shards == j_ds.shards
    assert t_ev == j_ev and [k["shard"] for _, k in t_ev] == [4, 5]
    assert tw.admitted_rows == jw.admitted_rows == 128
    assert tw.poll() == [] and t_ds.generation == 2


def test_pinned_views_and_admission_match_jax(tmp_path):
    _x, _y, ldir = _make_log(tmp_path)
    for s in (31, 32, 33):
        tlive.append_shard(ldir, *_blob_rows(64, 4, s))
    m = tlive.read_manifest_checked(ldir)
    for g in (0, 1, 2, 3, 9):
        assert (tstream.pin_manifest_generation(m, g)
                == jstream.pin_manifest_generation(m, g))
        ds = tstream.ShardedDataset.open(ldir, at_generation=g)
        assert ds.generation == min(g, 3) and ds.n == 256 + 64 * min(g, 3)
    ds = tstream.ShardedDataset.open(ldir, at_generation=1)
    assert ds.admit_manifest(m) == [5, 6] and ds.n == 448
    with pytest.raises(tstream.StreamError, match="does not advance"):
        ds.admit_manifest(m)
    # a rewritten prefix is a corrupted log, refused as JAX refuses it
    ds = tstream.ShardedDataset.open(ldir, at_generation=1)
    bad = json.loads(json.dumps(m))
    bad["shards"][1]["crc32"] ^= 1
    with pytest.raises(tstream.StreamError, match="REWROTE shard 1"):
        ds.admit_manifest(bad)
    jds = jstream.ShardedDataset.open(ldir, at_generation=1)
    with pytest.raises(jstream.StreamError, match="REWROTE shard 1"):
        jds.admit_manifest(bad)


def test_append_geometry_and_finiteness_rejected_as_jax(tmp_path):
    _x, _y, ldir = _make_log(tmp_path)
    xa, ya = _blob_rows(64, 4, 41)
    cases = [(np.zeros((3, 5), np.float32), np.ones(3, np.int32)),
             (np.zeros((65, 4), np.float32), np.ones(65, np.int32)),
             (xa, ya[:10])]
    nan = xa.copy()
    nan[3, 2] = np.nan
    cases.append((nan, ya))
    for x, y in cases:
        msgs = []
        for mod in (tlive, jlive):
            with pytest.raises(ValueError) as e:
                mod.append_shard(ldir, x, y)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    assert tstream.ShardedDataset.open(ldir).generation == 0


# --- the reader rules under the fault knobs --------------------------------

def test_torn_publish_is_held_then_repaired(tmp_path):
    x, y, ldir = _make_log(tmp_path)
    ds = tstream.ShardedDataset.open(ldir)
    w = tlive.ShardLogWatcher(ds)
    tfault.install(tfault.FaultPlan(live_torn_publish=1))
    with pytest.raises(tlive.WriterCrashError, match="torn"):
        tlive.append_shard(ldir, x[:64], y[:64])
    tfault.clear()
    assert w.poll() == [] and w.torn_observed == 1 and ds.generation == 0
    with pytest.raises(tlive.TornPublishError):
        tstream.ShardedDataset.open(ldir)
    with pytest.raises(jlive.TornPublishError):
        jlive.read_manifest_checked(ldir)
    # the restarted writer (here JAX's) recovers from .prev and repairs
    jlive.append_shard(ldir, x[64:128], y[64:128])
    assert w.poll() == [4] and ds.generation == 1 and ds.n == 320
    np.testing.assert_array_equal(ds.read_shard(4)[0], x[64:128])


def test_stale_generation_is_refused_and_superseded(tmp_path):
    x, y, ldir = _make_log(tmp_path)
    ds = tstream.ShardedDataset.open(ldir)
    w = tlive.ShardLogWatcher(ds)
    tlive.append_shard(ldir, x[:64], y[:64])
    assert w.poll() == [4]
    tfault.install(tfault.FaultPlan(live_stale_generation=1))
    m = tlive.append_shard(ldir, x[64:96], y[64:96])
    tfault.clear()
    assert m["generation"] == 1 and len(m["shards"]) == 6
    assert w.poll() == [] and w.stale_observed == 1 and ds.n == 320
    tlive.append_shard(ldir, x[96:100], y[96:100])
    assert w.poll() == [5, 6] and ds.generation == 2 and ds.n == 356


def test_writer_crash_leaves_an_orphan_the_next_append_rewrites(tmp_path):
    x, y, ldir = _make_log(tmp_path)
    tfault.install(tfault.FaultPlan(live_writer_crash_after=1))
    with pytest.raises(tlive.WriterCrashError, match="before its publish"):
        tlive.append_shard(ldir, x[:64], y[:64])
    tfault.clear()
    assert os.path.exists(os.path.join(ldir, tstream.shard_filename(4)))
    assert tstream.ShardedDataset.open(ldir).n_shards == 4
    m = tlive.append_shard(ldir, x[64:80], y[64:80])
    assert m["shards"][4]["rows"] == 16
    ds = tstream.ShardedDataset.open(ldir)
    np.testing.assert_array_equal(ds.read_shard(4)[0], x[64:80])


def test_live_and_serve_knobs_parse_from_env(monkeypatch):
    for knob, field in (("LIVE_TORN_PUBLISH", "live_torn_publish"),
                        ("LIVE_STALE_GENERATION", "live_stale_generation"),
                        ("LIVE_WRITER_CRASH_AFTER",
                         "live_writer_crash_after"),
                        ("LIVE_SHIFT_AT_SHARD", "live_shift_at_shard"),
                        ("SERVE_FAIL_RELOAD", "serve_fail_reload")):
        tfault.clear()
        monkeypatch.setenv(f"DPSVM_FAULT_{knob}", "2")
        plan = tfault.current()
        assert plan is not None and getattr(plan, field) == 2
        monkeypatch.delenv(f"DPSVM_FAULT_{knob}")
    tfault.clear()
    assert tfault.current() is None


def test_admission_across_hosts_raises_naming_its_item(tmp_path,
                                                       monkeypatch):
    # Admission across hosts is the host group's barrier (ROADMAP item
    # 13b, ported): a host commits only the generation every member of
    # its group has published, so an append waits for the peer.
    from dpsvm_tpu_torch.resilience import hostgroup
    _x, _y, ldir = _make_log(tmp_path)
    ds = tstream.ShardedDataset.open(ldir)
    w = tlive.ShardLogWatcher(ds)
    gen0 = ds.generation
    tlive.append_shard(ldir, *_blob_rows(64, 4, 51))
    hb = str(tmp_path / "hb")
    monkeypatch.setenv(hostgroup.ENV_HEARTBEAT_DIR, hb)
    monkeypatch.setenv(hostgroup.ENV_HOST_ID, "0")
    monkeypatch.setenv(hostgroup.ENV_HOST_COUNT, "2")
    monkeypatch.setattr(hostgroup, "_STATE",
                        {"n_iter": 0, "generation": 0, "seq": 0})
    assert w.poll() == [] and ds.generation == gen0   # peer 1 silent
    hostgroup.write_heartbeat(hb, 1, n_iter=0, generation=gen0 + 1)
    assert len(w.poll()) == 1 and ds.generation == gen0 + 1


def test_sigkilled_writer_process_never_regresses_the_watcher(tmp_path):
    _x, _y, ldir = _make_log(tmp_path, rows=16, n=64)
    ds = tstream.ShardedDataset.open(ldir)
    w = tlive.ShardLogWatcher(ds)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "dpsvm_tpu_torch.data.live", ldir,
         "--append", "500", "--rows", "16", "--seed", "5",
         "--interval-ms", "2"], cwd=str(ROOT), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL)
    gens = []
    deadline = time.time() + 60
    try:
        while ds.generation < 3 and time.time() < deadline:
            w.poll()
            gens.append(ds.generation)
            time.sleep(0.002)
        proc.send_signal(signal.SIGKILL)
    finally:
        proc.wait(30)
    assert ds.generation >= 3, "writer never advanced the log"
    for _ in range(5):
        w.poll()
        gens.append(ds.generation)
    assert gens == sorted(gens)
    for k in range(ds.n_shards):
        assert ds.read_shard_checked(k) is not None
    gen_before = ds.generation
    r = subprocess.run(
        [sys.executable, "-m", "dpsvm_tpu_torch.data.live", ldir,
         "--append", "2", "--rows", "16", "--seed", "6"], cwd=str(ROOT),
        env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.count("APPENDED") == 2
    w.poll()
    assert ds.generation >= gen_before + 2
    assert ds.read_shard_checked(ds.n_shards - 1) is not None


# --- live streaming training -----------------------------------------------

def test_live_fit_matches_jax_live_fit(tmp_path):
    x, y, ldir = _make_log(tmp_path, seed=9)
    extra = [_blob_rows(64, 4, s) for s in (61, 62)]
    for xa, ya in extra:
        tlive.append_shard(ldir, xa, ya)
    kw = _cfg(epsilon=5e-3, max_iter=800, chunk_iters=64)
    t_ds = tstream.ShardedDataset.open(ldir, at_generation=0)
    mt, rt = tprimal.fit_approx_stream(t_ds, SVMConfig(**kw), live=True,
                                       device=CPU)
    j_ds = jstream.ShardedDataset.open(ldir, at_generation=0)
    mj, rj = jprimal.fit_approx_stream(j_ds, JConfig(**kw), live=True)
    assert t_ds.generation == j_ds.generation == 2
    assert t_ds.shards == j_ds.shards and t_ds.n == j_ds.n == 384
    assert tprimal.RUN["divisor"] == 384
    assert rt.converged and rj.converged
    assert abs(rt.n_iter - rj.n_iter) <= 0.05 * rj.n_iter, (rt.n_iter,
                                                            rj.n_iter)
    xall = np.concatenate([x] + [a for a, _ in extra])
    d = (tmodel.decision_function(mt, xall, device=CPU)
         - np.asarray(jmodel.decision_function(mj, xall)))
    assert float(np.max(np.abs(d))) < 5e-3


def test_live_fit_polls_as_often_as_a_frozen_fit(tmp_path):
    _x, _y, ldir = _make_log(tmp_path)
    for s in (61, 62):
        tlive.append_shard(ldir, *_blob_rows(64, 4, s))
    counts = []
    ds_live = tstream.ShardedDataset.open(ldir, at_generation=0)
    for ds, live in ((tstream.ShardedDataset.open(ldir), False),
                     (ds_live, True)):
        tprimal.reset_counts()
        _m, r = tprimal.fit_approx_stream(ds, SVMConfig(**_cfg()),
                                          live=live, device=CPU)
        assert r.n_iter == 64
        counts.append(dict(tprimal.COUNTS))
    assert ds_live.generation == 2
    assert counts[0] == counts[1] and counts[0]["reads"] == 2
    assert counts[0]["captures"] == 0
    admits = [kw for e, kw in driver.EVENTS if e == "append_admitted"]
    assert {(kw["shard"], kw["generation"]) for kw in admits} == {(4, 1),
                                                                  (5, 2)}
    grows = [kw for e, kw in driver.EVENTS if e == "ingest_grow"]
    assert [(g["generation"], g["n_new_rows"]) for g in grows] == [(2, 128)]


class _OneGenerationWatcher(tlive.ShardLogWatcher):
    """Admits at most one more generation a poll, so a run over a log
    that already holds its appends grows at several sweep boundaries."""

    def poll(self):
        m = tlive.read_manifest_checked(self.ds.directory)
        if int(m.get("generation", 0)) <= self.ds.generation:
            return []
        return self.ds.admit_manifest(tstream.pin_manifest_generation(
            m, self.ds.generation + 1))


def test_read_ahead_never_passes_the_admitted_list(tmp_path, monkeypatch):
    """Growth at four boundaries: every read is of an admitted shard
    (checked when the read starts, on the worker thread), each pass reads
    the admitted shards once in manifest order, and the fit equals the
    one whose watcher grew the view the same way."""
    _x, _y, ldir = _make_log(tmp_path, rows=32)
    for s in (71, 72, 73, 74):
        tlive.append_shard(ldir, *_blob_rows(32, 4, s))
    ds = tstream.ShardedDataset.open(ldir, at_generation=0)
    reads, bad = [], []
    real = ds.read_shard_checked

    def spy(k, **kw):
        if k >= ds.n_shards:
            bad.append((k, ds.n_shards))
        reads.append(k)
        return real(k, **kw)

    monkeypatch.setattr(ds, "read_shard_checked", spy)
    cfg = SVMConfig(**_cfg(max_iter=8, chunk_iters=4))
    m1, _ = tprimal.fit_approx_stream(
        ds, cfg, watcher=_OneGenerationWatcher(ds), device=CPU, live=True)
    assert not bad and ds.generation == 4
    assert tprimal.RUN["admissions"] == 4
    assert [n for n, _t in tprimal.RUN["step_walls"]] == [9, 10, 11, 12,
                                                          12, 12, 12, 12]
    ds2 = tstream.ShardedDataset.open(ldir, at_generation=0)
    m2, _ = tprimal.fit_approx_stream(
        ds2, cfg, watcher=_OneGenerationWatcher(ds2), device=CPU, live=True)
    np.testing.assert_array_equal(m1.w, m2.w)
    with pytest.raises(ValueError, match="SAME ShardedDataset"):
        tprimal.fit_approx_stream(ds2, cfg, live=True, device=CPU,
                                  watcher=_OneGenerationWatcher(ds))


def test_a_cut_after_an_admission_resumes_bitwise(tmp_path):
    _x, _y, ldir = _make_log(tmp_path, rows=32)
    for s in (81, 82, 83):
        tlive.append_shard(ldir, *_blob_rows(32, 4, s))
    cfg = _cfg(max_iter=12, chunk_iters=4)

    def run(**extra):
        ds = tstream.ShardedDataset.open(ldir, at_generation=0)
        m, r = tprimal.fit_approx_stream(
            ds, SVMConfig(**dict(cfg, **extra)), live=True, device=CPU,
            watcher=_OneGenerationWatcher(ds))
        return m, r, ds

    full, rf, _ = run()
    ck = str(tmp_path / "ck.npz")
    _m, rc, dsc = run(max_iter=4, checkpoint_path=ck, checkpoint_every=4)
    assert rc.n_iter == 4 and dsc.generation == 3
    res, rr, dsr = run(resume_from=ck)
    assert rf.n_iter == rr.n_iter == 12 and dsr.generation == 3
    np.testing.assert_array_equal(full.w, res.w)
    assert full.b == res.b
    assert any(e == "ingest_resume" and kw["generation"] == 3
               for e, kw in driver.EVENTS)
    with pytest.raises(ValueError, match="live"):
        tprimal.fit_approx_stream(
            tstream.ShardedDataset.open(ldir, at_generation=0),
            SVMConfig(**dict(cfg, resume_from=ck)), device=CPU)


def test_cli_train_live_admits_a_writers_shards_mid_run(tmp_path,
                                                        monkeypatch):
    _x, _y, ldir = _make_log(tmp_path, rows=32)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "dpsvm_tpu_torch.data.live", ldir,
         "--append", "6", "--rows", "32", "--seed", "9",
         "--interval-ms", "40"], cwd=str(ROOT), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    model = str(tmp_path / "m.npz")
    buf = StringIO()
    try:
        assert proc.stdout.readline().startswith("APPENDED 8 generation 1")
        # slow every shard read a little so the run outlasts the writer
        monkeypatch.setenv("DPSVM_FAULT_IO_SLOW_READ_MS", "1")
        tfault.clear()
        with redirect_stdout(buf):
            rc = tmain(["train", "-f", ldir, "-m", model, "--solver",
                        "approx-rff", "--approx-dim", "32", "-c", "10",
                        "-e", "1e-9", "--max-iter", "300", "--live",
                        "--device", "cpu", "-q"])
    finally:
        proc.wait(60)
    assert rc == 0
    line = [s for s in buf.getvalue().splitlines()
            if s.startswith("Live log")]
    assert line, buf.getvalue()
    g0, g1 = (int(v) for v in line[0].split("generation ")[1].split(
        " (")[0].split(" -> "))
    assert g0 >= 1 and g1 > g0, line
    assert os.path.exists(model)

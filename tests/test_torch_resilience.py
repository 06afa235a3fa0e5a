"""The port's training resilience held to the JAX package's: the health
monitor's reasons, a NaN gap raising at the same iteration, rollback and
ignore on the fused pair, the general pair, the decomposition and the
approx primal chunk with the JAX run's event sequence (names and n_iter)
and the port's own uninterrupted run's state bitwise, the rollback budget,
the checkpoint-write fault, preemption (a real SIGTERM, the injected
fault, pipelined mode) and the supervised resume, the corrupt-slot
fallback's ``rollback`` event and a resume onto another mesh's ``reshard``
event, the host-loss markers' ``host_lost``/``reform`` events,
``debug_nans``, every hook on a fault-free run (bitwise, the same reads),
the stall watchdog's exit 124, the environment's fault plan, the CLI's
flags and the selfcheck.

Both packages run the same seeded problems with the same ``FaultPlan``;
the JAX package on the CPU (its kernels in interpret mode or their plain
reference, as its own tests run them). Models are compared at the bar of
the trace tests (b within 1e-4, n_iter equal) across packages, bitwise
within the port.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from dpsvm_tpu.data.synthetic import make_blobs
from torch_threads import one_thread  # noqa: F401

B_TOL = 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_faults():
    from dpsvm_tpu.resilience import faultinject as jfi
    from dpsvm_tpu_torch.resilience import faultinject as tfi
    jfi.clear()
    tfi.clear()
    yield
    jfi.clear()
    tfi.clear()


@pytest.fixture(scope="module")
def blobs():
    return make_blobs(n=200, d=5, seed=5)


def _cfgs(**kw):
    """The same config in both packages (epsilon far below float32
    resolution: every run spends its max_iter budget)."""
    from dpsvm_tpu.config import SVMConfig as JC
    from dpsvm_tpu_torch.config import SVMConfig as TC
    kw.setdefault("c", 1.0)
    kw.setdefault("gamma", 0.5)
    kw.setdefault("epsilon", 1e-12)
    kw.setdefault("chunk_iters", 25)
    kw.setdefault("max_iter", 300)
    return JC(**kw), TC(**kw)


def _events(path):
    with open(path) as fh:
        recs = [json.loads(line) for line in fh if line.strip()]
    return [(r["event"], r["n_iter"]) for r in recs
            if r.get("kind") == "event"]


def _jtrain(x, y, cfg, plan=None):
    from dpsvm_tpu import api
    from dpsvm_tpu.resilience import faultinject
    if plan is None:            # the caller's plan, if any, stays
        return api.train(x, y, cfg)
    faultinject.install(plan)
    try:
        return api.train(x, y, cfg)
    finally:
        faultinject.clear()


def _ttrain(x, y, cfg, plan=None):
    from dpsvm_tpu_torch import api
    from dpsvm_tpu_torch.resilience import faultinject
    if plan is None:            # the caller's plan, if any, stays
        return api.train(x, y, cfg, device="cpu")
    faultinject.install(plan)
    try:
        return api.train(x, y, cfg, device="cpu")
    finally:
        faultinject.clear()


def _plans(**kw):
    from dpsvm_tpu.resilience import faultinject as jfi
    from dpsvm_tpu_torch.resilience import faultinject as tfi
    return jfi.FaultPlan(**kw), tfi.FaultPlan(**kw)


PATHS = {
    "fused": {},
    "general": dict(selection="second-order"),
    "decomp": dict(working_set=8),
}


# ---------------------------------------------------------------------
# the health monitor and the NaN guard

@pytest.mark.parametrize("window, seq", [
    (0, [(50, 1.0, -1.0, 10), (100, float("nan"), -1.0, 10),
         (150, float("nan"), -1.0, 10)]),
    (100, [(50, 2.0, 0.0, 0), (100, 1.0, 0.0, 0), (150, 1.0, 0.0, 0),
           (200, 1.0, 0.0, 0), (250, 1.0, 0.0, 0)]),
    (1000, [(50, 1.0, -1.0, 100), (100, 1.0, -1.0, 5)]),
    (0, [(50, 1.0, -1.0, 100), (100, 1.0, -1.0, 5)]),
])
def test_health_monitor_reasons_match_jax(window, seq):
    from dpsvm_tpu.resilience.health import HealthMonitor as JM
    from dpsvm_tpu_torch.resilience.health import HealthMonitor as TM
    jm, tm = JM(window=window), TM(window=window)
    for n_iter, b_lo, b_hi, n_sv in seq:
        kw = dict(n_iter=n_iter, b_lo=b_lo, b_hi=b_hi, n_sv=n_sv)
        assert tm.check(**kw) == jm.check(**kw)
    with pytest.raises(ValueError, match="on_divergence"):
        TM(policy="explode")


def test_max_rollbacks_bounded():
    from dpsvm_tpu.resilience.health import MAX_ROLLBACKS as JMAX
    from dpsvm_tpu_torch.resilience.health import (MAX_ROLLBACKS,
                                                   HealthMonitor)
    assert MAX_ROLLBACKS == JMAX
    m = HealthMonitor(policy="rollback")
    for i in range(MAX_ROLLBACKS):
        assert not m.exhausted
        m.note_rollback(100 * i)
    assert m.exhausted


@pytest.mark.parametrize("path", sorted(PATHS))
def test_nan_raises_at_the_same_iteration(tmp_path, blobs, path):
    from dpsvm_tpu.resilience.health import DivergenceError as JD
    from dpsvm_tpu_torch.resilience.health import DivergenceError as TD
    x, y = blobs
    jp, tp = _plans(nan_at_iter=100)
    jc, tc = _cfgs(trace_out=str(tmp_path / "j.jsonl"), **PATHS[path])
    tc = dataclasses.replace(tc, trace_out=str(tmp_path / "t.jsonl"))
    with pytest.raises(JD) as je:
        _jtrain(x, y, jc, jp)
    with pytest.raises(TD, match="non-finite") as te:
        _ttrain(x, y, tc, tp)
    assert te.value.n_iter == je.value.n_iter
    assert _events(tmp_path / "t.jsonl") == _events(tmp_path / "j.jsonl")
    assert ("divergence", te.value.n_iter) in _events(tmp_path / "t.jsonl")


# ---------------------------------------------------------------------
# rollback and ignore on every path

def _reference(x, y, tc, tmp_path, path, rollback_events):
    """The port's own uninterrupted run: straight for the pairs; for the
    decomposition the prefix saved at the restored iteration and resumed
    at the halved chunk (a round is cut at its chunk's limit, so the
    chunk is part of that trajectory)."""
    plain = dataclasses.replace(tc, checkpoint_path=None,
                                checkpoint_every=0, trace_out=None,
                                on_divergence="raise")
    if path != "decomp" or not rollback_events:
        return _ttrain(x, y, plain)
    back = rollback_events[0][1]
    pre = str(tmp_path / "pre.npz")
    _ttrain(x, y, dataclasses.replace(plain, max_iter=back,
                                      checkpoint_path=pre,
                                      checkpoint_every=back))
    return _ttrain(x, y, dataclasses.replace(
        plain, chunk_iters=tc.chunk_iters // 2, resume_from=pre))


@pytest.mark.parametrize("policy", ["rollback", "ignore"])
@pytest.mark.parametrize("path", sorted(PATHS))
def test_policy_matches_jax_and_lands_bitwise(tmp_path, blobs, path,
                                              policy):
    x, y = blobs
    jp, tp = _plans(nan_at_iter=120)
    kw = dict(checkpoint_every=50, checkpoint_keep=2, on_divergence=policy,
              **PATHS[path])
    jc, tc = _cfgs(checkpoint_path=str(tmp_path / "j.npz"),
                   trace_out=str(tmp_path / "j.jsonl"), **kw)
    tc = dataclasses.replace(tc, checkpoint_path=str(tmp_path / "t.npz"),
                             trace_out=str(tmp_path / "t.jsonl"))
    rj = _jtrain(x, y, jc, jp)
    rt = _ttrain(x, y, tc, tp)
    ev = _events(tmp_path / "t.jsonl")
    assert ev == _events(tmp_path / "j.jsonl")
    assert rt.n_iter == rj.n_iter == 300
    if not (path == "decomp" and policy == "rollback"):
        # after the rollback the decomposition runs 12-update chunks, at
        # which the two packages part at float32 rounding with no fault
        # at all (b 0.0561 against 0.0572 on this problem): its state is
        # held to the port's own reference below
        assert abs(rt.b - float(rj.b)) <= B_TOL
    rb = [e for e in ev if e[0] == "rollback"]
    if policy == "rollback":
        assert rb and rb[0][1] <= 120
        recs = [json.loads(line) for line in open(tmp_path / "t.jsonl")]
        assert [r["chunk_iters"] for r in recs
                if r.get("event") == "rollback"] == [12]
    else:
        assert not rb and ("divergence", 125) in ev
    ref = _reference(x, y, tc, tmp_path, path, rb)
    assert rt.n_iter == ref.n_iter
    assert rt.b == ref.b
    np.testing.assert_array_equal(rt.alpha, ref.alpha)


def test_rollback_on_the_approx_primal_chunk(tmp_path, blobs):
    """The approx solver's host loop takes the policy too; the run lands
    bitwise on the uninterrupted one (a primal step does not depend on
    the chunk), with the JAX run's events."""
    from dpsvm_tpu.approx.primal import fit_approx as jfit
    from dpsvm_tpu.resilience import faultinject as jfi
    from dpsvm_tpu_torch.approx.primal import fit_approx as tfit
    from dpsvm_tpu_torch.resilience import faultinject as tfi
    x, y = blobs
    kw = dict(solver="approx-rff", approx_dim=64, epsilon=1e-9,
              max_iter=60, chunk_iters=10, checkpoint_every=20,
              on_divergence="rollback")
    jc, tc = _cfgs(checkpoint_path=str(tmp_path / "j.npz"),
                   trace_out=str(tmp_path / "j.jsonl"), **kw)
    tc = dataclasses.replace(tc, checkpoint_path=str(tmp_path / "t.npz"),
                             trace_out=str(tmp_path / "t.jsonl"))
    jp, tp = _plans(nan_at_iter=35)
    jfi.install(jp)
    try:
        _, rj = jfit(x, y, jc)
    finally:
        jfi.clear()
    tfi.install(tp)
    try:
        mt, rt = tfit(x, y, tc, device="cpu")
    finally:
        tfi.clear()
    ev = _events(tmp_path / "t.jsonl")
    assert ev == _events(tmp_path / "j.jsonl")
    assert ("rollback", 20) in ev
    assert rt.n_iter == rj.n_iter
    mr, rr = tfit(x, y, dataclasses.replace(
        tc, checkpoint_path=None, checkpoint_every=0, trace_out=None,
        on_divergence="raise"), device="cpu")
    assert rt.n_iter == rr.n_iter
    np.testing.assert_array_equal(mt.w, mr.w)


def test_rollback_needs_a_checkpoint_path_and_degrades_without_hook(
        tmp_path, blobs, monkeypatch, capsys):
    from dpsvm_tpu_torch.config import SVMConfig
    from dpsvm_tpu_torch.resilience.health import DivergenceError
    from dpsvm_tpu_torch.solver import driver, smo
    with pytest.raises(ValueError, match="rollback"):
        SVMConfig(on_divergence="rollback").validate()
    # a path whose loop gets no rollback hook raises, saying why
    orig = driver.host_training_loop

    def no_hook(*a, **kw):
        kw["carry_from_ckpt"] = None
        return orig(*a, **kw)

    monkeypatch.setattr(smo, "host_training_loop", no_hook)
    x, y = blobs
    _, tc = _cfgs(selection="second-order", on_divergence="rollback",
                  checkpoint_path=str(tmp_path / "s.npz"),
                  checkpoint_every=50)
    _, tp = _plans(nan_at_iter=120)
    with pytest.raises(DivergenceError):
        _ttrain(x, y, tc, tp)
    assert "no rollback hook" in capsys.readouterr().err


def test_failed_checkpoint_write_keeps_training_and_old_file(tmp_path,
                                                             blobs):
    from dpsvm_tpu.utils.checkpoint import load_checkpoint as jload
    from dpsvm_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                  rotation_path)
    x, y = blobs
    jp, tp = _plans(fail_checkpoint_write=2)
    jc, tc = _cfgs(selection="second-order", checkpoint_every=100,
                   checkpoint_keep=2,
                   checkpoint_path=str(tmp_path / "j" / "state.npz"))
    tc = dataclasses.replace(
        tc, checkpoint_path=str(tmp_path / "t" / "state.npz"))
    assert _ttrain(x, y, tc, tp).n_iter == _jtrain(x, y, jc, jp).n_iter
    for sub, load in (("t", load_checkpoint), ("j", jload)):
        ck = str(tmp_path / sub / "state.npz")
        # the write at 200 failed; the next poll (225) retried
        assert load(ck).n_iter == 300
        assert load(rotation_path(ck, 1)).n_iter == 225
        assert not [p for p in os.listdir(tmp_path / sub)
                    if p.endswith(".npz.tmp")]


# ---------------------------------------------------------------------
# preemption and the supervised resume

_CHILD = textwrap.dedent("""
    import sys
    import numpy as np
    from dpsvm_tpu_torch.config import SVMConfig
    from dpsvm_tpu_torch.data.synthetic import make_blobs
    from dpsvm_tpu_torch.resilience.preempt import (PREEMPT_EXIT_CODE,
                                                    PreemptedError)
    from dpsvm_tpu_torch.solver.smo import train_single_device
    import torch
    torch.set_num_threads(1)
    resume = (sys.argv[sys.argv.index("--resume") + 1]
              if "--resume" in sys.argv else None)
    max_iter = int(sys.argv[1])
    out = sys.argv[2] if len(sys.argv) > 2 and sys.argv[2] != "-" else None
    x, y = make_blobs(n=200, d=5, seed=5)
    cfg = SVMConfig(c=5.0, gamma=0.5, epsilon=1e-12, max_iter=max_iter,
                    chunk_iters=50, checkpoint_path={ck!r},
                    checkpoint_every=100, checkpoint_keep=2,
                    resume_from=resume, trace_out={trace!r})
    try:
        r = train_single_device(x, y, cfg, torch.device("cpu"))
    except PreemptedError:
        sys.exit(PREEMPT_EXIT_CODE)
    if out:
        np.savez(out, alpha=np.asarray(r.alpha), b=r.b, n_iter=r.n_iter)
""")


def test_sigterm_snapshot_then_supervised_resume_bitwise(tmp_path):
    from dpsvm_tpu_torch.config import SVMConfig
    from dpsvm_tpu_torch.resilience.preempt import PREEMPT_EXIT_CODE
    from dpsvm_tpu_torch.resilience.supervisor import supervise
    from dpsvm_tpu_torch.solver.smo import train_single_device
    from dpsvm_tpu_torch.utils.checkpoint import load_checkpoint
    ck = str(tmp_path / "state.npz")
    trace1 = str(tmp_path / "run1.jsonl")
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.Popen(
        [sys.executable, "-c", _CHILD.format(ck=ck, trace=trace1),
         "500000", "-"], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE)
    deadline = time.monotonic() + 60
    while not os.path.exists(ck):
        assert time.monotonic() < deadline, proc.stderr.read().decode()
        assert proc.poll() is None, proc.stderr.read().decode()
        time.sleep(0.01)
    proc.send_signal(signal.SIGTERM)
    assert proc.wait(timeout=60) == PREEMPT_EXIT_CODE
    snap = load_checkpoint(ck)
    assert snap.n_iter > 0
    assert any(e == "preempt" for e, _ in _events(trace1))
    total = snap.n_iter + 700
    out = str(tmp_path / "resumed.npz")
    rc = supervise([sys.executable, "-c",
                    _CHILD.format(ck=ck, trace=str(tmp_path / "r2.jsonl")),
                    str(total), out], retries=1, backoff_s=0.0,
                   checkpoint_path=ck, env=env)
    assert rc == 0
    resumed = np.load(out)
    x, y = make_blobs(n=200, d=5, seed=5)
    ref = train_single_device(x, y, SVMConfig(
        c=5.0, gamma=0.5, epsilon=1e-12, max_iter=total, chunk_iters=50),
        torch.device("cpu"))
    assert int(resumed["n_iter"]) == ref.n_iter == total
    assert float(resumed["b"]) == ref.b
    np.testing.assert_array_equal(resumed["alpha"], ref.alpha)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_injected_preempt_and_run_with_retries(tmp_path, blobs, path):
    """PREEMPT_POLL at the 3rd poll, resumed in process: the JAX run's
    events on both attempts, the end bitwise the uninterrupted run."""
    from dpsvm_tpu.resilience.supervisor import run_with_retries as jrw
    from dpsvm_tpu_torch.resilience.supervisor import run_with_retries
    x, y = blobs
    jp, tp = _plans(preempt_at_poll=3)
    results = {}
    for tag, rw, train, plan, c in (("j", jrw, _jtrain, jp, 0),
                                    ("t", run_with_retries, _ttrain, tp, 1)):
        cfg = _cfgs(checkpoint_path=str(tmp_path / f"{tag}.npz"),
                    checkpoint_every=50, checkpoint_keep=2,
                    **PATHS[path])[c]

        def attempt(resume_from, k, cfg=cfg, tag=tag):
            return train(x, y, dataclasses.replace(
                cfg, resume_from=resume_from,
                trace_out=str(tmp_path / f"{tag}{k}.jsonl")))

        mod = sys.modules[type(plan).__module__]
        mod.install(plan)
        try:
            results[tag] = rw(attempt, retries=1, backoff_s=0.0,
                              checkpoint_path=str(tmp_path / f"{tag}.npz"))
        finally:
            mod.clear()
        for k in (0, 1):
            results[tag, k] = _events(tmp_path / f"{tag}{k}.jsonl")
    for k in (0, 1):
        assert results["t", k] == results["j", k]
    assert ("preempt", 75) in results["t", 0]
    assert results["t"].n_iter == results["j"].n_iter == 300
    ref = _reference(x, y, _cfgs(**PATHS[path])[1], tmp_path, "pair", [])
    np.testing.assert_array_equal(results["t"].alpha, ref.alpha)


def test_preempt_in_pipelined_mode_snapshots_the_next_chunk(tmp_path,
                                                           blobs):
    """checkpoint_every = 0: the JAX loop has one chunk in flight when the
    signal is seen, and snapshots after it; so does the port, at the same
    iteration, and the resume lands bitwise."""
    from dpsvm_tpu.resilience.preempt import PreemptedError as JP
    from dpsvm_tpu_torch.resilience.preempt import PreemptedError
    from dpsvm_tpu_torch.utils.checkpoint import load_checkpoint
    x, y = blobs
    jp, tp = _plans(preempt_at_poll=2)
    jc, tc = _cfgs(checkpoint_path=str(tmp_path / "j.npz"))
    tc = dataclasses.replace(tc, checkpoint_path=str(tmp_path / "t.npz"))
    with pytest.raises(JP) as je:
        _jtrain(x, y, jc, jp)
    with pytest.raises(PreemptedError) as te:
        _ttrain(x, y, tc, tp)
    assert te.value.n_iter == je.value.n_iter == 75
    assert load_checkpoint(str(tmp_path / "t.npz")).n_iter == 75
    resumed = _ttrain(x, y, dataclasses.replace(
        tc, resume_from=str(tmp_path / "t.npz")))
    ref = _ttrain(x, y, dataclasses.replace(tc, checkpoint_path=None))
    assert resumed.n_iter == ref.n_iter == 300
    np.testing.assert_array_equal(resumed.alpha, ref.alpha)


# ---------------------------------------------------------------------
# repairs 1 and 2: the events a resume and a reformed host record

def _flip_alpha(path):
    from dpsvm_tpu_torch.utils.checkpoint import load_checkpoint
    snap = load_checkpoint(path)
    raw = bytearray(open(path, "rb").read())
    payload = np.ascontiguousarray(snap.alpha, np.float32).tobytes()
    pos = raw.find(payload)
    raw[pos + len(payload) // 2] ^= 0xFF
    with open(path, "wb") as fh:
        fh.write(bytes(raw))


def _event_records(path):
    with open(path) as fh:
        return [{k: v for k, v in json.loads(line).items() if k != "t"}
                for line in fh if '"kind": "event"' in line]


def test_corrupt_slot_resume_records_rollback_like_jax(tmp_path, blobs):
    x, y = blobs
    for tag, train, c in (("j", _jtrain, 0), ("t", _ttrain, 1)):
        d = tmp_path / tag
        d.mkdir()
        ck = str(d / "state.npz")
        train(x, y, _cfgs(checkpoint_path=ck, checkpoint_every=100,
                          checkpoint_keep=2, max_iter=200)[c])
        _flip_alpha(ck)
        r = train(x, y, _cfgs(resume_from=ck,
                              trace_out=str(d / "trace.jsonl"))[c])
        assert r.n_iter == 300
    te = _event_records(tmp_path / "t" / "trace.jsonl")
    je = _event_records(tmp_path / "j" / "trace.jsonl")
    assert [e["event"] for e in te] == [e["event"] for e in je]
    rb = [e for e in te if e["event"] == "rollback"]
    assert len(rb) == 1 and rb[0]["n_iter"] == 100
    assert rb[0]["reason"] == "corrupt checkpoint on resume"
    assert rb[0]["skipped"] == [str(tmp_path / "t" / "state.npz")]


def test_resume_onto_another_mesh_records_reshard_like_jax(tmp_path,
                                                          blobs):
    """A checkpoint saved on a 2-shard mesh resumed on one device: both
    packages write a ``reshard`` event naming the two meshes."""
    from dpsvm_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                  save_checkpoint)
    x, y = blobs
    ck = str(tmp_path / "two.npz")
    _ttrain(x, y, _cfgs(checkpoint_path=ck, checkpoint_every=100,
                        max_iter=100)[1])
    save_checkpoint(ck, dataclasses.replace(load_checkpoint(ck),
                                            shards=2))
    for tag, train, c in (("j", _jtrain, 0), ("t", _ttrain, 1)):
        train(x, y, _cfgs(resume_from=ck,
                          trace_out=str(tmp_path / f"{tag}.jsonl"))[c])
    te = _event_records(tmp_path / "t.jsonl")
    je = _event_records(tmp_path / "j.jsonl")
    pick = [{k: e[k] for k in ("event", "n_iter", "from_shards",
                               "to_shards")}
            for e in te if e["event"] == "reshard"]
    assert pick == [{k: e[k] for k in ("event", "n_iter", "from_shards",
                                       "to_shards")}
                    for e in je if e["event"] == "reshard"]
    assert pick == [{"event": "reshard", "n_iter": 100, "from_shards": 2,
                     "to_shards": 1}]


def test_host_loss_markers_record_host_lost_then_reform(tmp_path, blobs,
                                                       monkeypatch):
    x, y = blobs
    monkeypatch.setenv("DPSVM_HOST_LOST", "1")
    monkeypatch.setenv("DPSVM_REFORM_FROM", "3")
    monkeypatch.setenv("DPSVM_REFORM_TO", "2")
    for tag, train, c in (("j", _jtrain, 0), ("t", _ttrain, 1)):
        train(x, y, _cfgs(max_iter=50,
                          trace_out=str(tmp_path / f"{tag}.jsonl"))[c])
    te = _event_records(tmp_path / "t.jsonl")
    assert te == _event_records(tmp_path / "j.jsonl")
    assert [e["event"] for e in te] == ["host_lost", "reform"]
    assert te[0]["host_id"] == 1
    assert (te[1]["from_hosts"], te[1]["to_hosts"]) == (3, 2)


# ---------------------------------------------------------------------
# debug_nans, every hook on, the watchdog

def test_debug_nans_raises_and_a_clean_run_adds_one_read_a_poll(blobs):
    from dpsvm_tpu_torch.solver import driver
    x, y = blobs
    _, tc = _cfgs()
    s0, f0 = driver.READS["stats"], driver.READS["finite"]
    bare = _ttrain(x, y, tc)
    s1, f1 = driver.READS["stats"], driver.READS["finite"]
    clean = _ttrain(x, y, dataclasses.replace(tc, debug_nans=True))
    s2, f2 = driver.READS["stats"], driver.READS["finite"]
    assert (s1 - s0, f1 - f0) == (12, 0)
    assert (s2 - s1, f2 - f1) == (12, 12)
    np.testing.assert_array_equal(clean.alpha, bare.alpha)
    assert clean.b == bare.b
    bad = x.copy()
    bad[17, 2] = np.nan
    with pytest.raises(FloatingPointError, match=r"iterations \[0, "):
        _ttrain(bad, y, dataclasses.replace(tc, debug_nans=True))


@pytest.mark.parametrize("path", sorted(PATHS))
def test_every_hook_on_is_bitwise_with_the_same_reads(tmp_path, blobs,
                                                      path, monkeypatch):
    from dpsvm_tpu_torch.solver import decomp, driver
    x, y = blobs
    _, tc = _cfgs(**PATHS[path])

    def reads():
        return driver.READS["stats"] + decomp.READS["stats"]

    r0 = reads()
    bare = _ttrain(x, y, tc)
    r1 = reads()
    monkeypatch.setenv("DPSVM_HOST_HEARTBEAT_DIR", str(tmp_path / "hb"))
    monkeypatch.setenv("DPSVM_HOST_ID", "0")
    monkeypatch.setenv("DPSVM_HOST_COUNT", "1")
    _, tp = _plans()
    hooked = _ttrain(x, y, dataclasses.replace(
        tc, on_divergence="rollback", health_window=10 ** 9,
        checkpoint_path=str(tmp_path / "h.npz")), tp)
    r2 = reads()
    assert r2 - r1 == r1 - r0
    assert hooked.n_iter == bare.n_iter
    assert hooked.b == bare.b
    np.testing.assert_array_equal(hooked.alpha, bare.alpha)
    beat = json.load(open(tmp_path / "hb" / "host-0.json"))
    assert beat["n_iter"] == bare.n_iter


def test_watchdog_expiry_exits_124_and_flushes_a_stall_event(tmp_path):
    from dpsvm_tpu_torch.observability.report import load_trace
    trace = str(tmp_path / "stalled.jsonl")
    code = textwrap.dedent(f"""
        import time
        from dpsvm_tpu_torch.observability.record import RunTrace
        from dpsvm_tpu_torch.utils import watchdog
        tr = RunTrace({trace!r}, config={{"kernel": "rbf"}}, n=10, d=2,
                      gamma=0.5, solver="smo")
        tr.chunk(n_iter=100, b_lo=1.0, b_hi=-1.0)
        watchdog._POLL_S = 0.2
        watchdog.arm(0.5)
        time.sleep(30)
    """)
    proc = subprocess.run([sys.executable, "-c", code],
                          capture_output=True, text=True, timeout=25,
                          env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 124, proc.stderr
    assert "STALL" in proc.stderr
    stall = [r for r in load_trace(trace)
             if r.get("kind") == "event" and r["event"] == "stall"]
    assert stall and stall[0]["timeout_s"] == 0.5


def test_watchdog_pet_is_a_no_op_while_disarmed():
    from dpsvm_tpu_torch.utils import watchdog
    assert watchdog._deadline is None and watchdog._thread is None
    watchdog.pet()
    assert watchdog._deadline is None and watchdog._thread is None


# ---------------------------------------------------------------------
# the environment's plan, the CLI, the selfcheck

TRAINING_KNOBS = {
    "CHECKPOINT_WRITE": "fail_checkpoint_write", "NAN_ITER": "nan_at_iter",
    "PREEMPT_POLL": "preempt_at_poll", "DIST_KILL_SHARD": "dist_kill_shard",
    "DIST_KILL_POLL": "dist_kill_poll", "DIST_DESYNC_AT": "dist_desync_at",
    "DIST_DESYNC_SHARD": "dist_desync_shard",
    "DIST_SLOW_SHARD": "dist_slow_shard", "HOST_KILL": "host_kill",
    "HOST_HANG_MS": "host_hang_ms",
    "PREFLIGHT_WEDGE_S": "preflight_wedge_s"}


@pytest.mark.parametrize("prefix", ["DPSVM_FAULT_", "BENCH_FAULT_"])
def test_env_plan_parsing_matches_jax(monkeypatch, prefix):
    from dpsvm_tpu.resilience import faultinject as jfi
    from dpsvm_tpu_torch.resilience import faultinject as tfi
    for k, (name, field) in enumerate(sorted(TRAINING_KNOBS.items())):
        monkeypatch.setenv(prefix + name, str(k + 2))
    monkeypatch.setenv(prefix + "IO_SLOW_READ_MS", "oops")
    jfi.clear()
    tfi.clear()
    jp, tp = jfi.current(), tfi.current()
    for name, field in TRAINING_KNOBS.items():
        assert getattr(tp, field) == getattr(jp, field) > 0, name
    assert tp.io_slow_read_ms == jp.io_slow_read_ms == 0


def test_plan_hooks_fire_once_like_jax():
    from dpsvm_tpu.solver.driver import ChunkStats as JS
    from dpsvm_tpu_torch.solver.driver import ChunkStats as TS
    jp, tp = _plans(preempt_at_poll=2, dist_kill_shard=2, host_kill=3,
                    host_hang_ms=250, dist_desync_at=10,
                    dist_slow_shard=1)
    assert ([jp.note_poll() for _ in range(4)]
            == [tp.note_poll() for _ in range(4)])
    assert ([jp.dist_kill_now() for _ in range(4)]
            == [tp.dist_kill_now() for _ in range(4)])
    assert ([jp.host_kill_now() for _ in range(4)]
            == [tp.host_kill_now() for _ in range(4)])
    assert tp.host_hang_delay_s() == jp.host_hang_delay_s() == 0.25
    rows = np.array([[12, 5, 6], [12, 5, 6], [12, 5, 6]], np.int32)
    for n_iter in (5, 12, 14):
        js = jp.poison_stats(JS(n_iter, 1.0, 0.0,
                                shard_probes=rows + n_iter))
        ts = tp.poison_stats(TS(n_iter, 1.0, 0.0, 0, 0, (),
                                tuple(map(tuple, rows + n_iter))))
        assert np.array_equal(np.asarray(ts.probe), js.shard_probes)


def test_cli_flags_reach_the_config(tmp_path, monkeypatch):
    from dpsvm_tpu import cli as jcli
    from dpsvm_tpu_torch import cli
    argv = ["train", "-f", "x.csv", "-m", "m.svm", "--on-divergence",
            "rollback", "--health-window", "500", "--retries", "2",
            "--retry-backoff", "0.5", "--debug-nans", "--chunk-iters",
            "64", "-a", "7", "-x", "30", "--checkpoint", "s.npz"]
    t = cli.build_parser().parse_args(argv)
    j = jcli.build_parser().parse_args(argv)
    for k in ("on_divergence", "health_window", "retries",
              "retry_backoff", "debug_nans", "chunk_iters", "num_att",
              "num_ex"):
        assert getattr(t, k) == getattr(j, k), k
    te = cli.build_parser().parse_args(["test", "-f", "x.csv", "-m", "m",
                                        "-a", "5", "-x", "9"])
    assert (te.num_att, te.num_ex) == (5, 9)
    d = ["doctor", "--shards", "1", "--checkpoint", "c.npz", "--data",
         "dd", "--timeout", "5", "--serving-url", "http://h:1",
         "--coordinator", "h:2", "--hosts-dir", "hb", "--num-hosts", "3",
         "--heartbeat-max-age", "9"]
    td, jd = cli.build_parser().parse_args(d), jcli.build_parser(
        ).parse_args(d)
    assert {k: v for k, v in vars(td).items() if k != "device"} == \
        vars(jd)
    # the CLI trains with them: -a / -x shape the load, --debug-nans and
    # the policy reach the run, a preempted run exits 75
    data = tmp_path / "train.csv"
    x, y = make_blobs(n=60, d=4, seed=2)
    with open(data, "w") as fh:
        for row, label in zip(x, y):
            fh.write(f"{int(label)}," + ",".join(f"{v:.9g}" for v in row)
                     + "\n")
    monkeypatch.setenv("DPSVM_FAULT_PREEMPT_POLL", "2")
    from dpsvm_tpu_torch.resilience import faultinject
    faultinject.clear()
    rc = cli.main(["train", "-f", str(data), "-m",
                   str(tmp_path / "m.svm"), "--device", "cpu", "-q",
                   "-c", "1", "-g", "0.5", "-e", "1e-12", "-n", "100",
                   "--chunk-iters", "25", "-a", "4", "-x", "60",
                   "--checkpoint", str(tmp_path / "s.npz"),
                   "--checkpoint-every", "25", "--debug-nans",
                   "--on-divergence", "rollback"])
    assert rc == 75
    faultinject.clear()
    monkeypatch.delenv("DPSVM_FAULT_PREEMPT_POLL")
    rc = cli.main(["train", "-f", str(data), "-m",
                   str(tmp_path / "m.svm"), "--device", "cpu", "-q",
                   "-c", "1", "-g", "0.5", "-e", "1e-12", "-n", "100",
                   "--chunk-iters", "25",
                   "--resume", str(tmp_path / "s.npz")])
    assert rc == 0


def test_train_retries_supervises_a_preempted_child(tmp_path):
    """``train --retries 2`` with the preemption planted in the children's
    environment (every attempt reads it): attempts 0 and 1 exit 75 after
    their snapshots at 75 and 150, attempt 2 ends at 200 before its third
    poll, and the model file is the uninterrupted run's."""
    from dpsvm_tpu_torch.models.io import load_model
    data = tmp_path / "train.csv"
    x, y = make_blobs(n=60, d=4, seed=2)
    with open(data, "w") as fh:
        for row, label in zip(x, y):
            fh.write(f"{int(label)}," + ",".join(f"{v:.9g}" for v in row)
                     + "\n")
    common = ["-f", str(data), "--device", "cpu", "-q", "-c", "1", "-g",
              "0.5", "-e", "1e-12", "-n", "200", "--chunk-iters", "25"]
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    run = subprocess.run(
        [sys.executable, "-m", "dpsvm_tpu_torch.cli", "train", *common,
         "-m", str(tmp_path / "sup.svm"), "--checkpoint",
         str(tmp_path / "s.npz"), "--checkpoint-every", "50",
         "--retries", "2", "--retry-backoff", "0"],
        env={**env, "DPSVM_FAULT_PREEMPT_POLL": "3"}, capture_output=True,
        text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    ref = subprocess.run(
        [sys.executable, "-m", "dpsvm_tpu_torch.cli", "train", *common,
         "-m", str(tmp_path / "ref.svm")], env=env, capture_output=True,
        text=True, timeout=120)
    assert ref.returncode == 0, ref.stderr
    a, b = load_model(str(tmp_path / "sup.svm")), load_model(
        str(tmp_path / "ref.svm"))
    np.testing.assert_array_equal(a.alpha, b.alpha)
    assert a.b == b.b


def test_resilience_selfcheck():
    from dpsvm_tpu_torch.resilience import selfcheck
    assert selfcheck(device="cpu", shard_drill=False) == []

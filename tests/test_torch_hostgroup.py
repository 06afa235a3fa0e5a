"""The port's host-group supervision and ``doctor`` held to the JAX
package's: heartbeat files crossing both ways, the admission barrier's
rules (and ``data/live.admission_barrier`` through it), the reformation
supervisor with stub children (reform, a non-transient exit, the retry
budget, ``min_hosts``, a clean exit), the validator's host_lost/reform
rules, and the doctor's verdicts and exit codes against JAX's
``run_doctor`` (a degraded or healthy group, an unreachable coordinator,
a corrupt checkpoint, shard data, a wedged collective probe). The real
kill-one-host drill spawns training processes and is marked ``slow``, as
the JAX package marks its own; ``python -m dpsvm_tpu_torch.resilience
--selfcheck`` runs it too.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import pytest

from dpsvm_tpu.resilience import hostgroup as jhg
from dpsvm_tpu_torch.resilience import hostgroup as thg
from torch_threads import one_thread  # noqa: F401

MODS = {"jax": jhg, "torch": thg}


@pytest.fixture(autouse=True)
def _fresh_host_state(monkeypatch):
    """Each test starts outside any host group with fresh published
    state in both packages."""
    for var in (thg.ENV_HEARTBEAT_DIR, thg.ENV_HOST_ID, thg.ENV_HOST_COUNT,
                "DPSVM_FAULT_HOST_HANG_MS"):
        monkeypatch.delenv(var, raising=False)
    for mod in MODS.values():
        monkeypatch.setattr(mod, "_STATE",
                            {"n_iter": 0, "generation": 0, "seq": 0})
    yield


# ---------------------------------------------------------------------
# heartbeat files

@pytest.mark.parametrize("writer, reader", [("torch", "jax"),
                                            ("jax", "torch")])
def test_heartbeats_cross_both_ways(tmp_path, writer, reader):
    hb = str(tmp_path / "hb")
    MODS[writer].write_heartbeat(hb, 0, n_iter=75, generation=3, seq=4)
    MODS[writer].write_heartbeat(hb, 2, n_iter=50, generation=2)
    beats = MODS[reader].read_heartbeats(hb)
    assert beats == MODS[writer].read_heartbeats(hb)
    assert set(beats) == {0, 2} and beats[0]["seq"] == 4
    assert beats[0]["n_iter"] == 75 and beats[2]["pid"] == os.getpid()
    assert set(MODS[reader].heartbeat_ages(hb)) == {0, 2}
    assert thg.heartbeat_path(hb, 2) == jhg.heartbeat_path(hb, 2)


def test_reader_skips_torn_and_foreign_files_and_ages_by_mtime(tmp_path):
    hb = tmp_path / "hb"
    hb.mkdir()
    thg.write_heartbeat(str(hb), 1, n_iter=10)
    (hb / "host-5.json").write_text("{not json at all")
    (hb / "host-x.json").write_text('{"host_id": "nope"}')
    (hb / "README.txt").write_text("ignore me")
    assert set(thg.read_heartbeats(str(hb))) == {1} == set(
        jhg.read_heartbeats(str(hb)))
    old = time.time() - 120.0
    os.utime(thg.heartbeat_path(str(hb), 1), (old, old))
    assert thg.heartbeat_ages(str(hb))[1] > 100.0


def test_note_poll_heartbeat_outside_and_inside_a_group(tmp_path,
                                                       monkeypatch):
    thg.note_poll_heartbeat(42)            # no group: writes nothing
    assert thg.read_heartbeats(str(tmp_path)) == {}
    hb = _join(monkeypatch, tmp_path, hid=1, count=2)
    thg.note_poll_heartbeat(75)
    thg.note_poll_heartbeat(100)
    rec = jhg.read_heartbeats(hb)[1]
    assert (rec["n_iter"], rec["seq"]) == (100, 2)


# ---------------------------------------------------------------------
# the admission barrier

def _join(monkeypatch, tmp_path, hid=0, count=2):
    hb = str(tmp_path / "hb")
    monkeypatch.setenv(thg.ENV_HEARTBEAT_DIR, hb)
    monkeypatch.setenv(thg.ENV_HOST_ID, str(hid))
    monkeypatch.setenv(thg.ENV_HOST_COUNT, str(count))
    return hb


@pytest.mark.parametrize("rule", ["holds", "never_regresses",
                                  "publishes", "straggler"])
def test_barrier_rules_match_jax(tmp_path, monkeypatch, rule):
    """The same sequence through both packages' barrier (each on its own
    heartbeat directory) gives the same answers."""
    answers = {}
    for name, mod in MODS.items():
        hb = _join(monkeypatch, tmp_path / name)
        got = []
        if rule == "holds":
            got.append(mod.admission_barrier(5, committed_gen=2))
            mod.write_heartbeat(hb, 1, n_iter=10, generation=3)
            got.append(mod.admission_barrier(5, committed_gen=2))
            mod.write_heartbeat(hb, 1, n_iter=20, generation=5)
            got.append(mod.admission_barrier(5, committed_gen=3))
        elif rule == "never_regresses":
            mod.write_heartbeat(hb, 1, n_iter=5, generation=1)
            got.append(mod.admission_barrier(6, committed_gen=4))
        elif rule == "publishes":
            mod.write_heartbeat(hb, 1, n_iter=1, generation=9)
            got.append(mod.admission_barrier(4, committed_gen=0))
            got.append(mod.read_heartbeats(hb)[0]["generation"])
        else:
            mod.write_heartbeat(hb, 1, n_iter=1, generation=2)
            monkeypatch.setenv("DPSVM_FAULT_HOST_HANG_MS", "80")
            t0 = time.monotonic()
            got.append(mod.admission_barrier(5, committed_gen=1))
            got.append(time.monotonic() - t0 >= 0.08)
            monkeypatch.delenv("DPSVM_FAULT_HOST_HANG_MS")
        answers[name] = got
    assert answers["torch"] == answers["jax"]
    want = {"holds": [2, 3, 5], "never_regresses": [4],
            "publishes": [4, 4], "straggler": [2, True]}[rule]
    assert answers["torch"] == want


def test_barrier_is_the_identity_outside_a_group_and_live_uses_it(
        tmp_path, monkeypatch):
    from dpsvm_tpu_torch.data import live
    assert thg.admission_barrier(7, 3) == 7 == live.admission_barrier(7, 3)
    hb = _join(monkeypatch, tmp_path)
    assert live.admission_barrier(5, 2) == 2     # peer 1 not beating
    thg.write_heartbeat(hb, 1, n_iter=1, generation=4)
    assert live.admission_barrier(5, 2) == 4


def test_clean_child_env_strips_markers_and_faults():
    base = {"PATH": "/bin", "DPSVM_HOST_LOST": "1",
            "DPSVM_REFORM_FROM": "3", "DPSVM_REFORM_TO": "2",
            "DPSVM_RETRY_ATTEMPT": "1", "DPSVM_FAULT_HOST_KILL": "3",
            "DPSVM_FAULT_HOST_HANG_MS": "50"}
    assert thg._clean_child_env(base) == jhg._clean_child_env(base) == {
        "PATH": "/bin"}


# ---------------------------------------------------------------------
# the reformation supervisor, with stub children (no torch start)

_STUB = r"""
import json, os, sys, time
hb = os.environ["DPSVM_HOST_HEARTBEAT_DIR"]
hid = int(os.environ["DPSVM_HOST_ID"])
os.makedirs(hb, exist_ok=True)
path = os.path.join(hb, "host-%d.json" % hid)
with open(path + ".tmp", "w") as fh:
    json.dump({"host_id": hid, "n_iter": 1, "generation": 0,
               "t": time.time(), "pid": os.getpid()}, fh)
os.replace(path + ".tmp", path)
if os.environ.get("STUB_DIE_RC"):
    sys.exit(int(os.environ["STUB_DIE_RC"]))
if os.environ.get("STUB_HANG"):
    time.sleep(60)
if os.environ.get("DPSVM_RETRY_ATTEMPT"):
    with open(os.path.join(hb, "marker-%d.txt" % hid), "w") as fh:
        fh.write(":".join([os.environ.get("DPSVM_HOST_LOST", ""),
                           os.environ.get("DPSVM_REFORM_FROM", ""),
                           os.environ.get("DPSVM_REFORM_TO", "")]))
sys.exit(0)
"""


def _stub_argv(hid, hosts, coordinator, attempt):
    return [sys.executable, "-c", _STUB]


def _group(tmp_path, **kw):
    kw.setdefault("retries", 1)
    return thg.run_host_group(_stub_argv, num_hosts=2,
                              heartbeat_dir=str(tmp_path / "hb"),
                              deadline_s=30.0, poll_s=0.05, grace_s=1.0,
                              **kw)


def test_run_host_group_reforms_on_a_transient_loss(tmp_path):
    res = _group(tmp_path, first_attempt_env={1: {"STUB_DIE_RC": "75"}})
    assert (res.attempts, res.hosts, res.losses) == (2, 1, [1])
    with open(tmp_path / "hb" / "marker-0.txt") as fh:
        assert fh.read() == "1:2:1"


def test_run_host_group_reforms_after_a_silent_host(tmp_path):
    """A host that stops beating (here: never leaves its sleep) is lost
    by heartbeat age and killed with its group."""
    res = thg.run_host_group(
        _stub_argv, num_hosts=2, heartbeat_dir=str(tmp_path / "hb"),
        retries=1, deadline_s=1.0, poll_s=0.05, grace_s=0.5,
        first_attempt_env={1: {"STUB_HANG": "1"}})
    assert (res.attempts, res.hosts, res.losses) == (2, 1, [1])
    assert res.recovery_s > 0


@pytest.mark.parametrize("kw, match", [
    (dict(retries=3, first_attempt_env={0: {"STUB_DIE_RC": "1"}}),
     "non-transient"),
    (dict(retries=0, first_attempt_env={1: {"STUB_DIE_RC": "75"}}),
     "retry budget"),
    (dict(retries=3, min_hosts=2,
          first_attempt_env={1: {"STUB_DIE_RC": "75"}}), "min_hosts"),
])
def test_run_host_group_refuses_what_reform_cannot_fix(tmp_path, kw,
                                                       match):
    with pytest.raises(thg.HostGroupError, match=match):
        _group(tmp_path, **kw)


def test_run_host_group_clean_exit_is_one_attempt(tmp_path):
    res = _group(tmp_path)
    assert (res.attempts, res.hosts, res.losses) == (1, 2, [])


def test_validator_host_lost_and_reform_rules_match_jax(tmp_path):
    from dpsvm_tpu.telemetry import validate_trace as jval
    from dpsvm_tpu_torch import SVMConfig, train
    from dpsvm_tpu_torch.data.synthetic import make_blobs
    from dpsvm_tpu_torch.observability.report import load_trace
    from dpsvm_tpu_torch.observability.schema import validate_trace
    x, y = make_blobs(n=64, d=4, seed=11)
    trace = str(tmp_path / "t.jsonl")
    train(x, y, SVMConfig(c=1.0, gamma=0.5, epsilon=1e-12, max_iter=100,
                          chunk_iters=25, trace_out=trace), device="cpu")
    records = load_trace(trace)
    manifest, rest = records[0], records[1:]
    chunk = next(r for r in rest if r["kind"] == "chunk")
    tail = rest[rest.index(chunk) + 1:]
    lost = {"kind": "event", "event": "host_lost", "n_iter": chunk["n_iter"],
            "host_id": 1, "t": chunk["t"]}
    reform = {"kind": "event", "event": "reform", "n_iter": 0,
              "from_hosts": 3, "to_hosts": 2, "t": chunk["t"]}
    rewound = dict(chunk, n_iter=0)
    cases = [
        [manifest, chunk, lost, reform, rewound] + tail,
        [manifest, chunk, lost, rewound] + tail,
        [manifest, chunk, dict(lost, host_id=None)] + tail,
        [manifest, chunk, {k: v for k, v in reform.items()
                           if k != "from_hosts"}, rewound] + tail,
    ]
    got = [validate_trace(c) for c in cases]
    assert [bool(e) for e in got] == [bool(jval(c)) for c in cases]
    assert got[0] == []
    assert any("monotone" in e for e in got[1])
    assert any("from_hosts" in e for e in got[3])


# ---------------------------------------------------------------------
# the doctor

def _doctor(mod, **kw):
    lines = []
    kw.setdefault("timeout_s", 60.0)
    if mod == "torch":
        from dpsvm_tpu_torch.resilience.doctor import run_doctor
        rc = run_doctor(device="cpu", out=lines.append, **kw)
    else:
        from dpsvm_tpu.resilience.doctor import run_doctor
        rc = run_doctor(out=lines.append, **kw)
    return rc, "\n".join(lines)


def test_doctor_group_verdicts_match_jax(tmp_path):
    hb = str(tmp_path / "hb")
    thg.write_heartbeat(hb, 0, n_iter=10, generation=1)
    for mod in MODS:
        rc, text = _doctor(mod, shards=1, hosts_dir=hb, num_hosts=2)
        assert rc == 9, text
        assert "host 1 has NO heartbeat" in text
        assert "host group degraded" in text
    thg.write_heartbeat(hb, 1, n_iter=10, generation=1)
    old = time.time() - 300.0
    os.utime(thg.heartbeat_path(hb, 1), (old, old))
    for mod in MODS:
        rc, text = _doctor(mod, shards=1, hosts_dir=hb, num_hosts=2,
                           heartbeat_max_age_s=60.0)
        assert rc == 9 and "STALE" in text, text
    thg.write_heartbeat(hb, 1, n_iter=10, generation=1)
    from dpsvm_tpu_torch.parallel import multihost
    dead = f"127.0.0.1:{multihost.find_free_port()}"
    for mod in MODS:
        rc, text = _doctor(mod, shards=1, hosts_dir=hb, num_hosts=2)
        assert rc == 0 and "host group healthy" in text, text
        assert "collective check skipped" in text
        rc, text = _doctor(mod, shards=1, coordinator=dead, timeout_s=5.0)
        assert rc == 9 and "unreachable" in text


def test_doctor_checkpoint_and_data_verdicts_match_jax(tmp_path):
    from dpsvm_tpu_torch import SVMConfig, train
    from dpsvm_tpu_torch.data.stream import convert_to_shards
    from dpsvm_tpu_torch.data.synthetic import make_blobs, save_csv
    x, y = make_blobs(n=64, d=4, seed=11)
    csv = str(tmp_path / "d.csv")
    save_csv(csv, x, y)
    ck = str(tmp_path / "ck" / "state.npz")
    train(x, y, SVMConfig(c=1.0, gamma=0.5, max_iter=100, chunk_iters=25,
                          checkpoint_path=ck, checkpoint_every=100),
          device="cpu")
    sd = str(tmp_path / "shards")
    convert_to_shards(csv, sd, rows_per_shard=16)
    for mod in MODS:
        rc, text = _doctor(mod, shards=1, checkpoint_path=ck, data_path=sd)
        assert rc == 0, text
        assert "newest intact slot" in text and "timed read" in text
    from dpsvm_tpu_torch.utils.checkpoint import load_checkpoint
    snap = load_checkpoint(ck)
    raw = bytearray(open(ck, "rb").read())
    payload = np.ascontiguousarray(snap.alpha, np.float32).tobytes()
    pos = raw.find(payload)
    raw[pos + len(payload) // 2] ^= 0xFF
    open(ck, "wb").write(bytes(raw))
    for mod in MODS:
        rc, text = _doctor(mod, shards=1, checkpoint_path=ck)
        assert rc == 6 and "NO intact checkpoint" in text, text


def test_doctor_wedged_probe_times_out_with_exit_5(monkeypatch):
    from dpsvm_tpu_torch.resilience import faultinject
    faultinject.install(faultinject.FaultPlan(preflight_wedge_s=3))
    try:
        rc, text = _doctor("torch", timeout_s=0.5)
    finally:
        faultinject.clear()
    assert rc == 5 and "TIMED OUT" in text


def test_doctor_cli_on_the_cpu(capsys):
    from dpsvm_tpu_torch import cli
    assert cli.main(["doctor", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "backend: cpu" in out and "collective: all_reduce" in out
    assert out.strip().splitlines()[-1].startswith("DOCTOR OK")


def test_the_drills_run_on_the_card_unless_asked_for_the_cpu(tmp_path,
                                                             monkeypatch):
    """Both drills default to the card and, with no card, raise before
    they start a process."""
    import torch
    from dpsvm_tpu_torch.data.synthetic import make_blobs
    from dpsvm_tpu_torch.resilience import kill_shard_drill
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, y = make_blobs(n=32, d=4, seed=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        thg.host_loss_drill(str(tmp_path / "h"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        kill_shard_drill(str(tmp_path / "s"), x, y)
    assert os.listdir(tmp_path) == []


def test_dist_backend_flag_and_its_refusals(monkeypatch):
    """``train --dist-backend gloo`` reaches the group; gloo on the card
    needs a card, NCCL needs CUDA ranks, and no other backend is taken."""
    import torch
    from dpsvm_tpu_torch import cli
    from dpsvm_tpu_torch.parallel import multihost
    args = cli.build_parser().parse_args(
        ["train", "-f", "a.csv", "-m", "m", "--shards", "3",
         "--dist-backend", "gloo"])
    assert args.dist_backend == "gloo"
    assert not multihost.is_initialized()
    one = dict(num_processes=1, process_id=0, timeout_s=5.0)
    with pytest.raises(ValueError, match="NCCL needs CUDA ranks"):
        multihost.initialize(device="cpu", backend="nccl", **one)
    with pytest.raises(ValueError, match="backend must be"):
        multihost.initialize(device="cpu", backend="mpi", **one)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="gloo rank on the card"):
        multihost.initialize(device="cuda", backend="gloo", **one)
    assert not multihost.is_initialized() and not multihost.gloo_on_card()


@pytest.mark.slow
def test_host_loss_drill_end_to_end(tmp_path):
    """Three host processes over gloo, host 1 SIGKILLed at its 3rd poll,
    the survivors reformed to two from the newest checkpoint: the model
    of ``train --shards 3`` within 1e-4, host_lost -> reform on a valid
    trace, the recovery latency measured."""
    facts = thg.host_loss_drill(str(tmp_path / "drill"), device="cpu")
    assert facts["hosts"] == 3 and facts["surviving_hosts"] == 2
    assert facts["losses"] == [1] and facts["attempts"] == 2
    assert facts["host_loss_recovery_s"] > 0
    assert facts["coef_delta"] <= 1e-4 and facts["b_delta"] <= 1e-4

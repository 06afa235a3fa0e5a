"""The port's elastic distributed training held to the JAX package's: the
desync guard, the heartbeats and the stall verdict unit by unit against
JAX's functions; in gloo ranks (started once a world size, as
tests/torch_dist_scenarios.py does) an injected desync raising
``DesyncError`` with a ``desync`` event carrying ``shards`` and, under
rollback, landing bitwise; a lost shard; the degraded-mesh resumes 4 -> 2,
4 -> 1 and 1 -> 4 bitwise with their ``reshard`` events; the slow shard's
ages on chunk records; every hook on a fault-free run (bitwise, the same
reads); the kill-one-shard drill through ``run_elastic`` on a new world of
the survivors; the validator's reshard/desync rules.

The JAX package's distributed trainers do not run on this JAX (the known
``ShardingTypeError`` set, ROADMAP Queue 3), so the event sequences are
held to the JAX driver itself: its host loop run over its single-device
chunk with a P-row probe tail appended to the same stats (what its SPMD
runners append), under the same ``FaultPlan``. The driver takes every
event decision from those stats, so the names and n_iter of its events
are the oracle's.
"""

import contextlib
import json
import os

import numpy as np
import pytest
import torch

from dpsvm_tpu.data.synthetic import make_blobs
from torch_elastic_ranks import launch
from torch_threads import one_thread  # noqa: F401

BASE = dict(c=1.0, gamma=0.5, epsilon=1e-12, max_iter=300, chunk_iters=25)


@pytest.fixture(autouse=True)
def _clean_faults():
    from dpsvm_tpu.resilience import faultinject as jfi
    from dpsvm_tpu_torch.resilience import faultinject as tfi
    jfi.clear()
    tfi.clear()
    yield
    jfi.clear()
    tfi.clear()


BLOBS = make_blobs(n=96, d=5, seed=7)


def _cfg(**kw):
    return dict(BASE, **kw)


def _events(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh
                if '"kind": "event"' in line]


def _pairs(path):
    return [(e["event"], e["n_iter"]) for e in _events(path)]


@contextlib.contextmanager
def _jax_mesh(shards):
    """The JAX driver over its single-device chunk with a ``shards``-row
    probe tail (every row the replicated scalars, as a healthy mesh's),
    resuming and checkpointing as a ``shards``-device mesh."""
    import jax.numpy as jnp
    from dpsvm_tpu.solver import smo as jsmo
    loop, resume = jsmo.host_training_loop, jsmo.resume_state

    def mesh_loop(*a, **kw):
        step = kw["step_chunk"]

        def probed(c, lim):
            c, st = step(c, lim)
            return c, jnp.concatenate([st, jnp.tile(st[:3], shards)])

        kw.update(step_chunk=probed, shards=shards)
        return loop(*a, **kw)

    jsmo.host_training_loop = mesh_loop
    jsmo.resume_state = lambda c, n, d, g, shards_=1: resume(
        c, n, d, g, shards=shards)
    try:
        yield
    finally:
        jsmo.host_training_loop, jsmo.resume_state = loop, resume


def _jax_run(shards, plan=None, **cfg):
    """(result or the raised error, ) of the JAX oracle."""
    from dpsvm_tpu.config import SVMConfig
    from dpsvm_tpu.resilience import faultinject
    from dpsvm_tpu.solver.smo import train_single_device
    faultinject.install(faultinject.FaultPlan(**plan) if plan else None)
    try:
        with _jax_mesh(shards):
            return train_single_device(*BLOBS, SVMConfig(**_cfg(**cfg)))
    except Exception as e:
        return e
    finally:
        faultinject.clear()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Worlds of 4, 2 and 1 gloo ranks, each started once; the 1 -> 4
    resume's checkpoint comes from a single-device run first."""
    from dpsvm_tpu_torch.config import SVMConfig
    from dpsvm_tpu_torch.solver.smo import train_single_device
    tmp = tmp_path_factory.mktemp("elastic")
    x, y = BLOBS
    s1, s4 = str(tmp / "s1.npz"), str(tmp / "s4.npz")
    train_single_device(x, y, SVMConfig(**_cfg(
        max_iter=200, checkpoint_path=s1, checkpoint_every=100)),
        torch.device("cpu"))
    hb = str(tmp / "hb")
    w4 = [
        {"name": "base", "cfg": _cfg(trace_out=str(tmp / "base.jsonl"))},
        {"name": "base400", "cfg": _cfg(max_iter=400)},
        {"name": "save", "cfg": _cfg(max_iter=200, checkpoint_path=s4,
                                     checkpoint_every=100)},
        {"name": "r14", "cfg": _cfg(max_iter=400, resume_from=s1,
                                    trace_out=str(tmp / "r14.jsonl"))},
        {"name": "desync_raise", "plan": dict(dist_desync_at=100),
         "cfg": _cfg(trace_out=str(tmp / "desync_raise.jsonl"))},
        {"name": "desync_rollback", "plan": dict(dist_desync_at=120),
         "cfg": _cfg(checkpoint_path=str(tmp / "dr.npz"),
                     checkpoint_every=50, checkpoint_keep=2,
                     on_divergence="rollback",
                     trace_out=str(tmp / "desync_rollback.jsonl"))},
        {"name": "slow", "plan": dict(dist_slow_shard=2),
         "cfg": _cfg(trace_out=str(tmp / "slow.jsonl"))},
        {"name": "hooks", "plan": {},
         "env": {"DPSVM_HOST_HEARTBEAT_DIR": hb},
         "cfg": _cfg(checkpoint_path=str(tmp / "h.npz"),
                     on_divergence="rollback", health_window=10 ** 9)},
        {"name": "agree", "cfg": _cfg(debug_nans=True, wall_budget_s=1e9,
                                      trace_out=str(tmp / "agree.jsonl"))},
        {"name": "kill", "plan": dict(dist_kill_shard=2, dist_kill_poll=3),
         "cfg": _cfg(checkpoint_path=str(tmp / "k.npz"),
                     checkpoint_every=50, trace_out=str(tmp / "kill.jsonl"))},
    ]
    out = {4: launch(4, x, y, w4)}
    for w in (2, 1):
        out[w] = launch(w, x, y, [{
            "name": f"r4{w}",
            "cfg": _cfg(max_iter=400, resume_from=s4,
                        trace_out=str(tmp / f"r4{w}.jsonl"))}])
    single = train_single_device(x, y, SVMConfig(**_cfg(max_iter=400)),
                                 torch.device("cpu"))
    return {"tmp": tmp, "res": {**out[4], **out[2], **out[1]},
            "single400": single, "hb": hb}


# ---------------------------------------------------------------------
# units against the JAX package's

def test_desync_unit_checks_match_jax():
    from dpsvm_tpu.resilience import elastic as je
    from dpsvm_tpu_torch.resilience import elastic as te
    probes = np.array([[100, 7, 8]] * 4, np.int32)
    lag = probes.copy()
    lag[2, 0] = 75
    bad = probes.copy()
    bad[2, 1] ^= 1
    for p in (probes, lag, bad, probes[:1]):
        assert te.desync_reason(p) == je.desync_reason(p)
        assert te.probe_values(p) == je.probe_values(p)
    reason = te.desync_reason(bad)
    assert reason is not None and "[2]" in reason
    det = te.DesyncDetector()
    assert det.check(bad) == reason
    assert det.check(bad) is None              # once an incident
    det.reset()
    assert det.check(bad) == reason
    assert det.check(None) is None and det.check(()) is None
    assert te.PROBE_WIDTH == je.PROBE_WIDTH


def test_heartbeats_and_stall_verdict_match_jax():
    from dpsvm_tpu.resilience import elastic as je
    from dpsvm_tpu_torch.resilience import elastic as te
    probes = np.array([[100, 1, 2]] * 4, np.int32)
    for mod in (te, je):
        hb = mod.ShardHeartbeats(4)
        assert len(hb.note_poll(probes)) == 4
        mod.register_heartbeats(hb)
        try:
            extras = mod.stall_extras()
            assert extras["dist_verdict"] == "collective-hang"
            assert extras["shards"] == 4 and len(extras["shard_ages"]) == 4
            hb._last_seen[2] -= 100.0
            assert mod.stall_extras()["dist_verdict"] == "straggler-shard-2"
        finally:
            mod.register_heartbeats(None)
        assert mod.stall_extras() == {}
    assert [te.surviving_shards(p, m) for p, m in ((4, 1), (1, 1), (4, 3))] \
        == [je.surviving_shards(p, m) for p, m in ((4, 1), (1, 1), (4, 3))]


def test_run_elastic_shrinks_retries_and_propagates_like_jax():
    from dpsvm_tpu.resilience import elastic as je
    from dpsvm_tpu_torch.parallel.multihost import RanksFailedError
    from dpsvm_tpu_torch.resilience import elastic as te
    from dpsvm_tpu_torch.resilience.preempt import PreemptedError
    from dpsvm_tpu_torch.solver import driver
    calls = {"t": [], "j": []}

    def attempt(tag, mod):
        def fn(resume_from, shards, k):
            calls[tag].append(shards)
            raise mod.ShardLostError(0, shards, 50)
        return fn

    for tag, mod in (("t", te), ("j", je)):
        with pytest.raises(mod.ShardLostError):
            mod.run_elastic(attempt(tag, mod), shards=4, retries=2,
                            backoff_s=0.0)
    assert calls["t"] == calls["j"] == [4, 3, 2]
    from dpsvm_tpu.solver import driver as jdriver
    jdriver.drain_queued_events(None)       # JAX's queued retries
    queued = driver.drain_queued_events()
    assert [e for e, _ in queued] == ["retry", "retry"]
    # the ranks' report of a loss or a preemption is the same signal;
    # anything else fails fast
    seen = []

    def ranks(resume_from, shards, k):
        seen.append(shards)
        if k == 0:
            raise RanksFailedError("2 of 4", [te.ShardLostError(1, 4, 75)])
        if k == 1:
            raise RanksFailedError("3 of 3", [PreemptedError(15, 100)])
        raise RanksFailedError("1 of 3", [ValueError("bad")])

    with pytest.raises(RanksFailedError, match="1 of 3"):
        te.run_elastic(ranks, shards=4, retries=5, backoff_s=0.0)
    assert seen == [4, 3, 3]
    driver.drain_queued_events()


# ---------------------------------------------------------------------
# in gloo ranks

def test_ranks_agree_and_the_base_trace_is_valid(worlds):
    from dpsvm_tpu_torch.observability.report import load_trace
    for name, r in worlds["res"].items():
        assert r["ranks_agree"], name
    assert load_trace(str(worlds["tmp"] / "base.jsonl"))


def test_desync_raises_desync_error_with_its_event(worlds):
    from dpsvm_tpu.resilience.health import DesyncError as JD
    r = worlds["res"]["desync_raise"]
    assert r["error"] == "DesyncError" and "desync" in r["message"]
    trace = str(worlds["tmp"] / "desync_raise.jsonl")
    ev = [e for e in _events(trace) if e["event"] == "desync"]
    assert ev and ev[0]["action"] == "raise" and ev[0]["shards"] == 4
    j = _jax_run(4, dict(dist_desync_at=100),
                 trace_out=str(worlds["tmp"] / "j_desync_raise.jsonl"))
    assert isinstance(j, JD) and j.n_iter == r["n_iter"]
    assert _pairs(trace) == _pairs(worlds["tmp"] / "j_desync_raise.jsonl")


def test_desync_rollback_matches_jax_and_lands_bitwise(worlds):
    res = worlds["res"]
    r = res["desync_rollback"]
    trace = str(worlds["tmp"] / "desync_rollback.jsonl")
    names = [e for e, _ in _pairs(trace)]
    assert names.index("desync") < names.index("rollback")
    _jax_run(4, dict(dist_desync_at=120),
             checkpoint_path=str(worlds["tmp"] / "j_dr.npz"),
             checkpoint_every=50, checkpoint_keep=2,
             on_divergence="rollback",
             trace_out=str(worlds["tmp"] / "j_dr.jsonl"))
    assert _pairs(trace) == _pairs(worlds["tmp"] / "j_dr.jsonl")
    assert r["n_iter"] == res["base"]["n_iter"] == 300
    np.testing.assert_array_equal(r["alpha"], res["base"]["alpha"])


def test_a_lost_shard_raises_on_every_rank_like_jax(worlds):
    r = worlds["res"]["kill"]
    assert r["error"] == "ShardLostError" and r["n_iter"] == 75
    trace = str(worlds["tmp"] / "kill.jsonl")
    lost = next(e for e in _events(trace) if e["event"] == "shard_lost")
    assert (lost["shard"], lost["shards"]) == (1, 4)
    j = _jax_run(4, dict(dist_kill_shard=2, dist_kill_poll=3),
                 checkpoint_path=str(worlds["tmp"] / "j_k.npz"),
                 checkpoint_every=50,
                 trace_out=str(worlds["tmp"] / "j_kill.jsonl"))
    assert type(j).__name__ == "ShardLostError" and j.n_iter == 75
    assert _pairs(trace) == _pairs(worlds["tmp"] / "j_kill.jsonl")


@pytest.mark.parametrize("name, p_save, p_resume",
                         [("r42", 4, 2), ("r41", 4, 1), ("r14", 1, 4)])
def test_degraded_mesh_resume_bitwise(worlds, name, p_save, p_resume):
    from dpsvm_tpu.telemetry import load_trace as jload
    from dpsvm_tpu_torch.observability.report import load_trace
    res = worlds["res"]
    ref = (res["base400"]["alpha"] if p_save == 4
           else worlds["single400"].alpha)
    assert res[name]["n_iter"] == 400
    np.testing.assert_array_equal(res[name]["alpha"], ref)
    trace = str(worlds["tmp"] / f"{name}.jsonl")
    assert load_trace(trace) and jload(trace)     # both validators
    reshard = [e for e in _events(trace) if e["event"] == "reshard"]
    assert [(e["from_shards"], e["to_shards"], e["n_iter"])
            for e in reshard] == [(p_save, p_resume, 200)]


def test_slow_shard_ages_on_chunk_records(worlds):
    from dpsvm_tpu_torch.observability.report import load_trace
    chunks = [r for r in load_trace(str(worlds["tmp"] / "slow.jsonl"))
              if r["kind"] == "chunk"]
    assert chunks and all(len(c["shard_ages"]) == 4 for c in chunks)
    last = chunks[-1]["shard_ages"]
    assert last[1] == max(last) and last[1] > last[0]
    base = [r for r in load_trace(str(worlds["tmp"] / "base.jsonl"))
            if r["kind"] == "chunk"]
    assert all(len(c["shard_ages"]) == 4 for c in base)


def test_every_hook_on_is_bitwise_with_the_same_reads(worlds):
    res = worlds["res"]
    assert res["hooks"]["reads"] == res["base"]["reads"]
    assert res["base"]["reads"]["stats"] > 0
    assert res["hooks"]["n_iter"] == res["base"]["n_iter"]
    np.testing.assert_array_equal(res["hooks"]["alpha"],
                                  res["base"]["alpha"])
    beat = json.load(open(os.path.join(worlds["hb"], "host-0.json")))
    assert beat["n_iter"] == 300


def test_ranks_agree_once_a_poll(worlds):
    """A pending signal, the wall budget and the ``debug_nans`` flag are
    decided in one all-reduce and one read a poll: a poll that is not the
    run's last pays one agreement read and no other; ``debug_nans`` adds
    the last poll's and no flag read of its own; the run is bitwise the
    bare one and its chunk records time the ``agree`` phase."""
    from dpsvm_tpu_torch.observability.report import load_trace
    res = worlds["res"]
    polls = BASE["max_iter"] // BASE["chunk_iters"]
    assert res["base"]["reads"] == {"stats": polls, "finite": 0,
                                    "agree": polls - 1}
    assert res["agree"]["reads"] == {"stats": polls, "finite": 0,
                                     "agree": polls}
    assert res["agree"]["n_iter"] == res["base"]["n_iter"]
    np.testing.assert_array_equal(res["agree"]["alpha"],
                                  res["base"]["alpha"])
    chunks = [r for r in load_trace(str(worlds["tmp"] / "agree.jsonl"))
              if r["kind"] == "chunk"]
    assert [c["phase_counts"]["agree"] for c in chunks] == \
        list(range(1, polls + 1))


def test_kill_shard_drill_resumes_on_a_new_world(tmp_path):
    """``run_elastic`` over ``launch_local``: the world of 4 loses shard
    #2 at its 3rd poll and a world of 3 resumes from the newest
    checkpoint: n_iter the uninterrupted world's, alpha within 1e-4 (3
    ranks split the rows otherwise), the resumed trace's events the JAX
    driver's and schema-valid."""
    from dpsvm_tpu.resilience import elastic as je
    from dpsvm_tpu.resilience import faultinject as jfi
    from dpsvm_tpu.solver.smo import train_single_device
    from dpsvm_tpu.config import SVMConfig
    from dpsvm_tpu_torch.observability.schema import validate_trace
    from dpsvm_tpu_torch.resilience import kill_shard_drill
    x, y = BLOBS
    out = kill_shard_drill(str(tmp_path / "t"), x, y, shards=4,
                           device="cpu")
    assert out["got"]["n_iter"] == out["ref"]["n_iter"] == 300
    np.testing.assert_allclose(out["got"]["alpha"], out["ref"]["alpha"],
                               rtol=0.0, atol=1e-4)
    assert validate_trace(out["trace"]) == []
    jfi.install(jfi.FaultPlan(dist_kill_shard=2, dist_kill_poll=3))
    ck = str(tmp_path / "j.npz")

    def attempt(resume_from, shards, k):
        with _jax_mesh(shards):
            return train_single_device(x, y, SVMConfig(**_cfg(
                checkpoint_path=ck, checkpoint_every=50,
                checkpoint_keep=2, resume_from=resume_from,
                trace_out=str(tmp_path / f"j{k}.jsonl"))))

    try:
        je.run_elastic(attempt, shards=4, retries=1, backoff_s=0.0,
                       checkpoint_path=ck)
    finally:
        jfi.clear()
    got = [(r["event"], r["n_iter"]) for r in out["trace"]
           if r.get("kind") == "event"]
    assert got == _pairs(tmp_path / "j1.jsonl")
    reshard = next(r for r in out["trace"] if r.get("event") == "reshard")
    assert (reshard["from_shards"], reshard["to_shards"]) == (4, 3)
    assert _pairs(tmp_path / "t" / "trace_d0.jsonl") == \
        _pairs(tmp_path / "j0.jsonl")


def test_validator_reshard_desync_rules_match_jax(worlds):
    from dpsvm_tpu.telemetry import validate_trace as jval
    from dpsvm_tpu_torch.observability.report import load_trace
    from dpsvm_tpu_torch.observability.schema import validate_trace
    records = load_trace(str(worlds["tmp"] / "base.jsonl"))
    manifest, rest = records[0], records[1:]
    chunk = next(r for r in rest if r["kind"] == "chunk")
    tail = rest[rest.index(chunk) + 1:]
    reshard = {"kind": "event", "event": "reshard", "n_iter": 0,
               "from_shards": 4, "to_shards": 2, "t": chunk["t"]}
    rewound = dict(chunk, n_iter=0)
    cases = {
        "rewind": [manifest, chunk, reshard, rewound] + tail,
        "no_marker": [manifest, chunk, rewound] + tail,
        "bad_desync": [manifest, chunk, {"kind": "event", "event": "desync",
                                         "n_iter": 5, "t": chunk["t"]}]
        + tail,
        "bad_reshard": [manifest, chunk, {"kind": "event",
                                          "event": "reshard", "n_iter": 0,
                                          "t": chunk["t"]}] + tail,
    }
    for name, recs in cases.items():
        assert bool(validate_trace(recs)) == bool(jval(recs)), name
    assert validate_trace(cases["rewind"]) == []
    assert any("monotone" in e for e in validate_trace(cases["no_marker"]))
    assert any("shards" in e for e in validate_trace(cases["bad_desync"]))
    assert any("from_shards" in e
               for e in validate_trace(cases["bad_reshard"]))

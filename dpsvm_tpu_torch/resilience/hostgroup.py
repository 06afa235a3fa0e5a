"""Host-group supervision: heartbeats, reformation, the admission barrier
(port of ``dpsvm_tpu/resilience/hostgroup.py``).

``elastic.py`` owns the loss of a rank whose world survives to report it.
This module owns the loss of a host: a group of real host processes, one
``python -m dpsvm_tpu_torch.cli train --coordinator ... --num-hosts N
--host-id k`` each, supervised from outside, because a host killed by
SIGKILL runs no recovery and its survivors wait in the next collective for
a peer that never answers.

* **Heartbeat files**: every host writes its liveness fact
  (``host-<id>.json``: n_iter, admitted live generation, publish count,
  pid) into a shared directory at each poll, atomically (tmp + rename).
  The supervisor and ``doctor`` read only these files: detection never
  needs a collective on a group that may already be wedged.
* **run_host_group**: spawns N local hosts on a fresh coordinator port,
  watches their exits and heartbeat ages, and on a loss kills the wedged
  survivors, shrinks the group to N-1 and relaunches on a new port from
  the newest intact checkpoint (the re-shard-on-load path). The resumed
  attempt's trace records ``host_lost`` -> ``reform`` through the
  environment markers below.
* **admission_barrier**: live ingest across hosts. Each host publishes the
  newest manifest generation it has observed and commits only the
  minimum the whole group has published, so a straggler or a dead host
  holds everyone at the last common generation.

Environment (set by the supervisor for its children; absent on a single
host, where every hook here is a no-op): ``DPSVM_HOST_HEARTBEAT_DIR``,
``DPSVM_HOST_ID`` / ``DPSVM_HOST_COUNT``, and on an attempt after a loss
``DPSVM_HOST_LOST`` / ``DPSVM_REFORM_FROM`` / ``DPSVM_REFORM_TO``, which
``solver/driver.begin_trace`` turns into the ``host_lost`` and ``reform``
events.

Faults: ``DPSVM_FAULT_HOST_KILL=m`` makes one host SIGKILL itself at its
m-th poll (the drill's real death); ``DPSVM_FAULT_HOST_HANG_MS=t`` delays
every heartbeat publish and admission poll (the planted straggler).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

ENV_HEARTBEAT_DIR = "DPSVM_HOST_HEARTBEAT_DIR"
ENV_HOST_ID = "DPSVM_HOST_ID"
ENV_HOST_COUNT = "DPSVM_HOST_COUNT"
ENV_HOST_LOST = "DPSVM_HOST_LOST"
ENV_REFORM_FROM = "DPSVM_REFORM_FROM"
ENV_REFORM_TO = "DPSVM_REFORM_TO"

#: Markers that must never leak from one attempt (or an enclosing test)
#: into a freshly spawned host: the supervisor owns them.
_MARKER_VARS = (ENV_HOST_LOST, ENV_REFORM_FROM, ENV_REFORM_TO,
                "DPSVM_RETRY_ATTEMPT")
_FAULT_VARS = ("DPSVM_FAULT_HOST_KILL", "DPSVM_FAULT_HOST_HANG_MS")


def _log(msg: str) -> None:
    print(f"hostgroup: {msg}", file=sys.stderr, flush=True)


# ---------------------------------------------------------------------
# Heartbeat files.

def heartbeat_path(hb_dir: str, host_id: int) -> str:
    return os.path.join(hb_dir, f"host-{int(host_id)}.json")


def write_heartbeat(hb_dir: str, host_id: int, n_iter: int,
                    generation: int = 0, seq: int = 0) -> None:
    """Publish this host's liveness fact atomically. The file's mtime is
    the liveness clock; ``seq`` counts the writer's publishes, so a reader
    tells a stalled host (seq frozen) from a clock step (seq advanced,
    ``t`` went back)."""
    os.makedirs(hb_dir, exist_ok=True)
    path = heartbeat_path(hb_dir, host_id)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump({"host_id": int(host_id), "n_iter": int(n_iter),
                   "generation": int(generation), "seq": int(seq),
                   "t": time.time(), "pid": os.getpid()}, fh)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def read_heartbeats(hb_dir: str) -> Dict[int, dict]:
    """Every parseable heartbeat record by host id; torn or foreign files
    are skipped, never raised."""
    out: Dict[int, dict] = {}
    try:
        names = os.listdir(hb_dir)
    except OSError:
        return out
    for name in names:
        if not (name.startswith("host-") and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(hb_dir, name)) as fh:
                rec = json.load(fh)
            out[int(rec["host_id"])] = rec
        except (OSError, ValueError, KeyError, TypeError):
            continue
    return out


def heartbeat_ages(hb_dir: str,
                   now: Optional[float] = None) -> Dict[int, float]:
    """Seconds since each host's last heartbeat write (file mtime)."""
    now = time.time() if now is None else now
    ages: Dict[int, float] = {}
    for hid in read_heartbeats(hb_dir):
        try:
            ages[hid] = max(0.0, now - os.path.getmtime(
                heartbeat_path(hb_dir, hid)))
        except OSError:
            continue
    return ages


# ---------------------------------------------------------------------
# In-host hooks (the driver's poll, live-ingest admission).

#: This host's last published facts, merged so either writer emits the
#: whole record.
_STATE = {"n_iter": 0, "generation": 0, "seq": 0}


def _fault_hang() -> None:
    """The planted straggler's sleep, before a publish."""
    hang_ms = os.environ.get("DPSVM_FAULT_HOST_HANG_MS", "").strip()
    if hang_ms.isdigit() and int(hang_ms):
        time.sleep(int(hang_ms) / 1000.0)


def _group() -> Optional[tuple]:
    """(heartbeat_dir, host_id, host_count) inside a supervised host
    group, else None (read from the environment on every call)."""
    hb_dir = os.environ.get(ENV_HEARTBEAT_DIR, "").strip()
    if not hb_dir:
        return None
    try:
        hid = int(os.environ.get(ENV_HOST_ID, "0") or 0)
        count = int(os.environ.get(ENV_HOST_COUNT, "1") or 1)
    except ValueError:
        return None
    return hb_dir, hid, count


def note_poll_heartbeat(n_iter: int) -> None:
    """The driver's poll hook: publish liveness. A no-op outside a host
    group; never raises (a full disk must not kill training: the
    supervisor sees the age grow instead)."""
    grp = _group()
    if grp is None:
        return
    hb_dir, hid, _ = grp
    _fault_hang()
    _STATE["n_iter"] = int(n_iter)
    _STATE["seq"] += 1
    try:
        write_heartbeat(hb_dir, hid, _STATE["n_iter"],
                        _STATE["generation"], _STATE["seq"])
    except OSError as e:
        _log(f"heartbeat write failed ({e}); continuing")


def admission_barrier(observed_gen: int, committed_gen: int) -> int:
    """The generation this host may commit, having observed
    ``observed_gen`` and consumed ``committed_gen``.

    Outside a host group: ``observed_gen``. Inside one: publish it in the
    heartbeat, read the group's published generations and return their
    minimum, floored at ``committed_gen`` (never backwards). A member with
    no heartbeat yet (starting, hung or dead) holds the group at
    ``committed_gen``; so does a failed publish."""
    grp = _group()
    if grp is None:
        return int(observed_gen)
    hb_dir, hid, count = grp
    _fault_hang()
    _STATE["generation"] = max(_STATE["generation"], int(observed_gen))
    _STATE["seq"] += 1
    try:
        write_heartbeat(hb_dir, hid, _STATE["n_iter"],
                        _STATE["generation"], _STATE["seq"])
    except OSError as e:
        _log(f"heartbeat write failed ({e}); holding admission")
        return int(committed_gen)
    beats = read_heartbeats(hb_dir)
    gens: List[int] = []
    for k in range(count):
        rec = beats.get(k)
        if rec is None:
            return int(committed_gen)
        gens.append(int(rec.get("generation", 0)))
    return max(int(committed_gen), min(gens))


# ---------------------------------------------------------------------
# The reformation supervisor.

class HostGroupError(RuntimeError):
    """The group died in a way reformation cannot fix: a non-transient
    exit, or the retry or min-host budget ran out."""


@dataclass
class HostGroupResult:
    """What a supervised run did: attempts, the final group size, the
    hosts lost (in order) and the detection -> every reformed host beating
    latency of the last loss."""
    attempts: int
    hosts: int
    losses: List[int] = field(default_factory=list)
    recovery_s: float = 0.0


def _clean_child_env(base: Dict[str, str]) -> Dict[str, str]:
    env = dict(base)
    for k in _MARKER_VARS + _FAULT_VARS:
        env.pop(k, None)
    return env


def _kill_group(procs: Dict[int, subprocess.Popen],
                grace_s: float) -> None:
    """SIGTERM the running children, ``grace_s`` to die, then SIGKILL:
    survivors of a host loss wait in a collective, where SIGTERM's
    deferred handler never runs."""
    for p in procs.values():
        if p.poll() is None:
            try:
                p.terminate()
            except OSError:
                pass
    deadline = time.time() + grace_s
    for p in procs.values():
        while p.poll() is None and time.time() < deadline:
            time.sleep(0.05)
        if p.poll() is None:
            try:
                p.kill()
            except OSError:
                pass
        p.wait()


def run_host_group(
    make_argv: Callable[[int, int, str, int], Sequence[str]],
    *,
    num_hosts: int,
    heartbeat_dir: str,
    checkpoint_path: Optional[str] = None,
    retries: int = 1,
    deadline_s: float = 60.0,
    min_hosts: int = 1,
    poll_s: float = 0.2,
    grace_s: float = 5.0,
    env_base: Optional[Dict[str, str]] = None,
    first_attempt_env: Optional[Dict[int, Dict[str, str]]] = None,
) -> HostGroupResult:
    """Spawn and supervise a local host group; reform on a loss.

    ``make_argv(host_id, hosts, coordinator, attempt)`` builds one host's
    command line. Each attempt gets a fresh coordinator port and, when
    ``checkpoint_path`` has an intact slot, ``--resume`` as the retry
    supervisor injects it. ``first_attempt_env`` plants per-host fault
    variables on attempt 0 only, so a reformed group cannot inherit its
    own death. A host's device is its command line's.

    Detection needs no collective: a child exiting with a transient code
    or signal (``supervisor.is_transient``), or a heartbeat (or, before
    the first, the spawn) older than ``deadline_s``. The survivors are
    killed, the group shrinks by the lost host and the next attempt's
    environment carries the ``host_lost``/``reform`` markers.
    ``recovery_s`` is detection -> every reformed host's first
    heartbeat."""
    from dpsvm_tpu_torch.parallel import multihost
    from dpsvm_tpu_torch.resilience import supervisor

    if num_hosts < 1:
        raise ValueError("num_hosts must be >= 1")
    hosts = int(num_hosts)
    attempt = 0
    losses: List[int] = []
    recovery_s = 0.0
    detection_t: Optional[float] = None
    base_env = _clean_child_env(
        dict(os.environ) if env_base is None else dict(env_base))

    while True:
        coordinator = f"127.0.0.1:{multihost.find_free_port()}"
        os.makedirs(heartbeat_dir, exist_ok=True)
        for name in os.listdir(heartbeat_dir):
            if name.startswith("host-"):
                try:
                    os.unlink(os.path.join(heartbeat_dir, name))
                except OSError:
                    pass
        best, skipped = supervisor.newest_intact(checkpoint_path)
        if skipped and best:
            _log(f"skipping unreadable checkpoint slot(s) {skipped} "
                 f"-> resuming {best}")
        procs: Dict[int, subprocess.Popen] = {}
        spawn_t = time.time()
        for hid in range(hosts):
            env = dict(base_env)
            env[ENV_HOST_ID] = str(hid)
            env[ENV_HEARTBEAT_DIR] = heartbeat_dir
            env[ENV_HOST_COUNT] = str(hosts)
            if attempt:
                env["DPSVM_RETRY_ATTEMPT"] = str(attempt)
                env[ENV_HOST_LOST] = str(losses[-1])
                env[ENV_REFORM_FROM] = str(hosts + 1)
                env[ENV_REFORM_TO] = str(hosts)
            elif first_attempt_env and hid in first_attempt_env:
                env.update(first_attempt_env[hid])
            argv = list(make_argv(hid, hosts, coordinator, attempt))
            if best:
                argv = supervisor.with_resume(argv, best)
            procs[hid] = subprocess.Popen(argv, env=env)
        if attempt:
            _log(f"attempt {attempt}: reformed to {hosts} host(s) on "
                 f"{coordinator}" + (f", resuming {best}" if best else ""))

        lost: Optional[int] = None
        lost_reason = ""
        beating: set = set()
        while True:
            time.sleep(poll_s)
            now = time.time()
            rcs = {hid: p.poll() for hid, p in procs.items()}
            exited_bad = {hid: rc for hid, rc in rcs.items()
                          if rc is not None and rc != 0}
            if exited_bad:
                # A SIGKILLed host's gloo peers fail within moments with
                # ordinary error exits: the transient death is the root
                # cause, the rest collateral. Only a group with no
                # transient exit is a real command failure.
                transient = {h: rc for h, rc in exited_bad.items()
                             if supervisor.is_transient(rc)}
                if not transient:
                    lost, rc = sorted(exited_bad.items())[0]
                    _kill_group(procs, grace_s)
                    raise HostGroupError(
                        f"host {lost} exited {rc} (non-transient) on "
                        f"attempt {attempt}")
                lost, rc = sorted(transient.items())[0]
                lost_reason = f"exit {rc}"
                break
            ages = heartbeat_ages(heartbeat_dir, now=now)
            beating |= set(ages)
            if detection_t is not None and len(beating) >= len(procs):
                recovery_s = now - detection_t
                detection_t = None
                _log(f"recovered: all {hosts} host(s) beating "
                     f"{recovery_s:.2f}s after loss detection")
            if all(rc == 0 for rc in rcs.values()):
                return HostGroupResult(attempts=attempt + 1, hosts=hosts,
                                       losses=losses,
                                       recovery_s=recovery_s)
            for hid in procs:
                if rcs[hid] is not None:
                    continue
                age = ages.get(hid, now - spawn_t)
                if age > deadline_s:
                    lost = hid
                    lost_reason = f"heartbeat {age:.1f}s old"
                    break
            if lost is not None:
                break

        detection_t = time.time()
        _log(f"host {lost} lost ({lost_reason}); killing the wedged "
             f"survivors")
        _kill_group(procs, grace_s)
        if hosts - 1 < min_hosts:
            raise HostGroupError(
                f"host {lost} lost but the group cannot shrink below "
                f"min_hosts={min_hosts}")
        if attempt >= retries:
            raise HostGroupError(
                f"host {lost} lost but the retry budget ({retries}) "
                f"is exhausted")
        losses.append(int(lost))
        hosts -= 1
        attempt += 1


# ---------------------------------------------------------------------
# The kill-one-host drill.

def host_loss_drill(tmp_dir: str, *, device: str = "cuda",
                    num_hosts: int = 3, kill_host: int = 1,
                    kill_poll: int = 3, deadline_s: float = 120.0) -> dict:
    """Host-loss recovery end to end on this machine: train the
    distributed pair across ``num_hosts`` real host processes, gloo ranks
    on ``device`` (on the card they share it: ``train --dist-backend
    gloo``, collectives staged through the host, since NCCL runs one rank
    a card), SIGKILL one mid-run (``DPSVM_FAULT_HOST_KILL``), and
    require the survivors to reform and land on the model of an
    uninterrupted ``train --shards num_hosts`` within 1e-4 (the
    survivors' mesh differs, as in the kill-shard drill; ``bitwise``
    reports exact agreement). The reformed trace must run ``host_lost``
    -> ``reform`` and validate. Returns the drill facts; raises on any
    failed expectation."""
    import numpy as np

    from dpsvm_tpu_torch.data.synthetic import make_blobs
    from dpsvm_tpu_torch.device import resolve_device
    from dpsvm_tpu_torch.models.io import load_model
    from dpsvm_tpu_torch.observability import ledger
    from dpsvm_tpu_torch.observability.report import read_trace
    from dpsvm_tpu_torch.observability.schema import validate_trace

    placement = (["--device", "cuda", "--dist-backend", "gloo"]
                 if resolve_device(device).type == "cuda"
                 else ["--device", "cpu"])
    tmp = os.path.abspath(tmp_dir)
    os.makedirs(tmp, exist_ok=True)
    x, y = make_blobs(n=64, d=4, seed=11)
    data = os.path.join(tmp, "drill.csv")
    with open(data, "w") as fh:
        for row, label in zip(x, y):
            fh.write(f"{int(label)}," +
                     ",".join(f"{v:.9g}" for v in row) + "\n")

    def train_argv(model: str, shards: int, trace: str,
                   extra: Sequence[str] = ()) -> List[str]:
        return [sys.executable, "-m", "dpsvm_tpu_torch.cli", "train",
                "-f", data, "-m", model, "--shards", str(shards),
                "-c", "1.0", "-g", "0.5", "-e", "1e-12", "-n", "300",
                "--chunk-iters", "25", "--no-tuned", "--quiet", *placement,
                "--trace-out", trace, *extra]

    env0 = _clean_child_env(dict(os.environ))
    env0.pop(ENV_HEARTBEAT_DIR, None)
    # the uninterrupted reference runs beside the group
    ref_model = os.path.join(tmp, "model_ref.txt")
    ref_proc = subprocess.Popen(
        train_argv(ref_model, num_hosts,
                   os.path.join(tmp, "trace_ref.jsonl")), env=env0)

    ck = os.path.join(tmp, "group.npz")
    hb_dir = os.path.join(tmp, "heartbeats")

    def make_argv(hid: int, hosts: int, coordinator: str,
                  attempt: int) -> List[str]:
        return train_argv(
            os.path.join(tmp, f"model_h{hid}_a{attempt}.txt"), hosts,
            os.path.join(tmp, f"trace_h{hid}_a{attempt}.jsonl"),
            extra=["--coordinator", coordinator,
                   "--num-hosts", str(hosts), "--host-id", str(hid),
                   "--checkpoint", ck, "--checkpoint-every", "50",
                   "--checkpoint-keep", "2"])

    t0 = time.time()
    res = run_host_group(
        make_argv, num_hosts=num_hosts, heartbeat_dir=hb_dir,
        checkpoint_path=ck, retries=1, deadline_s=30.0, env_base=env0,
        first_attempt_env={int(kill_host): {
            "DPSVM_FAULT_HOST_KILL": str(int(kill_poll))}})
    wall_s = time.time() - t0
    try:
        ref_rc = ref_proc.wait(timeout=deadline_s)
    except subprocess.TimeoutExpired:
        ref_proc.kill()
        ref_proc.wait()
        raise
    if ref_rc != 0:
        raise AssertionError(f"drill: the reference run exited {ref_rc}")

    if res.losses != [int(kill_host)]:
        raise AssertionError(
            f"drill expected host {kill_host} lost, got {res.losses}")
    if res.hosts != num_hosts - 1:
        raise AssertionError(
            f"drill expected a reformed {num_hosts - 1}-host group, "
            f"got {res.hosts}")

    ref = load_model(ref_model)
    got = load_model(os.path.join(tmp, "model_h0_a1.txt"))
    if ref.alpha.shape != got.alpha.shape:
        raise AssertionError(
            f"drill: recovered SV set differs in size "
            f"({got.alpha.shape} vs {ref.alpha.shape})")
    coef_delta = float(np.max(np.abs(
        np.asarray(ref.alpha) * np.asarray(ref.y_sv)
        - np.asarray(got.alpha) * np.asarray(got.y_sv))))
    b_delta = float(abs(float(ref.b) - float(got.b)))
    if coef_delta > 1e-4 or b_delta > 1e-4:
        raise AssertionError(
            f"drill: recovered model disagrees with the uninterrupted "
            f"{num_hosts}-host run (coef delta {coef_delta:g}, b delta "
            f"{b_delta:g}, tolerance 1e-4)")
    bitwise = bool(coef_delta == 0.0 and b_delta == 0.0
                   and np.array_equal(np.asarray(ref.x_sv),
                                      np.asarray(got.x_sv)))

    trace = read_trace(os.path.join(tmp, "trace_h0_a1.jsonl"))
    events = [r["event"] for r in trace if r.get("kind") == "event"]
    for want in ("host_lost", "reform"):
        if want not in events:
            raise AssertionError(
                f"drill: reformed trace missing {want} (events: {events})")
    if events.index("host_lost") > events.index("reform"):
        raise AssertionError(
            f"drill: host_lost must precede reform (events: {events})")
    errs = validate_trace(trace)
    if errs:
        raise AssertionError(
            f"drill: reformed trace fails schema validation: {errs}")

    facts = {
        "metric": "host_loss_recovery_s",
        "host_loss_recovery_s": round(res.recovery_s, 3),
        "drill_wall_s": round(wall_s, 3),
        "hosts": num_hosts,
        "surviving_hosts": res.hosts,
        "losses": res.losses,
        "attempts": res.attempts,
        "coef_delta": coef_delta,
        "b_delta": b_delta,
        "bitwise": bitwise,
        "events": events,
    }
    ledger.append("host_loss_drill", facts, kind="robust",
                  value=facts["host_loss_recovery_s"], unit="s",
                  direction="lower", host_count=num_hosts)
    return facts

"""Deterministic fault injection (port of
``dpsvm_tpu/resilience/faultinject.py``): the knobs of the training
driver, the checkpoint writer, the distributed and multi-host drills, the
doctor, the cascade (``solver/cascade.py``), the shard reader
(``data/stream.py``), the live shard log (``data/live.py``) and the
serving pool and registry.

``DPSVM_FAULT_CASCADE_STOP_STAGE=k`` (or ``BENCH_FAULT_CASCADE_STOP_STAGE``)
makes the cascade raise ``CascadeInterrupted`` right after its stage-k
boundary state is durable on disk (1 = approx warm-start, 2 = screening,
3 = the first polish round): the kill->resume drill's kill point, after
which re-running the same command must land a bitwise-identical model.
``install(FaultPlan(cascade_stop_stage=k))`` is the same from Python.

Data-pipeline knobs (``DPSVM_FAULT_IO_*``, consumed by the shard reader;
shard numbers are 1-based):

* ``DPSVM_FAULT_IO_READ_FAIL_ONCE=k``: the k-th shard read in this process
  raises a transient ``OSError`` exactly once (the bounded retry recovers
  it);
* ``DPSVM_FAULT_IO_CORRUPT_SHARD=k``: shard #k reads with a flipped
  payload byte on every read (a rotted file stays rotted), so the manifest
  CRC check fails and the ``on_bad_shard`` policy fires;
* ``DPSVM_FAULT_IO_TRUNCATE_SHARD=k``: shard #k reads as a file cut to
  half its bytes on every read (an unreadable npz);
* ``DPSVM_FAULT_IO_SLOW_READ_MS=t``: every shard read sleeps t ms first.

Live shard-log knobs (``DPSVM_FAULT_LIVE_*``, consumed by the writer side
of ``data/live.py``; publish and append counts are 1-based):

* ``DPSVM_FAULT_LIVE_TORN_PUBLISH=k``: the k-th manifest publish writes
  half its bytes in place, non-atomically, then the writer crashes
  (``WriterCrashError``): readers hold their view, and the restarted
  writer recovers from ``manifest.json.prev``;
* ``DPSVM_FAULT_LIVE_STALE_GENERATION=k``: the k-th publish writes
  CRC-valid bytes whose generation did not advance (a replayed or
  split-brain writer), which readers refuse;
* ``DPSVM_FAULT_LIVE_WRITER_CRASH_AFTER=k``: the writer crashes after
  appended shard #k is durable, before its publish (an orphan shard no
  manifest names);
* ``DPSVM_FAULT_LIVE_SHIFT_AT_SHARD=k``: the subprocess writer draws
  appended shard #k and every later one from a shifted distribution.

Serving (``DPSVM_FAULT_SERVE_*``, consumed by ``serving/pool.py`` and
``serving/registry.py``):

* ``DPSVM_FAULT_SERVE_WEDGE_REPLICA=k``: replica #k (1-based) wedges:
  its worker blocks at the next compute, before the engine is called
  (release with ``release_serve_wedge()`` in in-process tests; a chaos
  subprocess abandons the daemon thread). With
  ``DPSVM_FAULT_SERVE_WEDGE_AFTER=m`` the wedge waits until the pool
  has served m computes;
* ``DPSVM_FAULT_SERVE_NAN_AFTER=m``: the replica that serves the m-th
  pool compute is NaN-poisoned for its current generation: every
  output it gives is non-finite until the pool rebuilds it;
* ``DPSVM_FAULT_SERVE_FAIL_RELOAD=j``: the j-th engine reload or
  rebuild in this process raises before it loads anything, so the old
  engine stays live;
* ``DPSVM_FAULT_SERVE_SLOW_REPLICA_MS=t``: every replica compute sleeps
  t ms first (the 504 storm that must fire the serving burn-rate
  alert); with ``DPSVM_FAULT_SERVE_SLOW_FOR=m`` only the first m
  computes are slowed, and the alert must then clear.

Training knobs (consumed by the shared host driver, ``solver/driver.py``,
and ``utils/checkpoint.save_checkpoint``):

* ``DPSVM_FAULT_CHECKPOINT_WRITE=k``: the k-th ``save_checkpoint`` call in
  this process fails after the tmp write, before the rename (the old file
  and the run survive);
* ``DPSVM_FAULT_NAN_ITER=j``: the first poll observing ``n_iter >= j``
  reports a NaN gap (the host's view only: the device state is intact);
* ``DPSVM_FAULT_PREEMPT_POLL=m``: the m-th host poll raises a simulated
  preemption signal.

Distributed knobs (shard numbers 1-based; every rank of a world reads the
same replicated stats, so every rank fires at the same poll):

* ``DPSVM_FAULT_DIST_KILL_SHARD=k``: shard #k is lost at a distributed
  poll (``DPSVM_FAULT_DIST_KILL_POLL=m``, default the 2nd): the driver
  raises ``elastic.ShardLostError`` with no snapshot;
* ``DPSVM_FAULT_DIST_DESYNC_AT=j``: the first poll observing
  ``n_iter >= j`` reports one shard's probe (``DIST_DESYNC_SHARD``,
  default the last) one bit off the rest;
* ``DPSVM_FAULT_DIST_SLOW_SHARD=k``: shard #k's probe replays its
  first-seen row every poll (the straggler model).

Multi-host knobs (planted in one host process's environment):

* ``DPSVM_FAULT_HOST_KILL=m``: this process SIGKILLs itself at its m-th
  host poll;
* ``DPSVM_FAULT_HOST_HANG_MS=t``: this process sleeps t ms before every
  heartbeat publish and admission poll.

``DPSVM_FAULT_PREFLIGHT_WEDGE_S=t``: the doctor's collective probe hangs
t seconds first (past the doctor's timeout: exit 5).

Every knob fires once a process (counters live on the plan), so a retry in
the same process runs clean: the transient-fault model.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import threading
import time
from typing import Optional, Tuple

import numpy as np


def _log(msg: str) -> None:
    print(f"FAULTINJECT: {msg}", file=sys.stderr, flush=True)


_IO_LOCK = threading.Lock()
_SERVE_LOCK = threading.Lock()


class InjectedFaultError(OSError):
    """The transient read failure the I/O knobs inject (an OSError, like
    the real failures it stands in for)."""


@dataclasses.dataclass
class FaultPlan:
    # training knobs (module docstring)
    fail_checkpoint_write: int = 0   # 1-based save counter; 0 = off
    nan_at_iter: int = 0             # poison first poll with n_iter >= j
    preempt_at_poll: int = 0         # 1-based host-poll counter
    # distributed knobs: shard numbers 1-based
    dist_kill_shard: int = 0         # shard #k lost at a dist poll
    dist_kill_poll: int = 0          # ...the m-th dist poll (default 2)
    dist_desync_at: int = 0          # poison a probe at n_iter >= j
    dist_desync_shard: int = 0       # which shard lies (default last)
    dist_slow_shard: int = 0         # shard #k's probe stops advancing
    # multi-host knobs, planted per host
    host_kill: int = 0               # SIGKILL self at the m-th host poll
    host_hang_ms: int = 0            # sleep before heartbeats/admissions
    preflight_wedge_s: int = 0       # the doctor's probe hangs this long
    # data-pipeline knobs (module docstring): shard numbers 1-based
    io_read_fail_once: int = 0       # the k-th shard read fails once
    io_corrupt_shard: int = 0        # shard #k payload bit-flipped, every
                                     # read
    io_truncate_shard: int = 0       # shard #k reads half its bytes
    io_slow_read_ms: int = 0         # every shard read sleeps this
    cascade_stop_stage: int = 0      # kill the cascade right after the
                                     # stage-k boundary state (0 = off)
    # live shard-log knobs (module docstring): 1-based counts
    live_torn_publish: int = 0       # the k-th publish tears mid-write
    live_stale_generation: int = 0   # the k-th publish replays its old
                                     # generation (CRC-valid, stale)
    live_writer_crash_after: int = 0  # crash after shard #k is durable,
                                     # before its publish
    live_shift_at_shard: int = 0     # appended shard #k on is shifted
    serve_wedge_replica: int = 0     # replica #k wedges at a compute
    serve_wedge_after: int = 0       # ...once pool computes >= m
    serve_nan_after: int = 0         # poison the replica serving
                                     # pool compute #m
    serve_fail_reload: int = 0       # the j-th reload/rebuild fails
    serve_slow_replica_ms: int = 0   # every compute sleeps this first
    serve_slow_for: int = 0          # ...only the first m computes
    _writes: int = 0
    _polls: int = 0
    _nan_fired: bool = False
    _dist_polls: int = 0
    _kill_fired: bool = False
    _host_polls: int = 0
    _desync_fired: bool = False
    _slow_probe: Optional[tuple] = None   # frozen probe row replayed
    _cascade_fired: bool = False
    _io_reads: int = 0
    _io_fail_fired: bool = False
    _live_publishes: int = 0
    _live_appends: int = 0
    _torn_fired: bool = False
    _stale_fired: bool = False
    _writer_crash_fired: bool = False
    _serve_reloads: int = 0
    _serve_computes: int = 0
    _wedge_fired: bool = False
    _poisoned: Optional[Tuple[int, int]] = None  # (replica, generation)
    _slow_computes: int = 0
    _slow_lifted_logged: bool = False

    def any(self) -> bool:
        return bool(self.fail_checkpoint_write or self.nan_at_iter
                    or self.preempt_at_poll or self.dist_kill_shard
                    or self.dist_desync_at or self.dist_slow_shard
                    or self.host_kill or self.host_hang_ms
                    or self.preflight_wedge_s
                    or self.io_read_fail_once or self.io_corrupt_shard
                    or self.io_truncate_shard or self.io_slow_read_ms
                    or self.cascade_stop_stage or self.live_torn_publish
                    or self.live_stale_generation
                    or self.live_writer_crash_after
                    or self.live_shift_at_shard or self.serve_fail_reload
                    or self.serve_wedge_replica or self.serve_nan_after
                    or self.serve_slow_replica_ms)

    # -- training injection points (solver/driver.py), one host loop

    def note_checkpoint_write(self, path: str) -> None:
        self._writes += 1
        if (self.fail_checkpoint_write
                and self._writes == self.fail_checkpoint_write):
            _log(f"failing checkpoint write #{self._writes} -> {path}")
            raise InjectedFaultError(
                f"injected checkpoint-write failure #{self._writes}")

    def note_poll(self) -> bool:
        """True exactly at the configured poll: the driver then simulates
        a preemption signal."""
        self._polls += 1
        if self.preempt_at_poll and self._polls == self.preempt_at_poll:
            _log(f"simulating preemption at poll #{self._polls}")
            return True
        return False

    def poison_stats(self, st):
        """b_lo as NaN on the first qualifying poll (device-state
        corruption seen at the poll boundary), and the probe faults
        (desync, slow shard) applied to the probe tail (``st.probe``,
        one row a rank) when one rides the stats."""
        if (self.nan_at_iter and not self._nan_fired
                and st.n_iter >= self.nan_at_iter):
            self._nan_fired = True
            _log(f"poisoning stats with NaN gap at iter {st.n_iter}")
            st = st._replace(b_lo=float("nan"))
        if st.probe and (self.dist_desync_at or self.dist_slow_shard):
            rows = self.poison_probes(np.asarray(st.probe), st.n_iter)
            st = st._replace(probe=tuple(tuple(int(v) for v in row)
                                         for row in rows))
        return st

    def poison_probes(self, probes, n_iter: int):
        """The probe faults on a (P, 3) int32 block: desync flips one
        bit of one shard's b_lo lane once (the smallest disagreement at
        the same iteration); the slow shard replays its first-seen row
        every poll, so its heartbeat ages."""
        probes = np.array(probes, np.int32, copy=True)
        p = len(probes)
        if (self.dist_desync_at and not self._desync_fired
                and n_iter >= self.dist_desync_at and p > 1):
            self._desync_fired = True
            k = ((self.dist_desync_shard - 1) % p
                 if self.dist_desync_shard else p - 1)
            probes[k, 1] ^= 1
            _log(f"desyncing shard {k} probe at iter {n_iter}")
        if self.dist_slow_shard and p >= self.dist_slow_shard:
            k = self.dist_slow_shard - 1
            if self._slow_probe is None:
                self._slow_probe = tuple(int(v) for v in probes[k])
                _log(f"freezing shard {k} probe (straggler model)")
            probes[k] = self._slow_probe
        return probes

    def dist_kill_now(self) -> int:
        """Counted a distributed poll; the 1-based shard to lose,
        exactly once (0 = keep running)."""
        if not self.dist_kill_shard:
            return 0
        self._dist_polls += 1
        at = self.dist_kill_poll or 2
        if not self._kill_fired and self._dist_polls >= at:
            self._kill_fired = True
            _log(f"killing shard #{self.dist_kill_shard} at dist poll "
                 f"#{self._dist_polls}")
            return self.dist_kill_shard
        return 0

    def host_kill_now(self) -> bool:
        """Counted a host poll; True at the configured poll, where the
        driver SIGKILLs its own process (a real host death)."""
        if not self.host_kill:
            return False
        self._host_polls += 1
        if self._host_polls >= self.host_kill:
            _log(f"SIGKILLing this host at host poll #{self._host_polls}")
            return True
        return False

    def host_hang_delay_s(self) -> float:
        """Seconds a heartbeat publish or admission poll sleeps."""
        return self.host_hang_ms / 1000.0

    def io_read_begin(self, shard_idx: int) -> None:
        """Called as a shard read starts: applies the slow-read latency
        and raises the one transient read failure. Reads may start on
        several threads (the streaming fit reads ahead), so the count is
        taken under a lock: the k-th read to start fails."""
        if self.io_slow_read_ms:
            time.sleep(self.io_slow_read_ms / 1000.0)
        with _IO_LOCK:
            self._io_reads += 1
            nth = self._io_reads
            fire = (self.io_read_fail_once and not self._io_fail_fired
                    and nth >= self.io_read_fail_once)
            if fire:
                self._io_fail_fired = True
        if fire:
            _log(f"failing shard read #{nth} (shard {shard_idx}) once")
            raise InjectedFaultError(
                f"injected transient read failure at shard read #{nth}")

    def io_corrupt_now(self, shard_idx: int) -> bool:
        """True when shard #(idx+1) reads with a flipped payload byte:
        every read, unlike the fire-once transient knob."""
        return bool(self.io_corrupt_shard
                    and shard_idx + 1 == self.io_corrupt_shard)

    def io_truncate_now(self, shard_idx: int) -> bool:
        """True when shard #(idx+1) reads as a half-length file (every
        read, like corruption)."""
        return bool(self.io_truncate_shard
                    and shard_idx + 1 == self.io_truncate_shard)

    # -- live shard-log injection points (data/live.py), one writer loop

    def live_append_begin(self) -> bool:
        """Counted per durable appended shard, before its publish. True
        exactly once, when the writer should crash with the shard on disk
        but unpublished (the orphan-shard model)."""
        self._live_appends += 1
        if (self.live_writer_crash_after and not self._writer_crash_fired
                and self._live_appends >= self.live_writer_crash_after):
            self._writer_crash_fired = True
            _log(f"crashing writer after appended shard "
                 f"#{self._live_appends} (pre-publish)")
            return True
        return False

    def live_publish_mode(self) -> str:
        """Counted per manifest publish: "clean", "torn" (half the bytes
        written non-atomically onto the manifest, then a crash) or
        "stale" (CRC-valid bytes whose generation did not advance). Each
        fires once."""
        self._live_publishes += 1
        if (self.live_torn_publish and not self._torn_fired
                and self._live_publishes >= self.live_torn_publish):
            self._torn_fired = True
            _log(f"tearing manifest publish #{self._live_publishes}")
            return "torn"
        if (self.live_stale_generation and not self._stale_fired
                and self._live_publishes >= self.live_stale_generation):
            self._stale_fired = True
            _log(f"replaying stale generation at publish "
                 f"#{self._live_publishes}")
            return "stale"
        return "clean"

    def live_shift_now(self, append_idx: int) -> bool:
        """True when appended shard #(idx+1), and every later one, is
        drawn from the shifted distribution."""
        return bool(self.live_shift_at_shard
                    and append_idx + 1 >= self.live_shift_at_shard)

    # -- serving-side injection points (serving/pool.py): hit from
    # concurrent replica workers, so counters advance under the serve
    # lock.

    def note_serve_compute(self, replica_idx: int,
                           generation: int) -> bool:
        """Called by a replica worker as a compute begins. Returns True
        exactly when THIS compute should wedge (the worker then blocks
        on the module wedge event). Also arms the NaN poison: the
        replica serving the m-th pool compute becomes poisoned for its
        current generation."""
        with _SERVE_LOCK:
            self._serve_computes += 1
            if (self.serve_wedge_replica and not self._wedge_fired
                    and replica_idx == self.serve_wedge_replica - 1
                    and self._serve_computes >= self.serve_wedge_after):
                self._wedge_fired = True
                _log(f"wedging replica #{self.serve_wedge_replica} at "
                     f"pool compute #{self._serve_computes}")
                return True
            if (self.serve_nan_after and self._poisoned is None
                    and self._serve_computes >= self.serve_nan_after):
                self._poisoned = (int(replica_idx), int(generation))
                _log(f"NaN-poisoning replica {replica_idx} "
                     f"(generation {generation}) from pool compute "
                     f"#{self._serve_computes}")
            return False

    def serve_slow_delay_s(self) -> float:
        """Seconds THIS replica compute must sleep (0.0 = run clean).
        With ``serve_slow_for`` set, only the first m computes are
        slowed; without it the slowness persists for the process."""
        if not self.serve_slow_replica_ms:
            return 0.0
        with _SERVE_LOCK:
            self._slow_computes += 1
            if (self.serve_slow_for
                    and self._slow_computes > self.serve_slow_for):
                if not self._slow_lifted_logged:
                    self._slow_lifted_logged = True
                    _log(f"slow-replica fault lifted after "
                         f"{self.serve_slow_for} computes")
                return 0.0
            return self.serve_slow_replica_ms / 1000.0

    def serve_poisoned(self, replica_idx: int, generation: int) -> bool:
        """True while (replica, generation) is the poisoned one: a
        rebuilt replica (new generation) runs clean."""
        with _SERVE_LOCK:
            return self._poisoned == (int(replica_idx), int(generation))

    def note_serve_reload(self) -> None:
        """Reload/rebuild injection point (``ModelRegistry.reload`` and
        the pool's rebuild): the j-th call in this process raises."""
        with _SERVE_LOCK:
            self._serve_reloads += 1
            n = self._serve_reloads
            fire = self.serve_fail_reload and n == self.serve_fail_reload
        if fire:
            _log(f"failing serve reload #{n}")
            raise InjectedFaultError(f"injected reload failure #{n}")

    def cascade_stop_now(self, stage: int) -> bool:
        """True exactly once, when the cascade has made the stage-k
        boundary state durable (k = ``cascade_stop_stage``)."""
        if (self.cascade_stop_stage and not self._cascade_fired
                and stage >= self.cascade_stop_stage):
            self._cascade_fired = True
            _log(f"stopping cascade after stage-{stage} boundary")
            return True
        return False


_plan: Optional[FaultPlan] = None
_env_checked = False


def _env_int(name: str) -> int:
    for prefix in ("DPSVM_FAULT_", "BENCH_FAULT_"):
        v = os.environ.get(prefix + name, "").strip()
        if v:
            try:
                return int(v)
            except ValueError:
                _log(f"ignoring non-integer {prefix}{name}={v!r}")
    return 0


def plan_from_env() -> Optional[FaultPlan]:
    p = FaultPlan(
        fail_checkpoint_write=_env_int("CHECKPOINT_WRITE"),
        nan_at_iter=_env_int("NAN_ITER"),
        preempt_at_poll=_env_int("PREEMPT_POLL"),
        dist_kill_shard=_env_int("DIST_KILL_SHARD"),
        dist_kill_poll=_env_int("DIST_KILL_POLL"),
        dist_desync_at=_env_int("DIST_DESYNC_AT"),
        dist_desync_shard=_env_int("DIST_DESYNC_SHARD"),
        dist_slow_shard=_env_int("DIST_SLOW_SHARD"),
        host_kill=_env_int("HOST_KILL"),
        host_hang_ms=_env_int("HOST_HANG_MS"),
        preflight_wedge_s=_env_int("PREFLIGHT_WEDGE_S"),
        io_read_fail_once=_env_int("IO_READ_FAIL_ONCE"),
        io_corrupt_shard=_env_int("IO_CORRUPT_SHARD"),
        io_truncate_shard=_env_int("IO_TRUNCATE_SHARD"),
        io_slow_read_ms=_env_int("IO_SLOW_READ_MS"),
        cascade_stop_stage=_env_int("CASCADE_STOP_STAGE"),
        live_torn_publish=_env_int("LIVE_TORN_PUBLISH"),
        live_stale_generation=_env_int("LIVE_STALE_GENERATION"),
        live_writer_crash_after=_env_int("LIVE_WRITER_CRASH_AFTER"),
        live_shift_at_shard=_env_int("LIVE_SHIFT_AT_SHARD"),
        serve_wedge_replica=_env_int("SERVE_WEDGE_REPLICA"),
        serve_wedge_after=_env_int("SERVE_WEDGE_AFTER"),
        serve_nan_after=_env_int("SERVE_NAN_AFTER"),
        serve_fail_reload=_env_int("SERVE_FAIL_RELOAD"),
        serve_slow_replica_ms=_env_int("SERVE_SLOW_REPLICA_MS"),
        serve_slow_for=_env_int("SERVE_SLOW_FOR"))
    return p if p.any() else None


def install(plan: Optional[FaultPlan]) -> Optional[FaultPlan]:
    """Set (or with None, clear) the process fault plan: the API-level
    seam tests use instead of environment variables."""
    global _plan, _env_checked
    _plan = plan
    _env_checked = True
    return plan


def clear() -> None:
    global _plan, _env_checked
    _plan = None
    _env_checked = False


def current() -> Optional[FaultPlan]:
    """The active plan: an installed one, else the environment's (read
    once a process), else None."""
    global _plan, _env_checked
    if not _env_checked:
        _env_checked = True
        _plan = plan_from_env()
        if _plan is not None:
            _log(f"active plan: {_plan}")
    return _plan


def on_checkpoint_write(path: str) -> None:
    """``save_checkpoint``'s injection point (utils/checkpoint.py)."""
    p = current()
    if p is not None:
        p.note_checkpoint_write(path)


# Wedged replica workers block here. In-process tests release them at
# teardown; a chaos subprocess just exits around the daemon thread.
_WEDGE_EVENT = threading.Event()


def serve_wedge_wait(timeout: Optional[float] = None) -> None:
    """Block the calling replica worker until released (the wedge)."""
    _WEDGE_EVENT.wait(timeout)


def release_serve_wedge() -> None:
    """Unstick every wedged worker (test teardown)."""
    _WEDGE_EVENT.set()


def reset_serve_wedge() -> None:
    """Re-arm the wedge barrier (paired with ``clear()`` in tests)."""
    global _WEDGE_EVENT
    _WEDGE_EVENT = threading.Event()


def on_serve_reload() -> None:
    """``ModelRegistry.reload`` and the pool rebuild's injection
    point."""
    p = current()
    if p is not None:
        p.note_serve_reload()

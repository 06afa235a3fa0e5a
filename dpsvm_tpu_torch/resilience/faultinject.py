"""Deterministic fault injection: the parts of
``dpsvm_tpu/resilience/faultinject.py`` that the port's cascade
(``solver/cascade.py``), shard reader (``data/stream.py``), live shard
log (``data/live.py``) and model registry (``serving/registry.py``) read.

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

Serving: ``DPSVM_FAULT_SERVE_FAIL_RELOAD=j`` makes the j-th
``ModelRegistry.reload`` in this process raise before it loads anything,
so the old engine stays live.

The rest of the JAX module's fault knobs (checkpoint writes, NaN
injection, preemption, the replica pool, distributed) are not ported.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import threading
import time
from typing import Optional


def _log(msg: str) -> None:
    print(f"FAULTINJECT: {msg}", file=sys.stderr, flush=True)


_IO_LOCK = threading.Lock()
_SERVE_LOCK = threading.Lock()


class InjectedFaultError(OSError):
    """The transient read failure the I/O knobs inject (an OSError, like
    the real failures it stands in for)."""


@dataclasses.dataclass
class FaultPlan:
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
    serve_fail_reload: int = 0       # the j-th registry reload fails
    _cascade_fired: bool = False
    _io_reads: int = 0
    _io_fail_fired: bool = False
    _live_publishes: int = 0
    _live_appends: int = 0
    _torn_fired: bool = False
    _stale_fired: bool = False
    _writer_crash_fired: bool = False
    _serve_reloads: int = 0

    def any(self) -> bool:
        return bool(self.io_read_fail_once or self.io_corrupt_shard
                    or self.io_truncate_shard or self.io_slow_read_ms
                    or self.cascade_stop_stage or self.live_torn_publish
                    or self.live_stale_generation
                    or self.live_writer_crash_after
                    or self.live_shift_at_shard or self.serve_fail_reload)

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

    def note_serve_reload(self) -> None:
        """``ModelRegistry.reload``'s injection point: the j-th call in
        this process raises."""
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
        io_read_fail_once=_env_int("IO_READ_FAIL_ONCE"),
        io_corrupt_shard=_env_int("IO_CORRUPT_SHARD"),
        io_truncate_shard=_env_int("IO_TRUNCATE_SHARD"),
        io_slow_read_ms=_env_int("IO_SLOW_READ_MS"),
        cascade_stop_stage=_env_int("CASCADE_STOP_STAGE"),
        live_torn_publish=_env_int("LIVE_TORN_PUBLISH"),
        live_stale_generation=_env_int("LIVE_STALE_GENERATION"),
        live_writer_crash_after=_env_int("LIVE_WRITER_CRASH_AFTER"),
        live_shift_at_shard=_env_int("LIVE_SHIFT_AT_SHARD"),
        serve_fail_reload=_env_int("SERVE_FAIL_RELOAD"))
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


def on_serve_reload() -> None:
    """``serving/registry.ModelRegistry.reload``'s injection point."""
    p = current()
    if p is not None:
        p.note_serve_reload()

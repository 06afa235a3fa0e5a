"""Deterministic fault injection: the parts of
``dpsvm_tpu/resilience/faultinject.py`` that the port's cascade
(``solver/cascade.py``) and shard reader (``data/stream.py``) read.

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

The rest of the JAX module's fault knobs (checkpoint writes, NaN
injection, preemption, serving, distributed, live logs) are not ported.
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
    _cascade_fired: bool = False
    _io_reads: int = 0
    _io_fail_fired: bool = False

    def any(self) -> bool:
        return bool(self.io_read_fail_once or self.io_corrupt_shard
                    or self.io_truncate_shard or self.io_slow_read_ms
                    or self.cascade_stop_stage)

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
        cascade_stop_stage=_env_int("CASCADE_STOP_STAGE"))
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

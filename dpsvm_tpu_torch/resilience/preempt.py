"""Preemption snapshots: deferred SIGTERM/SIGINT handling (port of
``dpsvm_tpu/resilience/preempt.py``; the serving drain uses ``trap`` and
``pending``).

On preemptible cloud machines a SIGTERM mid-run is the COMMON case, not the
exception — the reference simply dies and loses everything (SURVEY §5).
Here the shared host driver (solver/driver.host_training_loop) runs its
poll loop inside ``trap()``: a delivered SIGTERM/SIGINT only sets a
flag, and at the next poll boundary the driver pulls a consistent carry,
writes a final checkpoint, emits a ``preempt`` trace event and raises
``PreemptedError`` — which the CLI converts into ``PREEMPT_EXIT_CODE``
(75, BSD EX_TEMPFAIL), the code the retry supervisor
(resilience/supervisor.py) treats as "resume me".

Pipelining note: the driver keeps pipelined dispatch enabled while
trapped — the speculative chunk's stats are only read (sequentializing
one poll) when a signal is ACTUALLY pending, so the zero-signal hot
path pays nothing (docs/ROBUSTNESS.md "Snapshot semantics").

A second SIGINT escalates to an immediate ``KeyboardInterrupt`` (the
operator hammering Ctrl-C must still win over a hung device call).
Handlers are installed only from the main thread (Python restricts
``signal.signal`` to it); worker-thread training loops run untrapped.
"""

from __future__ import annotations

import contextlib
import signal
import threading
from typing import Iterator, Optional

#: BSD sysexits EX_TEMPFAIL: "temporary failure, retry later" — distinct
#: from error exits AND from the watchdog's 124, but treated the same by
#: the retry supervisor's transient set.
PREEMPT_EXIT_CODE = 75


class PreemptedError(RuntimeError):
    """Training was interrupted by a (possibly simulated) preemption
    signal; the run is RESUMABLE from ``checkpoint_path`` when set."""

    def __init__(self, signum: int, n_iter: int,
                 checkpoint_path: Optional[str] = None):
        self.signum = int(signum)
        self.n_iter = int(n_iter)
        self.checkpoint_path = checkpoint_path
        where = (f"snapshot saved to {checkpoint_path}"
                 if checkpoint_path else
                 "no checkpoint_path configured — state NOT saved")
        super().__init__(
            f"training preempted by signal {signum} at iteration "
            f"{n_iter} ({where})")

    def __reduce__(self):
        # ranks report their errors to the launcher by pickle
        return (PreemptedError, (self.signum, self.n_iter,
                                 self.checkpoint_path))


_pending: Optional[int] = None       # signum, None = nothing pending
_hits = 0
_depth = 0                           # trap() nesting (polish runs 2 trains)


def pending() -> Optional[int]:
    """The pending preemption signal number, or None."""
    return _pending


def clear() -> None:
    global _pending, _hits
    _pending = None
    _hits = 0


def simulate(signum: int = signal.SIGTERM) -> None:
    """Mark a preemption as pending without a real signal — the fault
    injector's hook (resilience/faultinject.py) and test seam. Works in
    any thread and outside trap()."""
    global _pending, _hits
    _pending = int(signum)
    _hits += 1


def _handler(signum, frame) -> None:
    global _pending, _hits
    _hits += 1
    if signum == signal.SIGINT and _hits > 1:
        # Second Ctrl-C: the operator wants OUT now, snapshot or not.
        raise KeyboardInterrupt
    _pending = int(signum)


@contextlib.contextmanager
def trap(signums=(signal.SIGTERM, signal.SIGINT)) -> Iterator[None]:
    """Install the deferring handlers for the duration of a training
    loop; restore the previous handlers (and clear any leftover flag)
    on exit. No-op off the main thread and re-entrant under nesting."""
    global _depth
    if threading.current_thread() is not threading.main_thread():
        yield
        return
    if _depth:
        _depth += 1
        try:
            yield
        finally:
            _depth -= 1
        return
    clear()
    prev = {}
    for s in signums:
        try:
            prev[s] = signal.signal(s, _handler)
        except (ValueError, OSError):        # unsupported on platform
            pass
    _depth = 1
    try:
        yield
    finally:
        _depth = 0
        for s, h in prev.items():
            signal.signal(s, h)
        # A signal that landed after the final poll was absorbed: the
        # run completed and its artifacts are being written — beating
        # the preemption deadline is the point. Drop the stale flag so
        # the next run in this process starts clean.
        clear()

"""Device-stall watchdog (port of ``dpsvm_tpu/utils/watchdog.py``).

A process blocked inside a device call (a wedged card, a collective whose
peer died) cannot time itself out from Python, and an outer timeout kills
it with no evidence of why. This watchdog turns that into a fast, labelled
exit:

* ``arm(timeout_s)`` starts a daemon thread holding a deadline;
* ``pet()`` pushes the deadline forward: the driver's stats read (every
  solver path's poll), the decomposition's rebuild, the shrinking
  manager's passes and the batched program's polls call it;
* on expiry the thread prints a ``STALL`` line (with the distributed
  verdict of ``resilience.elastic.stall_extras`` when a multi-rank run is
  live), appends a terminal ``stall`` event to every open run trace and
  exits with ``os._exit(124)``, the code of ``timeout(1)``, which the
  retry supervisor treats as transient.

The expiry path touches no CUDA state (kernels may still be in flight):
the trace flush is file I/O on host-side records only.

Never armed by library code: ``chip_smoke.py`` arms it around its phases.
``pet()`` while disarmed costs one global read.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Optional

_lock = threading.Lock()
_deadline: Optional[float] = None      # None = disarmed
_timeout = 0.0
_thread: Optional[threading.Thread] = None
_POLL_S = 5.0


def arm(timeout_s: float) -> None:
    """Start (or re-arm) the watchdog with ``timeout_s`` of patience."""
    global _deadline, _timeout, _thread
    with _lock:
        _timeout = float(timeout_s)
        _deadline = time.monotonic() + _timeout
        if _thread is None:
            _thread = threading.Thread(
                target=_watch, name="dpsvm-stall-watchdog", daemon=True)
            _thread.start()


def pet() -> None:
    """Reset the deadline; a no-op while disarmed."""
    global _deadline
    if _deadline is None:
        return
    with _lock:
        if _deadline is not None:
            _deadline = time.monotonic() + _timeout


def disarm() -> None:
    global _deadline
    with _lock:
        _deadline = None


def _expire(timeout: float) -> None:
    print(f"STALL: no device response for {timeout:.0f}s (stall "
          "watchdog); exiting 124", file=sys.stderr, flush=True)
    extras = {}
    try:
        from dpsvm_tpu_torch.resilience import elastic
        extras = elastic.stall_extras()
        if extras:
            print(f"STALL: dist verdict {extras.get('dist_verdict')} "
                  f"(shard ages {extras.get('shard_ages')})",
                  file=sys.stderr, flush=True)
    except Exception:
        pass
    # A terminal `stall` event in every open run trace, so `report` can
    # render the stalled run (a trace with no terminal record looks like
    # a live one). Best-effort: nothing here may keep the exit from
    # happening.
    try:
        from dpsvm_tpu_torch.observability.record import flush_open_traces
        flushed = flush_open_traces("stall", timeout_s=timeout, **extras)
        if flushed:
            print(f"STALL: flushed {flushed} open run trace(s)",
                  file=sys.stderr, flush=True)
    except Exception:
        pass
    os._exit(124)


def _watch() -> None:
    while True:
        time.sleep(_POLL_S)
        with _lock:
            expired = (_deadline is not None
                       and time.monotonic() > _deadline)
            timeout = _timeout
        if expired:
            _expire(timeout)

"""Resumable retry supervisor: re-launch training after transient death
(port of ``dpsvm_tpu/resilience/supervisor.py``).

Recovery from a preemption/stall used to be a human re-typing the
command with ``--resume`` — on preemptible fleets that is an operator
pager, not a failure policy. The supervisor automates exactly that
loop, in two forms:

* ``supervise(argv, ...)`` — subprocess mode, what ``dpsvm train
  --retries N --retry-backoff S`` runs. Every attempt is a child
  process, so it recovers from ALL transient deaths including the stall
  watchdog's ``os._exit(124)`` (utils/watchdog.py) and a real SIGTERM
  preemption (exit 75, resilience/preempt.py). Before EVERY attempt —
  including the first — the newest intact rotation slot of
  ``checkpoint_path`` is injected as ``--resume``, which makes the
  supervised command idempotent across repeated preemptions: re-running
  it always continues from the latest surviving state.
* ``run_with_retries(fn, ...)`` — in-process mode for API users and the
  selfcheck: retries ``fn`` on ``PreemptedError`` (a watchdog kill
  cannot be caught in-process — use subprocess mode for that).

Each retry waits ``backoff_s * 2**attempt`` and is recorded as a
``retry`` trace event in the next attempt's run trace (the driver picks
the attempt number up from ``DPSVM_RETRY_ATTEMPT`` / the in-process
event queue), so ``dpsvm report`` shows the full recovery history.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from typing import Callable, List, Optional, Sequence

from dpsvm_tpu_torch.resilience.preempt import PREEMPT_EXIT_CODE, PreemptedError

#: Exit codes worth retrying: 75 = preemption snapshot (preempt.py),
#: 124 = stall watchdog / timeout(1) kill (utils/watchdog.py). Anything
#: else — config errors, real crashes — fails fast.
TRANSIENT_EXIT_CODES = frozenset({PREEMPT_EXIT_CODE, 124})

#: Negative returncodes subprocess reports for signal deaths that mean
#: "the host was going away", i.e. resumable: SIGTERM(15), SIGKILL(9),
#: SIGHUP(1). A SIGTERM that lands before (or despite) the in-process
#: snapshot handler still counts as transient — the checkpoint rotation
#: slots hold whatever was last saved.
TRANSIENT_SIGNALS = frozenset({-15, -9, -1})


def _log(msg: str) -> None:
    print(f"supervisor: {msg}", file=sys.stderr, flush=True)


def is_transient(rc: int) -> bool:
    return rc in TRANSIENT_EXIT_CODES or rc in TRANSIENT_SIGNALS


def strip_flags(argv: Sequence[str], names: Sequence[str]) -> List[str]:
    """Remove ``--flag value`` / ``--flag=value`` occurrences — used to
    peel the supervisor's own flags off the re-launched command."""
    out: List[str] = []
    skip = False
    for a in argv:
        if skip:
            skip = False
            continue
        if a in names:
            skip = True
            continue
        if any(a.startswith(n + "=") for n in names):
            continue
        out.append(a)
    return out


def with_resume(argv: Sequence[str], resume_path: str) -> List[str]:
    """argv with any existing ``--resume X`` replaced by the given
    checkpoint."""
    return strip_flags(argv, ("--resume",)) + ["--resume", resume_path]


def newest_intact(checkpoint_path: Optional[str]
                  ) -> "tuple[Optional[str], List[str]]":
    """Newest loadable rotation slot (+ the corrupt/missing ones it
    skipped). Thin re-export so callers need only this module.

    Mesh note: a slot recorded under a different mesh size is INTACT —
    never skipped as corrupt or rolled past to an older slot. Resuming
    it on the current mesh is the elastic re-shard path
    (solver/driver.resume_state records the ``reshard`` event); the
    supervisor just logs what the slot was saved under."""
    if not checkpoint_path:
        return None, []
    from dpsvm_tpu_torch.utils.checkpoint import (load_checkpoint,
                                            newest_intact_checkpoint)
    best, skipped = newest_intact_checkpoint(checkpoint_path)
    if best:
        try:
            ck = load_checkpoint(best)
            if int(getattr(ck, "shards", 1)) != 1:
                _log(f"{best} was saved on a {ck.mesh_desc()} "
                     f"(iter {ck.n_iter}); a different current mesh "
                     "re-shards on load")
        except Exception:
            pass                      # the resume path re-reports
    return best, skipped


def supervise(argv: Sequence[str], *, retries: int,
              backoff_s: float = 5.0,
              checkpoint_path: Optional[str] = None,
              env: Optional[dict] = None,
              call: Callable[..., int] = subprocess.call,
              sleep: Callable[[float], None] = time.sleep) -> int:
    """Run ``argv`` as a child process, re-launching from the newest
    intact checkpoint after transient exits. Returns the final exit
    code (0, the last transient code when retries ran out, or the first
    non-transient code)."""
    attempt = 0
    while True:
        cmd = list(argv)
        best, skipped = newest_intact(checkpoint_path)
        if skipped and best:
            _log(f"skipping unreadable checkpoint slot(s) "
                 f"{skipped} -> resuming {best}")
        if best:
            cmd = with_resume(cmd, best)
            _log(f"attempt {attempt + 1}: resuming from {best}")
        elif attempt:
            _log(f"attempt {attempt + 1}: no intact checkpoint — "
                 "restarting from scratch")
        child_env = dict(os.environ if env is None else env)
        if attempt:
            # The next attempt's run trace records this as a `retry`
            # event (solver/driver.begin_trace).
            child_env["DPSVM_RETRY_ATTEMPT"] = str(attempt)
        rc = call(cmd, env=child_env)
        if rc == 0 or not is_transient(rc) or attempt >= retries:
            if rc and is_transient(rc):
                _log(f"transient exit {rc} but retry budget "
                     f"({retries}) exhausted")
            return rc
        delay = backoff_s * (2 ** attempt)
        attempt += 1
        _log(f"transient exit {rc}; retry {attempt}/{retries} "
             f"in {delay:.1f}s")
        if delay > 0:
            sleep(delay)


def run_with_retries(fn: Callable[[Optional[str], int], object], *,
                     retries: int, backoff_s: float = 5.0,
                     checkpoint_path: Optional[str] = None,
                     sleep: Callable[[float], None] = time.sleep):
    """In-process supervisor: ``fn(resume_from, attempt)`` is called
    with the newest intact checkpoint (None on a cold start) and
    retried on ``PreemptedError`` with exponential backoff."""
    attempt = 0
    while True:
        resume, skipped = newest_intact(checkpoint_path)
        if skipped and resume:
            _log(f"skipping unreadable checkpoint slot(s) "
                 f"{skipped} -> resuming {resume}")
        if attempt:
            # Queue the retry marker for the attempt's run trace.
            from dpsvm_tpu_torch.solver import driver
            driver.queue_trace_event("retry", attempt=attempt,
                                     resumed_from=resume)
        try:
            return fn(resume, attempt)
        except PreemptedError as e:
            if attempt >= retries:
                raise
            delay = backoff_s * (2 ** attempt)
            attempt += 1
            _log(f"preempted at iter {e.n_iter}; retry "
                 f"{attempt}/{retries} in {delay:.1f}s")
            if delay > 0:
                sleep(delay)

"""The cascade's deterministic kill point (the part of
``dpsvm_tpu/resilience/faultinject.py`` that ``solver/cascade.py`` reads).

``DPSVM_FAULT_CASCADE_STOP_STAGE=k`` (or ``BENCH_FAULT_CASCADE_STOP_STAGE``)
makes the cascade raise ``CascadeInterrupted`` right after its stage-k
boundary state is durable on disk (1 = approx warm-start, 2 = screening,
3 = the first polish round): the kill->resume drill's kill point, after
which re-running the same command must land a bitwise-identical model.
``install(FaultPlan(cascade_stop_stage=k))`` is the same from Python.
The rest of the JAX module's fault knobs (checkpoint writes, NaN
injection, preemption, serving, distributed, I/O) are not ported.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import Optional


def _log(msg: str) -> None:
    print(f"FAULTINJECT: {msg}", file=sys.stderr, flush=True)


@dataclasses.dataclass
class FaultPlan:
    cascade_stop_stage: int = 0      # kill the cascade right after the
                                     # stage-k boundary state (0 = off)
    _cascade_fired: bool = False

    def any(self) -> bool:
        return bool(self.cascade_stop_stage)

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
    p = FaultPlan(cascade_stop_stage=_env_int("CASCADE_STOP_STAGE"))
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

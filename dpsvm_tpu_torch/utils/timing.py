"""Phase timing (port of ``dpsvm_tpu/utils/timing.py``).

The reference times training with an rdtsc cycle counter
(``CycleTimer.h:44-73``, used at ``svmTrainMain.cpp:206-208,312-314``).
On an asynchronous device, wall-clock around an enqueue measures the
enqueue, not the work, so ``PhaseTimer`` accumulates named host buckets
(``dispatch``, ``poll``, ``hook``, ``checkpoint`` ...) and, where a phase
must measure finished device work, synchronizes on the tensor a ``fence``
returns before the bucket closes.

``span(name)`` is the port's one way to open a named range on the
profiler's timeline: a ``torch.profiler.record_function`` while a torch
profiler records on this thread (``train --profile-dir``'s window, a
benchmark's capture, a caller's own ``torch.profiler.profile``), so the
range lands on the clock of the device's kernels and copies and nests
under the range open around it; otherwise a shared null context, at the
cost of one flag check. ``PhaseTimer.phase`` opens one for each phase.
"""

from __future__ import annotations

import contextlib
import sys
import time
from collections import defaultdict
from typing import Callable, Dict, Optional


def _block(value) -> None:
    """Wait until the device work producing ``value`` (a tensor, or a
    tuple/list of them) has finished; host values pass through."""
    for t in (value if isinstance(value, (tuple, list)) else (value,)):
        dev = getattr(t, "device", None)
        if getattr(dev, "type", None) == "cuda":
            import torch
            torch.cuda.current_stream(dev).synchronize()


_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``record_function(name)`` range while a torch profiler records on
    this thread, else the shared null context (module docstring). A
    process that has not imported torch records nothing, and is not made
    to import it."""
    torch = sys.modules.get("torch")
    if torch is None or not torch._C._autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)


class PhaseTimer:
    def __init__(self) -> None:
        """Each phase is also a ``span`` of the same name, so a profiler's
        timeline and the host buckets share one vocabulary."""
        self.seconds: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, fence: Optional[Callable[[], object]] = None):
        """fence: zero-arg callable evaluated at block exit; the device
        work behind its result is waited for, so the bucket measures
        finished device work, not the enqueue. (A callable, because the
        tensors to fence on are usually made inside the block.)"""
        t0 = time.perf_counter()
        try:
            with span(name):
                try:
                    yield
                finally:
                    # the fence inside the phase's span: the blocked
                    # device wait is attributed to the phase it ends
                    if fence is not None:
                        _block(fence())
        finally:
            self.seconds[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> str:
        total = sum(self.seconds.values()) or 1.0
        parts = [
            f"{k}={v:.3f}s({100 * v / total:.0f}%/{self.counts[k]}x)"
            for k, v in sorted(self.seconds.items(), key=lambda kv: -kv[1])
        ]
        return " ".join(parts)

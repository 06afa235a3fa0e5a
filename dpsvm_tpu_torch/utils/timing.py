"""Phase timing (port of ``dpsvm_tpu/utils/timing.py``).

The reference times training with an rdtsc cycle counter
(``CycleTimer.h:44-73``, used at ``svmTrainMain.cpp:206-208,312-314``).
On an asynchronous device, wall-clock around an enqueue measures the
enqueue, not the work, so ``PhaseTimer`` accumulates named host buckets
(``dispatch``, ``poll``, ``hook``, ``checkpoint`` ...) and, where a phase
must measure finished device work, synchronizes on the tensor a ``fence``
returns before the bucket closes.
"""

from __future__ import annotations

import contextlib
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


class PhaseTimer:
    def __init__(self, annotate: Optional[Callable[[str], object]] = None
                 ) -> None:
        """annotate: optional hook returning a context manager for a
        phase name, the profiler's integration point
        (observability/profiler.ProfileSession.annotation wraps each phase
        in a ``torch.profiler.record_function`` span of the same name, so
        the device timeline and the host buckets share one vocabulary).
        None = timing only."""
        self.seconds: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._annotate = annotate

    @contextlib.contextmanager
    def phase(self, name: str, fence: Optional[Callable[[], object]] = None):
        """fence: zero-arg callable evaluated at block exit; the device
        work behind its result is waited for, so the bucket measures
        finished device work, not the enqueue. (A callable, because the
        tensors to fence on are usually made inside the block.)"""
        ann = (self._annotate(name) if self._annotate is not None
               else contextlib.nullcontext())
        t0 = time.perf_counter()
        try:
            with ann:
                try:
                    yield
                finally:
                    # the fence inside the annotation span: the blocked
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

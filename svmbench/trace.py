"""Device time from ``torch.profiler``, reduced to what the per-layer
metrics read.

``Capture`` starts and stops a profiler over CPU and CUDA activity; the
harness names the slice it measures with a ``record_function`` span of its
own (``svmbench.fit`` around one fit, ``svmbench.slice`` around a stretch
of serving). After the window, ``Capture.reduce`` writes the profiler's
Chrome trace to a file under ``TMPDIR``, reads it back and deletes it, and
returns a ``Trace``: the slice's bounds, the kernels and the copies and
sets of the device in it, and the host's events, all clipped to the slice.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import List, Optional, Tuple

import numpy as np

HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")

Event = Tuple[str, float, float]     # (name, start us, duration us)
#: a breakdown's names are cut to this many characters (templated kernel
#: names run to a kilobyte)
NAME_CHARS = 160


class Capture:
    """One ``torch.profiler`` session, started and stopped by the
    harness."""

    def __init__(self):
        self._prof = self._new()
        self.running = False
        # The first start in a process sets the tracer up (seconds): do it
        # once here, in set-up, so that the window's start is prompt.
        warm = self._new()
        warm.start()
        warm.stop()

    @staticmethod
    def _new():
        from torch.profiler import ProfilerActivity, profile
        return profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])

    def start(self) -> None:
        self._prof.start()
        self.running = True

    def stop(self) -> None:
        if self.running:
            self._prof.stop()
            self.running = False

    def reduce(self, slice_name: str) -> "Trace":
        self.stop()
        fd, path = tempfile.mkstemp(prefix="svmbench-", suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as fh:
                events = json.load(fh)
        finally:
            os.unlink(path)
        self._prof = None
        if isinstance(events, dict):
            events = events.get("traceEvents", [])
        return Trace(events, slice_name)


def _clip(evs: List[Event], t0: float, t1: float) -> List[Event]:
    out = []
    for name, ts, dur in evs:
        lo, hi = max(ts, t0), min(ts + dur, t1)
        if hi > lo:
            out.append((name, lo, hi - lo))
    return out


def _union_s(evs: List[Event]) -> float:
    """Seconds covered by the events' intervals: launches that overlap (a
    kernel that lets the next launch start early) count once."""
    seg = _merge(evs)
    return float((seg[:, 1] - seg[:, 0]).sum()) / 1e6


def _merge(evs: List[Event]) -> np.ndarray:
    """The union of the events' intervals, as (k, 2) sorted [start, end]."""
    if not evs:
        return np.zeros((0, 2))
    a = np.array([(ts, ts + dur) for _, ts, dur in evs], np.float64)
    a = a[np.argsort(a[:, 0], kind="stable")]
    ends = np.maximum.accumulate(a[:, 1])
    new = np.ones(len(a), bool)
    new[1:] = a[1:, 0] > ends[:-1]
    starts = a[new, 0]
    idx = np.flatnonzero(new)
    seg_ends = np.maximum.reduceat(a[:, 1], idx)
    return np.stack([starts, seg_ends], axis=1)


class Trace:
    """A profiled slice: ``t0``/``t1`` in the trace's microseconds, the
    device's kernels and copies and the host's events inside it."""

    def __init__(self, events: list, slice_name: str):
        spans = [e for e in events if e.get("ph") == "X"
                 and e.get("cat") == "user_annotation"
                 and e.get("name") == slice_name]
        if not spans:
            raise RuntimeError(f"profiler trace holds no span "
                               f"{slice_name!r}")
        self.t0 = min(float(e["ts"]) for e in spans)
        self.t1 = max(float(e["ts"]) + float(e["dur"]) for e in spans)
        by_cat = {}
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            by_cat.setdefault(e.get("cat"), []).append(
                (str(e.get("name")), float(e["ts"]), float(e["dur"])))
        self.kernels = _clip(by_cat.get("kernel", []), self.t0, self.t1)
        self.copies = _clip(by_cat.get("gpu_memcpy", [])
                            + by_cat.get("gpu_memset", []),
                            self.t0, self.t1)
        self.host = _clip([ev for c in HOST_CATS
                           for ev in by_cat.get(c, [])
                           if not (c == "user_annotation"
                                   and ev[0] == slice_name)],
                          self.t0, self.t1)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def busy_s(self) -> float:
        """Seconds of the slice in which a kernel, copy or set ran."""
        return _union_s(self.kernels + self.copies)

    def idle_pct(self) -> Optional[float]:
        """None where the slice holds no device event at all."""
        if self.window_s <= 0 or not (self.kernels or self.copies):
            return None
        return 100.0 * (1.0 - self.busy_s() / self.window_s)

    def kernel_s(self, contains: Optional[str] = None) -> float:
        """Seconds in which a kernel (whose name holds ``contains``) ran."""
        return _union_s([ev for ev in self.kernels
                         if contains is None or contains in ev[0]])

    def copy_s(self, contains: str) -> Optional[float]:
        """Seconds in which a copy whose name holds ``contains`` ran; None
        where there is none."""
        evs = [ev for ev in self.copies if contains in ev[0]]
        return _union_s(evs) if evs else None

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time (each name's union of
        intervals), and the longest idle gaps, each named by the innermost
        host event running at its middle."""
        by_name = {}
        for ev in self.kernels + self.copies:
            by_name.setdefault(ev[0], []).append(ev)
        ops = sorted(((n, _union_s(evs)) for n, evs in by_name.items()),
                     key=lambda kv: -kv[1])[:top]
        seg = _merge(self.kernels + self.copies)
        edges = np.concatenate([[self.t0], seg.ravel(), [self.t1]])
        gaps = edges.reshape(-1, 2)
        lengths = gaps[:, 1] - gaps[:, 0]
        order = np.argsort(-lengths, kind="stable")[:top]
        if self.host:
            h = np.array([(ts, ts + d) for _, ts, d in self.host])
            names = [n for n, _, _ in self.host]
        idle = []
        for i in order:
            if lengths[i] <= 0:
                break
            mid = (gaps[i, 0] + gaps[i, 1]) / 2.0
            name = "host: no traced event"
            if self.host:
                cover = np.flatnonzero((h[:, 0] <= mid) & (h[:, 1] >= mid))
                if cover.size:
                    j = cover[np.argmin(h[cover, 1] - h[cover, 0])]
                    name = names[j]
            idle.append([name[:NAME_CHARS], float(lengths[i]) / 1e6])
        return {"device_ops": [[n[:NAME_CHARS], d] for n, d in ops],
                "idle_gaps": idle}

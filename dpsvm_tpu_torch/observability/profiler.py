"""``torch.profiler`` sessions of a training run (port of
``dpsvm_tpu/observability/profiler.py``).

``train --profile-dir DIR`` opens a profiler window at poll boundaries,
so the artifact is small and shaped alike for every run of a config:

* **Windowed capture**: the profiler starts at a poll boundary after
  ``skip_polls`` polls (the first chunk's captures and launches are done
  by the time the first poll returns) and stops after ``capture_polls``
  polls. Env overrides: ``DPSVM_PROFILE_SKIP_POLLS`` /
  ``DPSVM_PROFILE_POLLS``, the JAX package's integers.
* **Phase annotations**: the driver's ``PhaseTimer`` buckets
  (``dispatch`` / ``poll`` / ``checkpoint`` / ``hook``) open
  ``utils/timing.span`` ranges named after the phases, which land in the
  window as in any profiler, so the timeline carries the run trace's
  ``phase_counts`` vocabulary.
* **CUDA activity on the card, CPU activity on the CPU**; the raw
  artifact is a Chrome trace (``*.pt.trace.json``), not the JAX
  package's xplane, and is not expected to cross packages.
* **Reconciliation sidecar**: ``close()`` writes ``profile_summary.json``
  beside the artifact in the JAX package's layout: the host phase
  seconds and calls inside the window, the window's bounds, the artifact
  inventory, and (the port's addition) ``device``, the device
  milliseconds the profiler saw under each phase's range and in all.
  ``profile summarize DIR [--trace T]`` renders it against a run trace.

``torch`` is imported inside the functions that need it, and every
profiler call is guarded: a profiler that fails leaves the sidecar with
its error and never takes the run down.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

SUMMARY_FILE = "profile_summary.json"
SUMMARY_SCHEMA = 1

#: device-trace artifact suffixes: the port's Chrome traces, and the JAX
#: package's profiler files (its xplane and trace files), so either
#: package's directory inventories alike
ARTIFACT_SUFFIXES = (".xplane.pb", ".trace.json.gz", ".json.gz",
                     ".pb", ".json")


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "").strip()
    try:
        return int(raw) if raw else default
    except ValueError:
        return default


def find_artifacts(log_dir: str) -> List[dict]:
    """Inventory of device-trace files under ``log_dir`` (relative
    path + size), newest first."""
    out = []
    for root, _dirs, files in os.walk(log_dir):
        for f in files:
            if f == SUMMARY_FILE:
                continue
            if any(f.endswith(s) for s in ARTIFACT_SUFFIXES):
                p = os.path.join(root, f)
                try:
                    out.append({
                        "path": os.path.relpath(p, log_dir),
                        "bytes": os.path.getsize(p),
                        "mtime": os.path.getmtime(p),
                    })
                except OSError:
                    pass
    out.sort(key=lambda a: -a["mtime"])
    for a in out:
        a.pop("mtime", None)
    return out


def device_times(prof, names) -> Dict[str, float]:
    """Device milliseconds in a stopped profile: under each phase range
    named in ``names`` (``phase_ms.<name>``) and over every kernel
    (``kernels_ms``). A CPU-only profile reports 0.0 device time."""
    out: Dict[str, float] = {}
    kernels = 0.0
    for ev in prof.key_averages():
        dev_us = float(getattr(ev, "device_time_total", None)
                       or getattr(ev, "cuda_time_total", 0.0) or 0.0)
        if ev.key in names:
            out[f"phase_ms.{ev.key}"] = round(
                out.get(f"phase_ms.{ev.key}", 0.0) + dev_us / 1e3, 6)
        elif not getattr(ev, "is_user_annotation", False):
            kernels += float(getattr(ev, "self_device_time_total", None)
                             or getattr(ev, "self_cuda_time_total", 0.0)
                             or 0.0)
    out["kernels_ms"] = round(kernels / 1e3, 6)
    return out


class ProfileSession:
    """One training run's programmatic profiler window.

    Lifecycle (driven by the shared host driver):

    * construction — decides the window; nothing starts yet;
    * ``attach_timer(timer)`` — the driver's PhaseTimer, whose phase
      names are the sidecar's annotation vocabulary;
    * ``note_poll()`` — called once per host poll; starts the device
      trace when the skip window ends, stops it when the capture
      window is full;
    * ``close()`` — stops a still-open trace (run ended early) and
      writes the ``profile_summary.json`` sidecar.
    """

    def __init__(self, log_dir: str, *, skip_polls: Optional[int] = None,
                 capture_polls: Optional[int] = None,
                 solver: str = "unknown", device=None):
        self.log_dir = log_dir
        self.cuda = getattr(device, "type", str(device)) == "cuda"
        self._prof = None
        self._device: Dict[str, float] = {}
        self.skip_polls = max(_env_int("DPSVM_PROFILE_SKIP_POLLS", 0)
                              if skip_polls is None else int(skip_polls),
                              0)
        self.capture_polls = max(_env_int("DPSVM_PROFILE_POLLS", 4)
                                 if capture_polls is None
                                 else int(capture_polls), 1)
        self.solver = solver
        self._timer = None
        self._polls = 0
        self._active = False
        self._closed = False
        self._started_at_poll: Optional[int] = None
        self._stopped_at_poll: Optional[int] = None
        self._t_start: Optional[float] = None
        self._window_seconds = 0.0
        self._snap_seconds: Dict[str, float] = {}
        self._snap_counts: Dict[str, int] = {}
        self._win_seconds: Dict[str, float] = {}
        self._win_counts: Dict[str, int] = {}
        self._error: Optional[str] = None
        os.makedirs(log_dir, exist_ok=True)

    # -- PhaseTimer hook ----------------------------------------------

    def attach_timer(self, timer) -> None:
        """The PhaseTimer whose buckets bound the captured window (the
        driver's); snapshotted at trace start/stop so the sidecar
        reports window-local phase time, not whole-run time."""
        self._timer = timer

    def _phases(self) -> List[str]:
        """The annotation vocabulary: the attached timer's phases so far,
        in the order they first ran."""
        return list(self._timer.counts) if self._timer is not None else []

    # -- window management --------------------------------------------

    def _snapshot_timer(self) -> None:
        if self._timer is not None:
            self._snap_seconds = dict(self._timer.seconds)
            self._snap_counts = dict(self._timer.counts)

    def _window_delta(self) -> None:
        if self._timer is None:
            return
        self._win_seconds = {
            k: round(v - self._snap_seconds.get(k, 0.0), 6)
            for k, v in self._timer.seconds.items()}
        self._win_counts = {
            k: v - self._snap_counts.get(k, 0)
            for k, v in self._timer.counts.items()}

    def _start(self) -> None:
        self._snapshot_timer()
        self._t_start = time.perf_counter()
        self._started_at_poll = self._polls
        try:
            import torch
            from torch.profiler import ProfilerActivity
            acts = [ProfilerActivity.CPU]
            if self.cuda:
                acts.append(ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.start()
            self._active = True
        except Exception as e:     # profiler unavailable: sidecar only
            self._error = f"profiler start failed: {e}"

    def _stop(self) -> None:
        self._stopped_at_poll = self._polls
        if self._t_start is not None:
            self._window_seconds = round(
                time.perf_counter() - self._t_start, 6)
        self._window_delta()
        if self._active:
            self._active = False
            try:
                self._prof.stop()
                self._prof.export_chrome_trace(os.path.join(
                    self.log_dir, f"dpsvm_{os.getpid()}_"
                    f"{int(time.time() * 1e3)}.pt.trace.json"))
                self._device = device_times(self._prof, self._phases())
            except Exception as e:
                self._error = f"profiler stop failed: {e}"
            self._prof = None

    def note_poll(self) -> None:
        """One host poll boundary passed. With an annotation so the
        poll cadence is visible on the device timeline too."""
        if self._closed or self._stopped_at_poll is not None:
            return
        if (self._started_at_poll is None
                and self._polls >= self.skip_polls):
            self._start()
        elif (self._started_at_poll is not None
              and self._polls - self._started_at_poll
              >= self.capture_polls):
            self._stop()
        self._polls += 1

    def close(self, extra: Optional[dict] = None) -> Optional[str]:
        """Stop a still-open window, write the sidecar, return its
        path. Idempotent; never raises (profiling must not take the
        run down)."""
        if self._closed:
            return None
        self._closed = True
        try:
            if (self._started_at_poll is not None
                    and self._stopped_at_poll is None):
                self._stop()
            summary = {
                "schema": SUMMARY_SCHEMA,
                "solver": self.solver,
                "skip_polls": self.skip_polls,
                "capture_polls": self.capture_polls,
                "polls_seen": self._polls,
                "window": {
                    "started_at_poll": self._started_at_poll,
                    "stopped_at_poll": self._stopped_at_poll,
                    "seconds": self._window_seconds,
                },
                "phases": {
                    name: {"seconds": self._win_seconds.get(name, 0.0),
                           "calls": self._win_counts.get(name, 0)}
                    for name in sorted(set(self._phases())
                                       | set(self._win_seconds))},
                "annotations": self._phases(),
                "device": dict(self._device),
                "activities": ["cpu", "cuda"] if self.cuda else ["cpu"],
                "artifacts": find_artifacts(self.log_dir),
                "error": self._error,
                "time": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
            }
            if extra:
                summary.update(extra)
            path = os.path.join(self.log_dir, SUMMARY_FILE)
            tmp = f"{path}.tmp{os.getpid()}"
            with open(tmp, "w") as fh:
                json.dump(summary, fh, indent=1)
            os.replace(tmp, path)
            return path
        except Exception:
            return None


# ---------------------------------------------------------------------
# `dpsvm profile summarize`
# ---------------------------------------------------------------------

def load_summary(profile_dir: str) -> dict:
    """Read the reconciliation sidecar; FileNotFoundError names the
    expected file if the dir holds only raw device artifacts."""
    path = os.path.join(profile_dir, SUMMARY_FILE)
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"{path} (was this profile captured by `train "
            "--profile-dir`? raw profiler dirs carry no summary)")
    with open(path) as fh:
        summary = json.load(fh)
    # re-walk: artifacts may have landed after close() on some backends
    summary["artifacts"] = find_artifacts(profile_dir)
    return summary


def _fmt_bytes(v: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(v) < 1024 or unit == "GiB":
            return (f"{v:,.1f} {unit}" if unit != "B"
                    else f"{v:,.0f} B")
        v /= 1024
    return f"{v:,.1f} GiB"


def render_summary(summary: dict,
                   trace_phase_counts: Optional[Dict[str, int]] = None
                   ) -> str:
    """The one reconciliation table: per phase, the host wall seconds
    and call count inside the captured window, next to the run
    trace's own ``phase_counts`` when a trace is supplied — the
    host-level accounting and the device timeline share the phase
    vocabulary by construction (the annotations ARE the phase names),
    so this is where they line up."""
    w = summary.get("window") or {}
    out = [f"profile: {summary.get('solver', 'unknown')}  "
           f"window {w.get('seconds', 0.0):.3f} s  "
           f"(polls {w.get('started_at_poll')}.."
           f"{w.get('stopped_at_poll')} of {summary.get('polls_seen')}"
           f", skipped {summary.get('skip_polls')} warmup)"]
    arts = summary.get("artifacts") or []
    if arts:
        total = sum(a.get("bytes", 0) for a in arts)
        out.append(f"device artifacts: {len(arts)} file(s), "
                   f"{_fmt_bytes(total)} "
                   f"(newest: {arts[0]['path']})")
    else:
        note = summary.get("error") or "window never opened"
        out.append(f"device artifacts: none ({note})")
    phases = summary.get("phases") or {}
    total_s = sum(p.get("seconds", 0.0) for p in phases.values()) or 0.0
    out.append("")
    header = (f"  {'phase':<12} {'host_s':>9} {'share':>7} "
              f"{'calls':>7}")
    if trace_phase_counts is not None:
        header += f" {'trace_calls':>12} {'match':>6}"
    out.append(header)
    names = sorted(phases,
                   key=lambda k: -phases[k].get("seconds", 0.0))
    for name in names:
        p = phases[name]
        sec = p.get("seconds", 0.0)
        share = f"{sec / total_s:6.1%}" if total_s > 0 else "   n/a"
        line = (f"  {name:<12} {sec:9.4f} {share:>7} "
                f"{p.get('calls', 0):>7,}")
        if trace_phase_counts is not None:
            tc = trace_phase_counts.get(name)
            line += (f" {tc if tc is not None else 'n/a':>12} "
                     f"{'yes' if tc is not None else 'NO':>6}")
        out.append(line)
    if trace_phase_counts is not None:
        missing = sorted(set(trace_phase_counts) - set(phases))
        if missing:
            out.append(f"  (trace phases with no annotation: "
                       f"{missing})")
        else:
            out.append("  (every trace phase has a matching "
                       "annotation)")
    dev = summary.get("device") or {}
    if dev:
        out.append("")
        out.append(f"device time in the window: "
                   f"{dev.get('kernels_ms', 0.0):.3f} ms of kernels; "
                   + ", ".join(f"{k[len('phase_ms.'):]} "
                               f"{v:.3f} ms"
                               for k, v in sorted(dev.items())
                               if k.startswith("phase_ms.")))
    ann = summary.get("annotations") or []
    out.append("")
    out.append("annotation spans on the device timeline: "
               + (", ".join(ann) if ann else "(none)"))
    return "\n".join(out)


def summarize_profile(profile_dir: str,
                      trace_path: Optional[str] = None) -> dict:
    """Machine-readable reconciliation: the sidecar summary, plus the
    run trace's ``phase_counts`` and the annotation/phase match
    verdict when a trace is given."""
    summary = load_summary(profile_dir)
    result = dict(summary, profile_dir=profile_dir)
    if trace_path:
        from dpsvm_tpu_torch.observability.report import (load_trace,
                                                    resolve_trace_path,
                                                    trace_facts)
        facts = trace_facts(load_trace(resolve_trace_path(trace_path)))
        counts = facts.get("phase_counts") or {}
        result["trace_phase_counts"] = counts
        result["phases_match"] = (
            set(counts) <= set(summary.get("phases") or {}))
    return result

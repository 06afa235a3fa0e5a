"""One traced run of a benchmark cell, with the device's idle time split
by the innermost program span open over it.

    python3 scripts/idle_by_span.py --workload mnist-evenodd.fit \\
        --seed 9200000001 --seconds 51 [--root DIR] [--out FILE.jsonl]

Runs ``svmbench.core.run_cell`` with ``--trace 1`` semantics from the
checkout at ``--root`` (default: this one; an older commit unpacked with
``git archive`` measures that commit's program under its own harness),
keeps the profiler's events, and prints one JSON line: the run's result
line (``result``), the device idle seconds of the profiled slice under
each innermost ``user_annotation`` span (``idle_by_span``; idle under no
program span is ``(none)``), the share of idle under a span below the
root (``below_root_share``: the children of ``fit``, or the engine's pass
spans), and the on-cost readings: the profiled fit's wall
(``profiled_fit_wall_s``) or the profiled slice's rows a second
(``slice_rows_per_s``). Needs a CUDA device unless ``--device cpu`` (a
rehearsal: the CPU trace has no device events, so all of it is idle).
"""

import argparse
import json
import os
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
#: spans that are a cell's root: idle under them alone is not attributed
ROOTS = ("fit", "engine.run")


def innermost_pieces(spans, t0, t1):
    """Breakpoints and labels of the innermost span over [t0, t1]: spans
    of one thread nest, so a stack sweep of their edges gives it."""
    edges = []
    for name, ts, dur in spans:
        edges.append((ts, 1, -dur, name))
        edges.append((ts + dur, 0, 0.0, name))
    edges.sort()
    stack, cuts, labels = [], [t0], []
    for t, opening, _, name in edges:
        t = min(max(t, t0), t1)
        if t > cuts[-1]:
            labels.append(stack[-1] if stack else "(none)")
            cuts.append(t)
        if opening:
            stack.append(name)
        elif name in stack:
            del stack[len(stack) - 1 - stack[::-1].index(name)]
    if t1 > cuts[-1]:
        labels.append(stack[-1] if stack else "(none)")
        cuts.append(t1)
    return np.asarray(cuts), labels


def idle_by_span(tr, spans) -> dict:
    """Idle microseconds of the slice under each innermost span."""
    from svmbench.trace import _merge
    seg = _merge(tr.kernels + tr.copies)
    edges = np.concatenate([[tr.t0], seg.ravel(), [tr.t1]]).reshape(-1, 2)
    gs = edges[:, 0]
    glen = np.maximum(edges[:, 1] - edges[:, 0], 0.0)
    pre = np.concatenate([[0.0], np.cumsum(glen)])

    def idle_until(t):
        i = np.searchsorted(gs, t, side="right") - 1
        ok = i >= 0
        j = np.where(ok, i, 0)
        return np.where(ok, pre[j] + np.minimum(t - gs[j], glen[j]), 0.0)

    cuts, labels = innermost_pieces(spans, tr.t0, tr.t1)
    per = np.diff(idle_until(cuts))
    out = {}
    for name, us in zip(labels, per):
        out[name] = out.get(name, 0.0) + float(us)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch
    from svmbench import core, trace as trmod
    if args.device == "cuda" and not torch.cuda.is_available():
        print("idle_by_span: no CUDA device", file=sys.stderr)
        return 2
    kept = {}

    def reduce(self, slice_name):
        # Capture.reduce, keeping the events
        self.stop()
        fd, path = tempfile.mkstemp(prefix="idle-by-span-", suffix=".json")
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
        kept["events"], kept["slice"] = events, slice_name
        kept["trace"] = trmod.Trace(events, slice_name)
        return kept["trace"]

    trmod.Capture.reduce = reduce
    result, _, obj = core.run_cell(root, args.workload, args.seed,
                                   args.seconds, True, device=args.device)
    tr = kept["trace"]
    spans = [(str(e["name"]), float(e["ts"]), float(e["dur"]))
             for e in kept["events"]
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and e.get("name") != kept["slice"]
             and float(e["ts"]) < tr.t1
             and float(e["ts"]) + float(e["dur"]) > tr.t0]
    split = idle_by_span(tr, spans)
    idle = sum(split.values())
    below = sum(v for k, v in split.items()
                if k != "(none)" and k not in ROOTS)
    row = {"workload": args.workload, "seed": args.seed,
           "root": os.path.relpath(root, ROOT),
           "device": core.device_name(args.device),
           "idle_s": idle / 1e6, "window_s": tr.window_s,
           "idle_by_span": {k: v / 1e6 for k, v in sorted(
               split.items(), key=lambda kv: -kv[1])},
           "below_root_share": below / idle if idle > 0 else None,
           "spans": len(spans)}
    if obj.kind == "fit":
        row["profiled_fit_wall_s"] = next(f.wall for f in obj.fits
                                          if f.profiled)
    else:
        jobs = [j for j in obj.jobs if j.profiled]
        row["slice_rows_per_s"] = (obj.slice_rows()
                                   / (jobs[-1].t1 - jobs[0].t0))
    row["result"] = result
    line = json.dumps(row)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

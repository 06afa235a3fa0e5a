"""The harness: finds a cell's files by the names in ``BENCHMARK.json``,
runs its set-up, its window and its check, and builds the result line.

Data, not code, makes a cell: the configuration is the file its
``configs`` entry names; the traffic mix is
``svmbench/traffic/<traffic>.json``, whose ``kind`` names the generator
``svmbench/kinds/<kind>.py`` (its class ``Cell``); the limits of the
check are ``svmbench/limits/<workload>.json``; each per-layer metric is
read by ``svmbench/metrics/<metric>.py``'s ``read(ctx)``, which returns a
number or None when it finds nothing to read. A later cell, mix, kind or
metric is a new file, and no file here changes.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import re
import sys
import time
import types
from pathlib import Path
from typing import Optional

from svmbench.trace import Capture

#: top-level module names that may not be loaded in a run's process: JAX
#: and the JAX package the program was ported from (compared whole: the
#: program's own name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "dpsvm_tpu")


def worst(a: float, b: float) -> float:
    """The larger of two readings; a NaN reads as infinitely bad."""
    a = math.inf if math.isnan(a) else a
    b = math.inf if math.isnan(b) else b
    return max(a, b)


def sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def forbidden_modules() -> list:
    """The forbidden top-level names present in ``sys.modules``."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def load_json(path: Path):
    with open(path) as fh:
        return json.load(fh)


def load_bench(root: Path) -> dict:
    return load_json(Path(root) / "BENCHMARK.json")


def find_cell(bench: dict, workload: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == workload:
            return cell
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def cell_files(root: Path, bench: dict, cell: dict):
    """(configuration, traffic, limits) of a cell, each found by name."""
    root = Path(root)
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = load_json(root / entry["file"])
    traffic = load_json(root / "svmbench" / "traffic"
                        / f"{cell['traffic']}.json")
    limits = load_json(root / "svmbench" / "limits" / f"{cell['name']}.json")
    return config, traffic, limits


def end_to_end_of(bench: dict, workload: str) -> list:
    return [m for m in bench["end_to_end"]
            if workload in m.get("workloads", [workload])]


def per_layer_of(bench: dict, workload: str) -> list:
    moves = {m["name"] for m in end_to_end_of(bench, workload)}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in moves)]


def _load(root: Path, sub: str, name: str):
    """The module ``svmbench/<sub>/<name>.py`` under ``root``."""
    path = Path(root) / "svmbench" / sub / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"svmbench_{sub}_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod        # dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


def reader(root: Path, name: str):
    """``read`` of ``svmbench/metrics/<name>.py``."""
    return _load(root, "metrics", name).read


def kind(root: Path, name: str):
    """The class ``Cell`` of ``svmbench/kinds/<name>.py``: a traffic
    kind, whose constructor is a cell's set-up and whose ``window`` and
    ``judge`` are its measured window and its check."""
    return _load(root, "kinds", name).Cell


def device_name(device) -> str:
    import torch
    if torch.device(device).type == "cuda":
        return torch.cuda.get_device_name(torch.device(device))
    return "cpu"


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device="cuda", precision: Optional[str] = None,
             t_start: Optional[float] = None, lag: float = 0.0):
    """One run of a cell: set-up, the window, the check. Returns (the
    result line's object, the check's lines, the cell's object of its
    kind). ``precision`` overrides the program's
    ``matmul_precision`` / engine precision (the control); ``t_start`` /
    ``lag``: the process's start on ``perf_counter``'s clock and the
    seconds it had run before it (set-up counts from there)."""
    import torch
    t_start = time.perf_counter() if t_start is None else t_start
    bench = load_bench(root)
    cell = find_cell(bench, workload)
    config, traffic, limits = cell_files(root, bench, cell)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        from dpsvm_tpu_torch import build
        build.build_all()
    obj = kind(root, traffic["kind"])(config, traffic, seed, device,
                                      precision)
    setup_s = lag + time.perf_counter() - t_start
    # a traced run reports no set-up time: the profiler's own set-up
    # (``Capture()``) may follow the reading
    capture = Capture() if trace else None
    e2e = obj.window(seconds, capture)
    if cuda:
        torch.cuda.synchronize()
    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    tr = capture.reduce(obj.slice_name) if trace else None
    obj.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers = obj.judge(device, limits)
    if set(numbers) != set(limits):
        raise KeyError(f"limits/{workload}.json names {sorted(limits)}, "
                       f"the check compares {sorted(numbers)}")
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    correct = all(v <= limits[k] for k, v in numbers.items())
    metrics = {}
    if not trace:
        e2e["setup_s"] = setup_s
        for m in end_to_end_of(bench, workload):
            v = e2e[m["name"]]
            if not math.isfinite(v):
                raise RuntimeError(f"{m['name']} read {v}")
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        ctx = types.SimpleNamespace(workload=workload, config=config,
                                    traffic=traffic, cell=obj, trace=tr)
        for m in per_layer_of(bench, workload):
            v = reader(root, m["name"])(ctx)
            if v is not None and math.isfinite(v):
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": device_name(device), "count": 1,
           "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": obj.attempted,
              "failed": obj.failed, "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s
        result["breakdown"] = tr.breakdown()
    result["checks"] = checks
    lines = [f"check {k}: {c['value']!r} (limit {c['limit']!r})"
             for k, c in checks.items()]
    return result, lines, obj

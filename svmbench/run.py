"""Run one cell of the benchmark of ``dpsvm_tpu_torch`` on this machine's
GPU and print its result as the last line of standard output:

    python3 svmbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from one profiled slice. Exits non-zero, printing no
result, without a CUDA device (or with fewer than the cell asks for), or
if JAX or the JAX package was loaded in this process.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _lag() -> float:
    """Seconds this process had run before ``_T0`` (0 where /proc does
    not say)."""
    try:
        with open("/proc/self/stat") as fh:
            start = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            up = float(fh.read().split()[0])
        lag = up - start / os.sysconf("SC_CLK_TCK") - (time.perf_counter()
                                                       - _T0)
        return max(0.0, lag)
    except (OSError, ValueError, IndexError):
        return 0.0


_LAG = _lag()


def _card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return "nvidia-smi: " + out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: not read ({type(e).__name__})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from svmbench import core
    cell = core.find_cell(core.load_bench(ROOT), args.workload)
    if not torch.cuda.is_available():
        print("svmbench: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"svmbench: {args.workload} needs {cell['chips']} devices, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    result, lines, _ = core.run_cell(ROOT, args.workload, args.seed,
                                  args.seconds, bool(args.trace),
                                  device="cuda", t_start=_T0, lag=_LAG)
    found = core.forbidden_modules()
    if found:
        print(f"svmbench: loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    print(_card_line(), flush=True)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The readings a check's limits are set from: one cell's compared numbers
on many seeds, for the program as the configuration states it and for the
control (the program's own lower-precision route,
``matmul_precision="default"`` / engine ``precision="default"``: bfloat16
operands where the configuration states float32), all in one process.

    python3 svmbench/readings.py --workload <cell> --seconds <s> \\
        --seeds 1,2,3 [--control-seeds 4,5,6] [--out <file.jsonl>]

Each run is ``core.run_cell``: the cell's own set-up, window (``--seconds``;
0 gives a fit cell one round of its problems, a score cell one job) and
check. One JSON line a run, with the card's name. Needs a CUDA device:
the limits are set from the card's readings. Not run by the benchmark's
own runs.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: the control's precision: the program's bfloat16 route
CONTROL = "default"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from svmbench import core
    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    device = "cuda"
    card = core.device_name(device)
    runs = ([(int(s), None) for s in args.seeds.split(",") if s]
            + [(int(s), CONTROL)
               for s in args.control_seeds.split(",") if s])
    out = open(args.out, "a") if args.out else None
    try:
        for seed, precision in runs:
            t = time.perf_counter()
            cell, _, obj = core.run_cell(ROOT, args.workload, seed,
                                         args.seconds, False, device=device,
                                         precision=precision)
            row = {"workload": args.workload, "seed": seed, "device": card,
                   "side": "control" if precision else "program",
                   "correct": cell["correct"],
                   "attempted": cell["attempted"], "failed": cell["failed"],
                   "checks": {k: c["value"]
                              for k, c in cell["checks"].items()},
                   "metrics": {k: m["value"]
                               for k, m in cell["metrics"].items()},
                   "fits": [{"problem": f.problem, "n_iter": f.n_iter,
                             "rounds": f.rounds,
                             "train_seconds": f.train_seconds,
                             "n_sv": int((f.alpha > 0).sum())}
                            for f in getattr(obj, "fits", [])],
                   "seconds": time.perf_counter() - t}
            line = json.dumps(row)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Where a training iteration's time goes on the GPU, for PERF.md.

Trains planted 60000 x 784 data (C=10, gamma=0.25, eps=1e-3) through
``dpsvm_tpu_torch.api.train`` for ``--iters`` iterations per precision
under ``torch.profiler``, and prints one JSON line per precision: device
time per kernel and copy (sum, count, mean), the device's busy share of
the profiled wall window (their sum over it), and iterations per second. Run on the card:

    PYTHONPATH=. python scripts/profile_fused_train.py [--iters 20000]
"""

import argparse
import json
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from dpsvm_tpu_torch import SVMConfig, train
from dpsvm_tpu_torch.data.synthetic import make_planted


def _kernel_us(evt) -> float:
    """Device time of a kernel entry; 0 for host ops, whose device totals
    repeat the time of the kernels they launched."""
    if getattr(evt, "device_type", None) != torch.autograd.DeviceType.CUDA:
        return 0.0
    for name in ("self_device_time_total", "device_time_total",
                 "self_cuda_time_total", "cuda_time_total"):
        v = getattr(evt, name, None)
        if v:
            return float(v)
    return 0.0


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    x, y = make_planted(60000, 784, 0.25, seed=0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    for prec in ("highest", "default"):
        cfg = SVMConfig(c=10.0, gamma=0.25, epsilon=1e-3,
                        max_iter=args.iters, matmul_precision=prec)
        train(x[:2048], y[:2048], SVMConfig(max_iter=50))     # warm up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            t0 = time.perf_counter()
            res = train(x, y, cfg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels = {}
        for evt in prof.key_averages():
            us = _kernel_us(evt)
            if us > 0:
                kernels[evt.key[:60]] = {"sum_ms": us / 1e3,
                                         "count": evt.count,
                                         "mean_us": us / max(evt.count, 1)}
        busy = sum(k["sum_ms"] for k in kernels.values()) / 1e3
        print(json.dumps({
            "precision": prec, "card": smi, "n_iter": res.n_iter,
            "wall_s": wall, "train_seconds": res.train_seconds,
            "iters_per_s": res.n_iter / res.train_seconds,
            "device_busy_share": busy / wall if kernels else None,
            "kernels": dict(sorted(kernels.items(),
                                   key=lambda kv: -kv[1]["sum_ms"])[:8]),
            "alpha_finite": bool(np.all(np.isfinite(res.alpha)))}),
            flush=True)


if __name__ == "__main__":
    main()

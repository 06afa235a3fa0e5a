"""A decomposition round of the distributed trainer (world size 1 over
NCCL) against the single-device round, on the GPU, in one process.

Planted 60000 x 784 (gamma 0.25, C = 10, f32), q = 12288, cap 128: the
shape of ``chip_smoke.py``'s phase 10. Each path first runs ``--warm``
rounds from alpha = 0 (kernel loading, the NCCL communicator), then
``--rounds`` rounds timed by the host clock around a synchronised loop,
then one more round under torch.profiler: the device time of each of
the round's four ranges (``decomp.select``, ``decomp.k_ww``,
``decomp.subsolve``, ``decomp.rank_q``), the device time by kernel, and
the round's collectives. The paths are taken in turns (single,
distributed, distributed, single), since two calls may land on two cards.
Prints one JSON line per run and the card's name and power limit. Run on
the card:

    PYTHONPATH=. python scripts/dist_round_profile.py [--warm 3] [--rounds 8]
"""

import argparse
import json
import os
import subprocess
import tempfile
import time

import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

from dpsvm_tpu_torch import SVMConfig
from dpsvm_tpu_torch.data.synthetic import make_planted
from dpsvm_tpu_torch.parallel import dist_decomp as dd
from dpsvm_tpu_torch.parallel import dist_smo as ds
from dpsvm_tpu_torch.parallel import multihost
from dpsvm_tpu_torch.parallel.mesh import make_data_mesh
from dpsvm_tpu_torch.solver import decomp as sd

SPANS = ("decomp.select", "decomp.k_ww", "decomp.subsolve", "decomp.rank_q")


def _device_us(evt) -> float:
    if getattr(evt, "device_type", None) != torch.autograd.DeviceType.CUDA:
        return 0.0
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v:
            return float(v)
    return 0.0


def runner(path: str, x, y, cfg, group):
    """(carry, run) of a fresh run of ``path`` from alpha = 0."""
    mesh = make_data_mesh(1, group)
    q = cfg.working_set
    ws = sd.DecompWorkspace(mesh.device)
    if path == "single":
        prob = sd.DecompProblem.build(x, y, cfg, mesh.device)
        return sd.init_carry(prob.y), sd.make_runner(prob, cfg, q, ws)
    di = ds.prepare_distributed_inputs(x, y, cfg, mesh, None, None, None,
                                       decomp=True)
    return (dd.init_decomp_carry(di.prob, di.init),
            dd.make_dist_decomp_runner(di.prob, cfg, q, ws, len(y)))


def measure(path, x, y, cfg, group, warm, rounds) -> dict:
    cap = cfg.inner_iters
    carry, run = runner(path, x, y, cfg, group)
    carry, st = run(carry, warm * cap)
    torch.cuda.synchronize()
    t = time.perf_counter()
    carry, st2 = run(carry, (warm + rounds) * cap)
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t) / (st2.rounds - st.rounds)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        carry, st3 = run(carry, (warm + rounds + 1) * cap)
        torch.cuda.synchronize()
    avg = prof.key_averages()
    spans = {e.key: _device_us(e) / 1e3 for e in avg if e.key in SPANS}
    ops = sorted(((_device_us(e) / 1e3, e.key, e.count) for e in avg
                  if _device_us(e) > 0 and e.key not in SPANS),
                 reverse=True)
    return {"path": path, "rounds_timed": st2.rounds - st.rounds,
            "ms_per_round": host_ms, "span_device_ms": spans,
            "device_ms": sum(t for t, _, _ in ops),
            "nccl_device_ms": sum(t for t, n, _ in ops
                                  if "nccl" in n.lower()),
            "collective_calls": {e.key: e.count for e in avg
                                 if e.key.startswith(("nccl:",
                                                      "c10d::"))},
            "top_ops": [{"name": n[:70], "ms": t, "count": c}
                        for t, n, c in ops[:6]]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--warm", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("dist_round_profile: needs a CUDA device")
        return 2
    store = dist.FileStore(os.path.join(tempfile.mkdtemp(), "store"), 1)
    multihost.initialize(num_processes=1, process_id=0, store=store,
                         device="cuda:0")
    try:
        x, y = make_planted(60000, 784, 0.25, seed=0)
        cfg = SVMConfig(c=10.0, gamma=0.25, epsilon=1e-3,
                        working_set=12288, inner_iters=128,
                        max_iter=10 ** 9)
        for path in ("single", "distributed", "distributed", "single"):
            r = measure(path, x, y, cfg, dist.group.WORLD, args.warm,
                        args.rounds)
            print(json.dumps(r), flush=True)
    finally:
        dist.destroy_process_group()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

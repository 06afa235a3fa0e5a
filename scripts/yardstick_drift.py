"""Whether the timing phase's host-bound numbers depend on what ran before.

Runs ``chip_smoke.py``'s timing phase (kernel A's chunk, its plain version
and PyTorch yardstick; kernel B's round and its plain version; without the
batched one-vs-one step, which needs the multiclass phase's inputs) three
times in one process: fresh, after the tasks phase, and after
``gc.collect()`` and ``torch.cuda.empty_cache()``. Prints one ``[probe]``
JSON line per pass with the host's Python object count, the allocator's
reserved and allocated bytes, and the times. Needs one CUDA card:

    PYTHONPATH=. python3 scripts/yardstick_drift.py
"""
import gc
import json
import os
import sys
import time

import torch

import chip_smoke as cs



def probe(s, tag: str) -> None:
    t0 = time.perf_counter()
    rec = {"tag": tag, "gc_objects": len(gc.get_objects()),
           "gc_counts": gc.get_count(),
           "reserved_GiB": torch.cuda.memory_reserved() / 2 ** 30,
           "allocated_GiB": torch.cuda.memory_allocated() / 2 ** 30,
           "loadavg": os.getloadavg(), "cpus": os.cpu_count()}
    s.timing()
    t, d = s.rec["timing"], s.rec["timing_decomp"]
    for k in ("f32", "bf16"):
        a = t[k]["fused_update_select"]
        rec[k] = {"A_ms": a["ms"], "A_plain": a["plain_ms"],
                  "A_lib": a["library_ms"],
                  "B_ms": d[k]["inner_subsolve"]["ms"],
                  "B_plain": d[k]["inner_subsolve"]["plain_ms"]}
    rec["seconds"] = time.perf_counter() - t0
    print("[probe]", json.dumps(rec), flush=True)


def main() -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    s = cs.Smoke()
    s.build()
    s.timing_ovo = lambda: None      # needs the multiclass phase's inputs
    probe(s, "fresh")
    t = time.perf_counter()
    s.tasks()
    print(f"[tasks] phase {time.perf_counter() - t:.1f} s", flush=True)
    probe(s, "after tasks")
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    probe(s, "after gc.collect + empty_cache")
    print("failures:", s.failures, flush=True)
    return 1 if s.failures else 0


if __name__ == "__main__":
    sys.exit(main())

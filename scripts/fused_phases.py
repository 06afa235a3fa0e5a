"""Where one launch of kernel A's time goes, and what its design choices
are worth, on the GPU.

Builds instrumented copies of ``dpsvm_tpu_torch/csrc/fused_step.cu`` into
``dpsvm_tpu_torch/_build/phases/``. The copies are the source with
global-timer stamps added: block 0 after its decision and after its
prologue's rows, every block at the end of its pass, and the last block
at the end of its finalize. Some variants also change one design constant.
Each copy drives the main path's chunk loop through ``launch_fused_chunk``
at planted 60000 x 784, from a training run's first carry. It prints one
JSON line per variant and precision: the iteration's time (CUDA events
over a chunk of ``--iters`` launches) and the per-launch means of

    prologue       block 0: its rows read, reduced, the pair computed
    to_first_end   block 0's prologue end to the first block's pass end
    spread         first to last block's pass end
    finalize       last block's pass end to the end of its finalize

Variants are taken in turns (A B C, then C B A) within one call, since
two calls may land on two cards. Run on the card:

    PYTHONPATH=. python scripts/fused_phases.py [--iters 1000] [variant ...]

The stamps cost a few atomics a launch, so the iteration times here sit a
little above chip_smoke.py's.
"""

import argparse
import ctypes
import json
import subprocess

import numpy as np
import torch

from dpsvm_tpu_torch.build import BUILD_DIR, CSRC_DIR, NVCC_FLAGS, _nvcc
from dpsvm_tpu_torch.data.synthetic import make_planted
from dpsvm_tpu_torch.experimental import fused_step as fs
from dpsvm_tpu_torch.experimental.fused import init_fused_carry
from dpsvm_tpu_torch.ops.kernels import row_norms_sq

STAMPS = r'''
__device__ unsigned long long g_t[4] = {0ull, 0ull, ~0ull, 0ull};
__device__ unsigned long long g_acc[5];
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
extern "C" int phases_read(unsigned long long* out) {
  cudaDeviceSynchronize();
  int e = cudaMemcpyFromSymbol(out, g_acc, sizeof(unsigned long long) * 5);
  unsigned long long z[5] = {0, 0, 0, 0, 0};
  cudaMemcpyToSymbol(g_acc, z, sizeof(z));
  return e;
}
'''

# (anchor, text put before or after it) for the stamps
INSTRUMENT = [
    ("namespace {\n\n// Carry", STAMPS + "namespace {\n\n// Carry"),
    ("  if (!ctl[0]) return;\n",
     "  if (!ctl[0]) return;\n"
     "  if (blockIdx.x == 0 && tid == 0) g_t[0] = gtime();\n"),
    ("  __syncthreads();\n  float p00 = 0.0f, p11 = 0.0f, p01 = 0.0f;\n",
     "  __syncthreads();\n  if (blockIdx.x == 0 && tid == 0) g_t[1] = gtime();\n"
     "  float p00 = 0.0f, p11 = 0.0f, p01 = 0.0f;\n"),
    ("    is_last = take_ticket(",
     "    { const unsigned long long t = gtime(); atomicMin(&g_t[2], t);\n"
     "      atomicMax(&g_t[3], t); }\n    is_last = take_ticket("),
    ("    state[S_TICKET] = 0;\n  }\n}",
     "    state[S_TICKET] = 0;\n    const unsigned long long tf = gtime();\n"
     "    g_acc[0] += g_t[1] - g_t[0]; g_acc[1] += g_t[2] - g_t[1];\n"
     "    g_acc[2] += g_t[3] - g_t[2]; g_acc[3] += tf - g_t[3];\n"
     "    g_acc[4] += 1; g_t[2] = ~0ull; g_t[3] = 0;\n  }\n}"),
]

# name -> (source edits, warps a block)
VARIANTS = {
    "as_built": ([], fs.WARPS),
    "no_pool": ([("constexpr int kStaticShare = 85;",
                  "constexpr int kStaticShare = 100;")], fs.WARPS),
    "no_pdl": ([("programmaticStreamSerializationAllowed = 1;",
                 "programmaticStreamSerializationAllowed = 0;")], fs.WARPS),
    "no_early_copy": ([("  if (VEC && gw < dealt) pass.first_trip(gw, pre);\n",
                        ""),
                       ("VEC && !cur_pool ? pre : nullptr", "nullptr")],
                      fs.WARPS),
    "warps16": ([("constexpr int kWarps = 8;", "constexpr int kWarps = 16;")],
                16),
}


def build(name: str) -> ctypes.CDLL:
    edits, _ = VARIANTS[name]
    src = (CSRC_DIR / "fused_step.cu").read_text()
    for old, new in edits + INSTRUMENT:
        if old not in src:
            raise SystemExit(f"{name}: the source has no {old!r}")
        src = src.replace(old, new)
    out = BUILD_DIR / "phases"
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{name}.cu").write_text(src)
    so = out / f"lib{name}.so"
    r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(so),
                        str(out / f"{name}.cu")], capture_output=True,
                       text=True)
    if r.returncode:
        raise SystemExit(f"{name}: nvcc failed\n{r.stdout}{r.stderr}")
    report = [ln.strip() for ln in (r.stdout + r.stderr).splitlines()
              if "registers" in ln or "spill" in ln]
    print(json.dumps({"variant": name, "ptxas": report}), flush=True)
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in fs._ARGTYPES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.phases_read.argtypes = [ctypes.c_void_p]
    return lib


def measure(name: str, lib, x, x2, y, iters: int) -> dict:
    """One chunk of ``iters`` launches from a fresh training carry."""
    warps = VARIANTS[name][1]
    carry = init_fused_carry(torch.zeros_like(y), -y, y, 10.0)
    ws = fs.FusedWorkspace(x)
    if warps != fs.WARPS:                  # the variant's own smem layout
        g = ws.geometry
        ws.geometry = g._replace(
            smem=g.smem - (fs.WARPS - warps) * fs.UNROLL * fs.GROUP * 32 * 16)
    kw = dict(c=10.0, gamma=0.25, two_eps=2e-3, max_iter=10 ** 9)
    saved = fs._lib
    fs._lib = lambda: lib
    try:
        def chunk(n_it):
            start = ws.n_iter
            fs.launch_fused_chunk(carry, x, x2, y, ws, limit=start + n_it,
                                  **kw)
            ws.n_iter = fs.unpack_state(carry.state)[4]

        chunk(50)
        buf = (ctypes.c_ulonglong * 5)()
        lib.phases_read(buf)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        chunk(iters)
        t1.record()
        torch.cuda.synchronize()
        lib.phases_read(buf)
    finally:
        fs._lib = saved
    runs = max(buf[4], 1)
    us = [buf[i] / runs / 1e3 for i in range(4)]
    return {"variant": name, "x": str(x.dtype).split(".")[-1],
            "iteration_us": t0.elapsed_time(t1) / iters * 1e3,
            "prologue_us": us[0], "to_first_end_us": us[1],
            "spread_us": us[2], "finalize_us": us[3], "launches_run": buf[4]}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=1000)
    ap.add_argument("variants", nargs="*", default=list(VARIANTS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    unknown = set(args.variants) - set(VARIANTS)
    if unknown:
        raise SystemExit(f"unknown variants {sorted(unknown)}; "
                         f"known: {list(VARIANTS)}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    libs = {name: build(name) for name in args.variants}
    xs, ys = make_planted(60000, 784, 0.25, seed=0)
    y = torch.from_numpy(ys.astype(np.float32)).cuda()
    data = []
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.from_numpy(xs).cuda().to(dtype).contiguous()
        data.append((x, row_norms_sq(x)))
    order = args.variants + args.variants[::-1]
    for name in order:
        for x, x2 in data:
            print(json.dumps(measure(name, libs[name], x, x2, y,
                                     args.iters)), flush=True)


if __name__ == "__main__":
    main()

"""Where a step of kernel B (the decomposition's inner subsolve) spends its
time, by cluster size, on the GPU.

Builds an instrumented copy of ``dpsvm_tpu_torch/csrc/subsolve.cu`` into
``dpsvm_tpu_torch/_build/phases/``: the source with its timing hooks
(``PHASE_BEGIN``, ``PHASE``, ``PHASE_END``) defined, so that thread 0 of
block 0 stamps ``clock64`` at each phase of each step and adds the ticks
up in registers. A phase that ends with a row's loads also reads its own
last load, so it waits for it. The phases of a step:

    hi_row_in     the exchange named i_hi -> this thread's hi row is in
    partner_pass  the WSS2 objective over the thread's slots
    exchange_1    the partner's block reduction and cluster exchange
    scalar_step   the pair step and the owners' alpha and code writes
    lo_row_in     -> this thread's lo row is in (issued before the step)
    f_pass        the f update and the next selection's candidates
    exchange_2    the i_hi block reduction and cluster exchange

Ticks become microseconds through the launch's %globaltimer span over its
clock64 span. For each q it prints one JSON line per cluster size: the
launch's time with the uninstrumented kernel (CUDA events over ``--reps``
launches of ``--cap`` steps), its time a step, and the phases a step with
the instrumented one. Cluster sizes are taken in turns (1 2 4 8 16, then
16 8 4 2 1) within one call, since two calls may land on two cards; a
cluster whose block does not fit in shared memory is reported as such.
The block is K_WW of q planted 60000 x 784 rows (gamma 0.25, C = 10) from
alpha = 0, f = -y, as a decomposition's first round sees it. With
``--parent DIR`` (an unpacked earlier commit) it also builds that commit's
``subsolve.cu`` and times it on the same blocks, before and after the
sweep, through its own C entry (the one-block kernel's signature). Run on
the card:

    PYTHONPATH=. python scripts/subsolve_phases.py [--reps 20] [--q 1024 4096]
        [--parent _archive/parent]
"""

import argparse
import ctypes
import json
import subprocess

import numpy as np
import torch

from dpsvm_tpu_torch.build import BUILD_DIR, CSRC_DIR, NVCC_FLAGS, _nvcc
from dpsvm_tpu_torch.data.synthetic import make_planted
from dpsvm_tpu_torch.experimental import subsolve_kernel as sk
from dpsvm_tpu_torch.ops.kernels import host_row_norms_sq, rows_from_dots

PHASES = ("hi_row_in", "partner_pass", "exchange_1", "scalar_step",
          "lo_row_in", "f_pass", "exchange_2")
CLUSTERS = (1, 2, 4, 8, 16)
N, D, GAMMA, C = 60000, 784, 0.25, 10.0

HOOKS = r'''
__device__ unsigned long long g_acc[13];
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
extern "C" int phases_read(unsigned long long* out) {
  cudaDeviceSynchronize();
  int e = cudaMemcpyFromSymbol(out, g_acc, sizeof(unsigned long long) * 12);
  unsigned long long z[12] = {};
  cudaMemcpyToSymbol(g_acc, z, sizeof(z));
  return e;
}
#define PHASE_BEGIN                                                      \
  const bool ph_on = rank == 0 && tid == 0;                              \
  long long ph_acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};                        \
  const long long ph_c0 = clock64();                                     \
  long long ph_last = ph_c0;                                             \
  unsigned ph_dep = 0;                                                   \
  const unsigned long long ph_t0 = gtime()
#define PHASE(k, v)                                                      \
  do {                                                                   \
    if (ph_on) {                                                         \
      ph_dep += __float_as_uint(v) == 0xFFFFFFFFu;                       \
      const long long ph_now = clock64();                                \
      ph_acc[k] += ph_now - ph_last;                                     \
      ph_last = ph_now;                                                  \
    }                                                                    \
  } while (0)
#define PHASE_END(t)                                                     \
  do {                                                                   \
    if (ph_on) {                                                         \
      for (int ph_i = 0; ph_i < 8; ++ph_i) g_acc[ph_i] += ph_acc[ph_i];  \
      g_acc[8] += gtime() - ph_t0;                                       \
      g_acc[9] += (t);                                                   \
      g_acc[10] += 1;                                                    \
      g_acc[11] += clock64() - ph_c0;                                    \
      g_acc[12] += ph_dep;                                               \
    }                                                                    \
  } while (0)
'''


def build() -> ctypes.CDLL:
    out = BUILD_DIR / "phases"
    out.mkdir(parents=True, exist_ok=True)
    src = out / "subsolve_phases.cu"
    src.write_text(HOOKS + (CSRC_DIR / "subsolve.cu").read_text())
    so = out / "libsubsolve_phases.so"
    r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(so), str(src)],
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"nvcc failed\n{r.stdout}{r.stderr}")
    report = [ln.strip() for ln in (r.stdout + r.stderr).splitlines()
              if "registers" in ln or "spill" in ln]
    print(json.dumps({"instrumented_ptxas": report}), flush=True)
    lib = ctypes.CDLL(str(so))
    lib.dpsvm_inner_subsolve.argtypes = sk._ARGTYPES
    lib.dpsvm_inner_subsolve.restype = ctypes.c_int
    lib.phases_read.argtypes = [ctypes.c_void_p]
    return lib


def build_parent(root: str) -> ctypes.CDLL:
    """An earlier commit's kernel B, with its one-block C entry."""
    out = BUILD_DIR / "phases"
    out.mkdir(parents=True, exist_ok=True)
    so = out / "libsubsolve_parent.so"
    r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(so),
                        f"{root}/dpsvm_tpu_torch/csrc/subsolve.cu"],
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"nvcc failed on the parent\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.dpsvm_inner_subsolve.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int, ctypes.c_float]
        + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.dpsvm_inner_subsolve.restype = ctypes.c_int
    return lib


def measure_parent(lib, inp, q: int, cap: int, reps: int) -> dict:
    k, y, c, a0, f0, act = inp
    a, f = torch.empty_like(a0), torch.empty_like(f0)
    out = torch.zeros(3, dtype=torch.int32, device="cuda")
    runs = torch.zeros(2, dtype=torch.int32, device="cuda")

    def launch():
        rc = lib.dpsvm_inner_subsolve(
            k.data_ptr(), y.data_ptr(), c.data_ptr(), act.data_ptr(),
            a0.data_ptr(), f0.data_ptr(), a.data_ptr(), f.data_ptr(),
            out.data_ptr(), runs.data_ptr(), q,
            float(sk.two_eps_f32(1e-3)), cap, cap, 0,
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"parent kernel: CUDA error {rc}")

    launch()
    torch.cuda.synchronize()
    steps = int(out[2])
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        launch()
    t1.record()
    torch.cuda.synchronize()
    ms = t0.elapsed_time(t1) / reps
    return {"q": q, "kernel": "parent", "steps": steps, "ms": ms,
            "us_per_step": ms * 1e3 / max(steps, 1)}


def block(q: int, xs, ys, seed: int):
    """(K_WW, y, c, alpha, f, active) of q planted rows, alpha = 0."""
    idx = np.sort(np.random.default_rng(seed).choice(N, q, replace=False))
    rows = torch.from_numpy(xs[idx]).cuda()
    x2 = torch.from_numpy(host_row_norms_sq(xs[idx])).cuda()
    k = rows_from_dots(rows @ rows.T, x2, x2, GAMMA).contiguous()
    y = torch.from_numpy(ys[idx].astype(np.float32)).cuda()
    return (k, y, torch.full((q,), C, device="cuda"), torch.zeros(q,
            device="cuda"), (-y).contiguous(),
            torch.ones(q, dtype=torch.bool, device="cuda"))


def measure(lib, inp, q: int, cluster: int, cap: int, reps: int) -> dict:
    g = sk.launch_geometry(q, 132, cluster)

    def launch():
        return sk.launch_inner_subsolve(*inp, 1e-3, cap, max_cap=cap,
                                        pairwise=False, cluster=cluster)

    steps = int(launch()[4])                     # warm up, and the steps
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        launch()
    t1.record()
    torch.cuda.synchronize()
    ms = t0.elapsed_time(t1) / reps
    buf = (ctypes.c_ulonglong * 12)()
    saved = sk._lib
    sk._lib = lambda: lib
    try:
        lib.phases_read(buf)
        for _ in range(reps):
            launch()
        lib.phases_read(buf)
    finally:
        sk._lib = saved
    ns_per_tick = buf[8] / max(buf[11], 1)
    n_steps = max(buf[9], 1)
    phases = {name: buf[i] * ns_per_tick / n_steps / 1e3
              for i, name in enumerate(PHASES)}
    return {"q": q, "cluster": g.cluster, "threads": g.threads,
            "slots": g.slots, "per": g.per, "steps": steps, "ms": ms,
            "us_per_step": ms * 1e3 / max(steps, 1),
            "instrumented_us_per_step": buf[8] / n_steps / 1e3,
            "setup_and_entry_us": buf[7] * ns_per_tick / max(buf[10], 1)
            / 1e3, "phases_us_per_step": phases,
            "launches_stamped": buf[10]}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--cap", type=int, default=128)
    ap.add_argument("--q", type=int, nargs="*",
                    default=[256, 512, 1024, 2048, 4096, 12288, 16384])
    ap.add_argument("--parent", help="an earlier commit's root, timed too")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    lib = build()
    parent = build_parent(args.parent) if args.parent else None
    xs, ys = make_planted(N, D, GAMMA, seed=0)
    for q in args.q:
        inp = block(q, xs, ys, seed=q)
        fits = []
        for cl in CLUSTERS:
            try:
                sk.launch_geometry(q, 132, cl)
                fits.append(cl)
            except ValueError as e:
                print(json.dumps({"q": q, "cluster": cl, "fits": False,
                                  "why": str(e)}), flush=True)
        turns = [None] + fits + fits[::-1] + [None]
        for cl in turns if parent else fits + fits[::-1]:
            r = (measure_parent(parent, inp, q, args.cap, args.reps)
                 if cl is None else
                 measure(lib, inp, q, cl, args.cap, args.reps))
            print(json.dumps(r), flush=True)
        del inp
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()

"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase (what a release check runs)
    python3 chip_smoke.py --quick    # build + kernels against plain only

Phases, each of which makes the script exit non-zero if it fails:

1. build every CUDA source of the port with nvcc (``dpsvm_tpu_torch/build``);
2. hold each kernel of the training path against its plain PyTorch version
   on the card at 60000 x 784 (and a ragged 60001), float32 and bfloat16 X,
   with alpha exactly at 0 and at C and deliberate ties within and across
   blocks: one SMO body through ``launch_fused_chunk``, the wrapper the
   training loop calls, against one plain body from the same state;
3. drive the main path at full width through the entry points a user
   calls: ``api.fit`` on planted 60000 x 784 data (C=10, gamma=0.25,
   eps=1e-3) to convergence in both precisions, then ``save_model``,
   ``load_model`` and ``evaluate`` on 10000 held-out rows; each kernel's
   device-counted runs must equal the iterations run;
4. the kernel path against the plain path, both on the card: ``fit`` and
   ``train_single_device_plain`` at 60000 x 784 for PREFIX_ITERS
   iterations (the same n_iter, alpha within rtol 1e-4 / atol 1e-5,
   held-out decision values within 5e-3), and both converged on 4096 x
   784 with n_sv within 2% or 3 and held-out accuracy within one example
   (``Smoke.convergence`` says why the bar splits so);
5. time each kernel on the main path (a chunk of TIMED_ITERS iterations,
   device times per kernel from torch.profiler), its plain version and a
   PyTorch yardstick, and print the ``{"kernels": [...]}`` line, the
   card's name and power limit, and last ``{"ok": true, "device": {...}}``.

It imports nothing of JAX and nothing of the JAX package. Without a CUDA
device, or without the port beside it, it exits 2 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet, HBM3
FP32_FLOPS_PER_S = 67e12      # H100 SXM data sheet, fp32 outside tensor cores
N, D, GAMMA, C = 60000, 784, 0.25, 10.0
TWO_EPS = 2e-3
# f of kernel and plain version within F_RTOL * max(1, |f|): each sums 784
# float32 products in its own order (warp shuffles against cuBLAS), which
# moves a dot product by ~sqrt(784) ulps; the RBF epilogue scales that by
# 2 gamma |d| K <= ~0.5 here. Measured max |df|: 2.4e-7 on |f| <= 6.
F_RTOL = 1e-5
MAIN_MAX_ITER = 400_000
PREFIX_ITERS = 100
TIMED_ITERS = 500


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 50, warmup: int = 5) -> float:
    """Mean device time of one call: CUDA events around ``reps`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_us(evt) -> float:
    """Device time of a profiler entry, 0 for host entries."""
    import torch
    if getattr(evt, "device_type", None) != torch.autograd.DeviceType.CUDA:
        return 0.0
    for name in ("self_device_time_total", "device_time_total",
                 "self_cuda_time_total", "cuda_time_total"):
        v = getattr(evt, name, None)
        if v:
            return float(v)
    return 0.0


class Smoke:
    def __init__(self):
        import torch
        self.torch = torch
        self.dev = torch.device("cuda")
        self.failures = []
        self.rec = {}
        self._planted = None

    def fail(self, phase: str, msg: str) -> None:
        self.failures.append(f"{phase}: {msg}")
        log(f"FAIL {phase}: {msg}")

    def planted(self):
        """(xtr, ytr, xte, yte): planted 60000 x 784 and 10000 held out."""
        if self._planted is None:
            from dpsvm_tpu_torch.data.synthetic import make_planted
            x, y = make_planted(N + 10000, D, GAMMA, seed=0)
            self._planted = x[:N], y[:N], x[N:], y[N:]
        return self._planted

    # ------------------------------------------------------------ phase 1
    def build(self) -> None:
        from dpsvm_tpu_torch.build import build_all
        t0 = time.perf_counter()
        report = build_all()
        log(f"[build] {time.perf_counter() - t0:.2f} s wall")
        for name, r in report.items():
            log(f"[build] {name}: nvcc {r['seconds']:.2f} s -> {r['path']}")
            for ln in r["log"].splitlines():
                if "registers" in ln or "spill" in ln or "Compiling" in ln:
                    log(f"[build]   {ln.strip()}")

    # ------------------------------------------------------------ phase 2
    def kernel_inputs(self, n: int, x_dtype, zero_deltas: bool, seed: int):
        """X, x2, y, alpha, f on the card, with alpha at 0, C and inside,
        and duplicate rows at the tie indices so that the tied f values
        stay bitwise equal after the update. Also the working pair: with
        zero_deltas, a pair whose clipped step is zero on both sides
        (i_hi: y = -1, i_lo: y = +1, both alpha = 0, b_hi < b_lo), so that
        f stays as made and the ties decide the selection."""
        torch = self.torch
        from dpsvm_tpu_torch.data.synthetic import make_planted
        from dpsvm_tpu_torch.ops.kernels import row_norms_sq
        rng = np.random.default_rng(seed)
        x, y = make_planted(n, D, GAMMA, seed=seed)
        y = y.astype(np.float32)
        alpha = rng.choice([0.0, C, 0.5], size=n).astype(np.float32)
        inner = alpha == 0.5
        alpha[inner] = rng.uniform(0.1, C - 0.1, inner.sum())
        f = (-y + rng.normal(0, 0.5, n)).astype(np.float32)
        # I_up ties (alpha 0, y +1), two in one block and two across;
        # I_low ties (alpha 0, y -1) likewise.
        up = [5, 6, n // 2, n - 1]
        low = [7, 9, 3 * n // 4, n - 2]
        for idx, lab, val in ((up, 1.0, -6.0), (low, -1.0, 6.0)):
            x[idx] = x[idx[0]]
            y[idx] = lab
            alpha[idx] = 0.0
            f[idx] = val
        alpha[[11, 12]] = 0.5 * C
        pair = (low[1], up[1]) if zero_deltas else (11, 12)
        xd = torch.from_numpy(x).to(self.dev).to(x_dtype).contiguous()
        t = lambda a: torch.from_numpy(a).to(self.dev)
        return (dict(x=xd, x2=row_norms_sq(xd), y=t(y), alpha=t(alpha),
                     f=t(f)), pair, up[0], low[0])

    def check_kernels(self) -> None:
        torch = self.torch
        from dpsvm_tpu_torch.experimental import fused_step as fs
        errs = dict.fromkeys(fs.KERNELS, 0.0)
        near_ties = []
        for x_dtype in (torch.float32, torch.bfloat16):
            for n in (N, N + 1):
                for zero in (True, False):
                    tag = (f"{str(x_dtype).split('.')[-1]} n={n} "
                           f"{'zero-delta' if zero else 'update'}")
                    inp, pair, first_up, first_low = self.kernel_inputs(
                        n, x_dtype, zero, seed=n % 7)
                    x, x2, y = inp["x"], inp["x2"], inp["y"]
                    state = fs.pack_state(pair[0], pair[1], -1.0, 1.0, 0,
                                          self.dev)
                    k = fs.FusedCarry(inp["alpha"].clone(), inp["f"].clone(),
                                      state.clone())
                    p = fs.FusedCarry(inp["alpha"].clone(), inp["f"].clone(),
                                      state.clone())
                    ws = fs.FusedWorkspace(x)
                    fs.launch_fused_chunk(k, x, x2, y, ws, c=C, gamma=GAMMA,
                                          two_eps=TWO_EPS, limit=1,
                                          max_iter=1)
                    rows_p, sc_p = fs.fused_prologue_plain(
                        state, x, x2, y, inp["alpha"].clone(), C, GAMMA)
                    fs.fused_smo_body_plain(p, x, x2, y, C, GAMMA)
                    torch.cuda.synchronize()
                    ks, ps = k.state.tolist(), p.state.tolist()
                    ran = [ks[fs.S_RUN_PROLOGUE], ks[fs.S_RUN_PASS],
                           ks[fs.S_NITER]]
                    if ran != [1, 1, 1] or ps[fs.S_NITER] != 1:
                        self.fail("kernel", f"{tag}: one body ran "
                                  f"(prologue, pass, n_iter) = {ran}")
                    # prologue: rows, scalars, the alpha pair
                    perr = max(float((k.alpha - p.alpha).abs().max()),
                               float((ws.scalars - sc_p).abs().max()))
                    ptol = F_RTOL * max(1.0, float(sc_p.abs().max()))
                    errs["fused_prologue"] = max(errs["fused_prologue"], perr)
                    rows_eq = torch.equal(ws.rows, rows_p)
                    if not rows_eq or not perr <= ptol:
                        self.fail("kernel", f"{tag}: prologue err {perr:.3g}"
                                  f" (tol {ptol:.3g}) rows equal {rows_eq}")
                    # pass + finalize: f, [i_hi, i_lo], [b_hi, b_lo]
                    err = float((k.f - p.f).abs().max())
                    tol = F_RTOL * max(1.0, float(p.f.abs().max()))
                    errs["fused_update_select"] = max(
                        errs["fused_update_select"], err)
                    if not err <= tol:
                        self.fail("kernel", f"{tag}: max |df| {err:.3g} > "
                                  f"{tol:.3g}")
                    si_k = ks[fs.S_IHI:fs.S_ILO + 1]
                    si_p = ps[fs.S_IHI:fs.S_ILO + 1]
                    if zero and si_k != [first_up, first_low]:
                        self.fail("kernel", f"{tag}: ties picked {si_k}, "
                                  f"first indices are "
                                  f"{[first_up, first_low]}")
                    if si_k != si_p:
                        cand = [abs(float(p.f[a] - p.f[b]))
                                for a, b in zip(si_k, si_p)]
                        if max(cand) <= tol:
                            near_ties.append(f"{tag}: kernel {si_k} plain "
                                             f"{si_p} (|df| {cand})")
                            log(f"[kernel] near-tie {near_ties[-1]}")
                        else:
                            self.fail("kernel", f"{tag}: sel_i {si_k} vs "
                                      f"plain {si_p}")
                    b_k = k.state[fs.S_BHI:fs.S_BLO + 1].view(torch.float32)
                    b_p = p.state[fs.S_BHI:fs.S_BLO + 1].view(torch.float32)
                    verr = float((b_k - b_p).abs().max())
                    if not verr <= tol:
                        self.fail("kernel", f"{tag}: sel_v err {verr:.3g}")
                    log(f"[kernel] {tag}: max|df| {err:.3g} (tol {tol:.3g}) "
                        f"sel_i {si_k} plain {si_p}; prologue err "
                        f"{perr:.3g}")
        self.rec["max_abs_err"] = errs
        self.rec["near_ties"] = near_ties

    # ------------------------------------------------------------ phase 3
    def main_path(self) -> None:
        torch = self.torch
        from dpsvm_tpu_torch import SVMConfig, evaluate, fit, load_model
        from dpsvm_tpu_torch import save_model
        from dpsvm_tpu_torch.experimental import fused_step as fs
        from dpsvm_tpu_torch.models.svm import decision_function
        xtr, ytr, xte, yte = self.planted()
        self.rec["main"] = {}
        launches = dict.fromkeys(fs.KERNELS, 0)
        runs = dict.fromkeys(fs.KERNELS, 0)
        for prec in ("highest", "default"):
            cfg = SVMConfig(c=C, gamma=GAMMA, epsilon=1e-3,
                            max_iter=MAIN_MAX_ITER, matmul_precision=prec)
            torch.cuda.reset_peak_memory_stats()
            fs.reset_counts()
            model, res = fit(xtr, ytr, cfg)
            got = {"launches": dict(fs.LAUNCHES), "runs": dict(fs.RUNS)}
            peak = torch.cuda.max_memory_allocated()
            for name in fs.KERNELS:
                ln, rn = got["launches"][name], got["runs"][name]
                launches[name] += ln
                runs[name] += rn
                if rn != res.n_iter or ln < rn or ln == 0:
                    self.fail("main", f"{prec}: {name} enqueued {ln} "
                              f"launches, ran {rn}, for {res.n_iter} "
                              f"iterations")
            t = time.perf_counter()
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "model.svm")
                wrote = save_model(model, path)
                loaded = load_model(path)
            io_s = time.perf_counter() - t
            same = (wrote == model.n_sv
                    and np.array_equal(loaded.x_sv, model.x_sv)
                    and np.array_equal(loaded.alpha, model.alpha)
                    and np.array_equal(loaded.y_sv, model.y_sv))
            t = time.perf_counter()
            dec = decision_function(loaded, xte)
            eval_s = time.perf_counter() - t
            acc = evaluate(loaded, xte, yte)
            ok = (same and res.converged and np.all(np.isfinite(dec))
                  and dec.shape == (10000,) and acc > 0.9
                  and np.all(np.isfinite(res.alpha)))
            if not ok:
                self.fail("main", f"{prec}: model round trip {same}, "
                          f"converged {res.converged}, finite "
                          f"{np.all(np.isfinite(dec))}, acc {acc}")
            r = {"n_iter": res.n_iter, "converged": res.converged,
                 "gap": res.gap, "n_sv": res.n_sv, "b": res.b,
                 "train_seconds": res.train_seconds,
                 "iters_per_s": res.n_iter / res.train_seconds,
                 **got, "peak_bytes": int(peak),
                 "save_load_seconds": io_s, "eval_seconds": eval_s,
                 "heldout_accuracy": acc}
            self.rec["main"][prec] = r
            log(f"[main] {prec}: {json.dumps(r)}")
        self.rec["main_launches"] = launches
        self.rec["main_runs"] = runs

    # ------------------------------------------------------------ phase 4
    def convergence(self) -> None:
        """Kernel path against plain path, both on the card. The two sum
        the dot products in different orders, so after some hundreds of
        iterations a near-tie goes the other way and the trajectories
        part; with the reference's independent clip the two then
        converge to models whose sum(alpha * y) drifted differently
        (the JAX package's own XLA path and NumPy oracle part the same
        way: scripts/trajectory_spread.py). So the iterates are held to
        the float32 bars on a prefix of PREFIX_ITERS iterations at the
        main shape, where both paths pick the same working sets, and the
        converged models, on a problem small enough to converge in
        seconds on the plain path, to the repo's LibSVM bar: n_sv within
        2% or 3, held-out accuracy within one example."""
        from dpsvm_tpu_torch import SVMConfig, fit
        from dpsvm_tpu_torch.data.synthetic import make_planted
        from dpsvm_tpu_torch.experimental.fused import (
            train_single_device_plain)
        from dpsvm_tpu_torch.models.svm import (SVMModel, decision_function,
                                                evaluate)
        x, y = make_planted(5096, D, GAMMA, seed=2)
        small = (x[:4096], y[:4096], x[4096:], y[4096:])
        self.rec["convergence"] = {}
        for prec in ("highest", "default"):
            r = {}
            for what, (xtr, ytr, xte, yte), max_iter in (
                    ("prefix", self.planted(), PREFIX_ITERS),
                    ("converged", small, 200_000)):
                cfg = SVMConfig(c=C, gamma=GAMMA, epsilon=1e-3,
                                max_iter=max_iter, matmul_precision=prec)
                mk, rk = fit(xtr, ytr, cfg)
                rp = train_single_device_plain(xtr, ytr, cfg, self.dev)
                mp = SVMModel.from_train_result(xtr, ytr, rp)
                dmax = float(np.abs(decision_function(mk, xte)
                                    - decision_function(mp, xte)).max())
                acc_k, acc_p = evaluate(mk, xte, yte), evaluate(mp, xte, yte)
                r[what] = {
                    "n": len(ytr),
                    "kernel": {"n_iter": rk.n_iter, "n_sv": rk.n_sv,
                               "converged": rk.converged, "b": rk.b,
                               "sum_alpha_y": float(np.sum(rk.alpha * ytr)),
                               "seconds": rk.train_seconds,
                               "heldout_accuracy": acc_k},
                    "plain": {"n_iter": rp.n_iter, "n_sv": rp.n_sv,
                              "converged": rp.converged, "b": rp.b,
                              "sum_alpha_y": float(np.sum(rp.alpha * ytr)),
                              "seconds": rp.train_seconds,
                              "heldout_accuracy": acc_p},
                    "max_alpha_diff": float(np.abs(rk.alpha
                                                   - rp.alpha).max()),
                    "max_decision_diff": dmax}
                if what == "prefix":
                    ok = (rk.n_iter == rp.n_iter == PREFIX_ITERS
                          and rk.n_sv == rp.n_sv and dmax <= 5e-3
                          and np.allclose(rk.alpha, rp.alpha, rtol=1e-4,
                                          atol=1e-5))
                else:
                    ok = (rk.converged and rp.converged
                          and abs(rk.n_sv - rp.n_sv)
                          <= max(0.02 * rp.n_sv, 3.0)
                          and abs(acc_k - acc_p) <= 1.0 / len(yte) + 1e-9)
                if not ok:
                    self.fail("convergence", f"{prec} {what}: {r[what]}")
            self.rec["convergence"][prec] = r
            log(f"[convergence] {prec}: {json.dumps(r)}")

    # ------------------------------------------------------------ phase 5
    def timing(self) -> None:
        """Each kernel as the main path runs it: a training run's carry at
        its start, advanced by chunks of TIMED_ITERS iterations through
        ``launch_fused_chunk``. The iteration's time is CUDA events around
        one chunk; each kernel's device time is torch.profiler's sum over
        another chunk, divided by its iterations (the chunk's trailing
        slot, three launches that exit at once, is in the sum)."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        from dpsvm_tpu_torch.experimental import fused_step as fs
        from dpsvm_tpu_torch.experimental.fused import init_fused_carry
        from dpsvm_tpu_torch.ops.kernels import row_norms_sq
        from dpsvm_tpu_torch.ops.selection import masked_scores
        xtr, ytr, _, _ = self.planted()
        out = {}
        for x_dtype in (torch.float32, torch.bfloat16):
            key = "f32" if x_dtype == torch.float32 else "bf16"
            x = torch.from_numpy(xtr).to(self.dev).to(x_dtype).contiguous()
            x2 = row_norms_sq(x)
            y = torch.from_numpy(ytr.astype(np.float32)).to(self.dev)
            carry = init_fused_carry(torch.zeros_like(y), -y, y, C)
            ws = fs.FusedWorkspace(x)
            kw = dict(c=C, gamma=GAMMA, two_eps=TWO_EPS, max_iter=10**9)

            def chunk(iters):
                start = ws.n_iter
                fs.launch_fused_chunk(carry, x, x2, y, ws,
                                      limit=start + iters, **kw)
                ws.n_iter = fs.unpack_state(carry.state)[4]   # syncs
                if ws.n_iter != start + iters:
                    raise RuntimeError(f"{key}: chunk ran {ws.n_iter - start}"
                                       f" of {iters} iterations")

            chunk(50)                                         # warm up
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            chunk(TIMED_ITERS)
            t1.record()
            torch.cuda.synchronize()
            iter_ms = t0.elapsed_time(t1) / TIMED_ITERS
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                chunk(TIMED_ITERS)
                torch.cuda.synchronize()
            dev_ms = {}
            for evt in prof.key_averages():
                for kern in ("prologue_kernel", "pass_kernel",
                             "finalize_kernel"):
                    if kern in evt.key:
                        dev_ms[kern] = dev_ms.get(kern, 0.0) + _device_us(
                            evt) / 1e3 / TIMED_ITERS
            if len(dev_ms) != 3 or not all(v > 0 for v in dev_ms.values()):
                raise RuntimeError(f"{key}: torch.profiler gave no device "
                                   f"time per kernel: {dev_ms}")
            # The plain versions and the yardstick on the same inputs: the
            # carry and the last body's rows and scalars.
            rows, scal = ws.rows.clone(), ws.scalars.clone()
            alpha, f = carry.alpha.clone(), carry.f.clone()
            f_scratch, a_scratch = f.clone(), alpha.clone()
            state = carry.state.clone()

            def yardstick():
                dots = torch.matmul(rows, x.T).float()
                k = torch.exp(-scal[2] * (x2[None, :] + scal[3:5, None]
                                          - 2.0 * dots))
                fn = f + scal[0] * k[0] + scal[1] * k[1]
                f_up, f_low = masked_scores(alpha, y, fn, C)
                return torch.argmin(f_up), torch.argmax(f_low)

            plain = time_ms(lambda: fs.fused_update_select_plain(
                rows, scal, x, x2, y, alpha, f_scratch), reps=20)
            lib = time_ms(yardstick, reps=20)
            p_plain = time_ms(lambda: fs.fused_prologue_plain(
                state, x, x2, y, a_scratch, C, GAMMA), reps=20)
            el = x.element_size()
            bytes_ = N * D * el + 2 * D * el + 5 * N * 4 + 8 * 4
            flops = 4 * N * D
            bound = max(bytes_ / HBM_BYTES_PER_S,
                        flops / FP32_FLOPS_PER_S) * 1e3
            p_bytes = 4 * D * el + 16 * 4
            p_bound = max(p_bytes / HBM_BYTES_PER_S,
                          6 * D / FP32_FLOPS_PER_S) * 1e3
            us_ms = dev_ms["pass_kernel"] + dev_ms["finalize_kernel"]
            out[key] = {
                "iteration_ms": iter_ms, "device_ms": dev_ms,
                "fused_update_select": {
                    "ms": us_ms, "plain_ms": plain, "library_ms": lib,
                    "bound_ms": bound, "bytes": bytes_, "flops": flops,
                    "pass_hbm_GBps": bytes_ / dev_ms["pass_kernel"] / 1e6},
                "fused_prologue": {
                    "ms": dev_ms["prologue_kernel"], "plain_ms": p_plain,
                    "library_ms": None, "bound_ms": p_bound}}
            log(f"[timing] {key}: {json.dumps(out[key])}")
        self.rec["timing"] = out

    def kernels_line(self) -> dict:
        t, errs = self.rec["timing"], self.rec["max_abs_err"]
        src = "dpsvm_tpu_torch/csrc/fused_step.cu"
        rows = []
        for name, replaces in (
                ("fused_update_select",
                 "dpsvm_tpu/experimental/fused_step.py:55 (_fused_iter_kernel"
                 ", pallas_call at :137)"),
                ("fused_prologue",
                 "dpsvm_tpu/experimental/fused_step.py:193 (scalar prologue "
                 "of fused_smo_body, XLA ops)")):
            f32, bf16 = t["f32"][name], t["bf16"][name]
            rows.append({
                "name": name, "route": "cuda", "source": src,
                "replaces": replaces,
                "launches": self.rec["main_launches"][name],
                "runs": self.rec["main_runs"][name],
                "max_abs_err": errs[name], "max_err": errs[name],
                "ms": f32["ms"], "plain_ms": f32["plain_ms"],
                "bound_ms": f32["bound_ms"], "bound_by": "bytes",
                "library_ms": f32["library_ms"],
                "bf16": {k: bf16[k] for k in ("ms", "plain_ms", "bound_ms",
                                              "library_ms")}})
        return {"kernels": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="build and check the kernels only")
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs a GPU",
              file=sys.stderr)
        return 2
    try:
        import dpsvm_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False    # plain versions in f32
    torch.backends.cudnn.allow_tf32 = False
    s = Smoke()
    t0 = time.perf_counter()
    phases = [("build", s.build), ("kernel", s.check_kernels)]
    if not args.quick:
        phases += [("main", s.main_path), ("convergence", s.convergence),
                   ("timing", s.timing)]
    for name, fn in phases:
        t = time.perf_counter()
        try:
            fn()
        except Exception as e:            # every phase's failure is fatal
            import traceback
            traceback.print_exc()
            s.fail(name, f"{type(e).__name__}: {e}")
        log(f"[{name}] phase {time.perf_counter() - t:.1f} s")
        if name == "build" and s.failures:
            break
    if s.failures:
        print("chip_smoke FAILED:\n  " + "\n  ".join(s.failures),
              file=sys.stderr)
        return 1
    log(f"[total] {time.perf_counter() - t0:.1f} s")
    if not args.quick:
        print(json.dumps(s.kernels_line()))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0
          and smi.stdout.strip() else f"nvidia-smi failed: {smi.stderr}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

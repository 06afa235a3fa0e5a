"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase (what a release check runs)
    python3 chip_smoke.py --quick    # build + kernels against plain only

Phases, each of which makes the script exit non-zero if it fails. Three
solver paths run: the fused SMO pair (kernel A, ``working_set=2``), the
general SMO pair (``solver/smo.py``: PyTorch calls in a captured CUDA graph,
for WSS2 and the other kernel kinds) and the large-working-set
decomposition (kernel B, ``working_set=DECOMP_Q``,
``inner_iters=DECOMP_CAP``).

1. build every CUDA source of the port with nvcc, one process per source,
   in parallel (``dpsvm_tpu_torch/build``), and print each kernel's
   registers, spills and shared memory, and kernel B's launch shape
   (cluster, threads, slots a block, shared memory) at the q it is timed
   at;
2. hold each kernel against its plain PyTorch version on the card, through
   the wrapper the training loop calls. Kernel A (one launch an iteration:
   the scalar prologue, the pass and the finalize): one SMO body through
   ``launch_fused_chunk`` at 60000 x 784 (and a ragged 60001), float32 and
   bfloat16 X, with alpha exactly at 0 and at C and deliberate ties within
   and across blocks, against ``fused_prologue_plain`` and
   ``fused_smo_body_plain``; its device-counted runs one. Kernel B:
   ``launch_inner_subsolve`` on K_WW blocks of planted 784-wide rows at q
   in SUBSOLVE_QS (1030 is ragged), caps 1, 37 and 128 with both clips,
   weighted boxes with masked slots, a mid-run state, a dynamic step cap
   below the static one and an already-optimal block: bitwise the same (a,
   f, b_hi, b_lo, t), and the kernel's own run count one per launch. Then
   kernel B's cluster edges at full width: q = MAX_Q, a short last block
   (q = 12290), q below the cluster size (4 and 33 in a forced cluster of
   16), ties on f and on the WSS2 objective in two different blocks,
   i_hi == i_lo, and a NaN in f (the same non-finite b's and t). Kernel B
   under every other kernel kind: the K_WW of a first decomposition round
   at q = DECOMP_Q for linear, poly and sigmoid at 60000 x 784 and for a
   precomputed K (PRE_N rows), bitwise. The general pair's captured chunk
   against its eager loop, bitwise, for GRAPH_CHECK_ITERS iterations of
   WSS2 at 60000 x 784 in both precisions, of each other kind, and of the
   first-order RBF pair;
3. drive the paths at full width through the entry points a user calls:
   ``api.fit`` on planted 60000 x 784 data (C=10, gamma=0.25, eps=1e-3) to
   convergence in both precisions, then ``save_model``, ``load_model`` and
   ``evaluate`` on 10000 held-out rows. The counts are set to 0 before each
   path and read after it: kernel A's device-counted runs must equal the
   iterations; kernel B's launches, runs and rounds must be equal and its
   device-counted steps must add up to n_iter. The decomposition's model
   must match the pair's (n_sv within 2%, held-out accuracy within 0.5%).
   Then the general pair: WSS2 (``selection="second-order"``) to
   convergence in both precisions through fit, save, load and evaluate,
   held to the fused model by the same bar; linear, poly and sigmoid at
   LIBSVM's defaults (gamma = 1/d, coef0 = 0, degree 3) for a
   SMO_PREFIX_ITERS prefix of the general pair and a KIND_DECOMP_ROUNDS
   prefix of the decomposition through kernel B; and a precomputed K of
   PRE_N planted rows, built on the card, to convergence on both paths,
   each model held to the RBF model of the same path on the same rows.
   Counts are set to 0 before each run and read after it: the general
   pair launches neither kernel, replays its graph and reads once a chunk;
4. the kernel paths against the plain paths, both on the card: the pair
   for PREFIX_ITERS iterations at 60000 x 784 and converged on 4096 x 784;
   the decomposition for DECOMP_PREFIX_ROUNDS rounds at full width and
   converged on planted 8000 x 784 at q=4096 (``Smoke.convergence`` says
   why the bars split so); the general pair's first-order RBF path against
   kernel A for PREFIX_ITERS iterations;
5. shrinking at full width in float32 through ``api.fit``: WSS2 on the
   general pair and the decomposition (q = DECOMP_Q, kernel B on padded
   active sets), each to convergence with save/load/evaluate, held to its
   unshrunk model of phase 3 by the bar between paths; their active-set
   sizes, compactions, unshrinks and graph captures (at or under the
   distinct capacities); the f the last unshrink rebuilt against a fresh
   streamed pass; kernel B's counts, and no masked slot ever updated; then
   the shrinking decomposition's kernel path against its plain path on
   planted 8000 x 784 at q = 4096;
6. kill and resume on the three paths at full width (f32): 2K iterations
   straight against K with checkpoints resumed from the file to 2K, and
   again from the rotation slot after the newest file is truncated, all
   bitwise equal (alpha, f, b's, n_iter); kernel A's runs equal the
   resumed iterations; the seconds a checkpoint costs its poll;
7. libsvm input: the first LIBSVM_ROWS planted rows written as libsvm and
   as CSV load to the same arrays, and the fused pair trains on both to
   the same prefix, bitwise;
8. time each kernel on its path (kernel A: CUDA events over a chunk of
   TIMED_ITERS launches, its rate and share of its bound; kernel B and the
   other parts of a decomposition round over one round from a real carry,
   device times from torch.profiler; kernel B also at q in
   SUBSOLVE_TIMED_QS, a launch of DECOMP_CAP steps from alpha = 0, by CUDA
   events, with the cluster each used), the general pair's WSS2 iteration
   (CUDA events over a chunk of SMO_TIMED_ITERS iterations, the host's
   enqueue time, the device's busy share and top operations from
   torch.profiler), the plain versions and a PyTorch
   yardstick where one exists, and print the ``{"kernels": [...]}`` line,
   the card's name and power limit, and last ``{"ok": true, "device":
   {...}}``.

It imports nothing of JAX and nothing of the JAX package. Without a CUDA
device, or without the port beside it, it exits 2 and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
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
# The decomposition at the reference shape: q must exceed n_sv (~8.3k
# here) by ~1.3x (dpsvm_tpu/solver/decomp.py), and cap 128 is the inner
# cap the JAX package's scan found load-bearing.
DECOMP_Q, DECOMP_CAP = 12288, 128
DECOMP_MAX_ITER = 600_000
DECOMP_PREFIX_ROUNDS = 5
DECOMP_WARM_ROUNDS = 20          # rounds run before the timed one
SUBSOLVE_QS = (32, 1030, DECOMP_Q)
SUBSOLVE_TIMED_QS = (1024, 4096, DECOMP_Q, 16384)
# Pair updates to convergence of the JAX package's decomposition (q=4096,
# cap 128, float32, on the CPU) at planted 8000 x 784, C=10, gamma=0.25:
# docs/PERF.md, benchmarks/results/iteration_economy_r4.jsonl.
JAX_UPDATES_8000 = 13_035
KERNEL_A = "fused_iter_kernel"     # kernel A's name in torch.profiler
# The general pair (solver/smo.py).
GRAPH_CHECK_ITERS = 200          # graph against eager, bitwise
SMO_PREFIX_ITERS = 2000          # linear, poly, sigmoid on the pair
KIND_DECOMP_ROUNDS = 10          # ... and on the decomposition
SMO_TIMED_ITERS = 512
# Precomputed: planted rows whose RBF matrix (1.07 GB in float32) is built
# on the card; q for its decomposition above ~1.3x its SV count.
PRE_N, PRE_Q = 16384, 4096
# Kill and resume: K iterations, then resumed to 2K (pairs: about 2000, a
# multiple of their 512-iteration chunk; the decomposition: 10 rounds'
# worth, chunks of K/2 so that each run's polls fall on round ends).
RESUME_PAIR_K = 2048
RESUME_DECOMP_K = 10 * DECOMP_CAP
# libsvm input: the first LIBSVM_ROWS planted rows at full width. The
# port's parser is the JAX package's pure-Python one: ~2.5 us a token on
# the card's host, 148 s for all 60000 rows (PERF.md §4).
LIBSVM_ROWS = 10_000


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
        from dpsvm_tpu_torch.experimental import subsolve_kernel as sk
        sms = self.torch.cuda.get_device_properties(
            self.dev).multi_processor_count
        for q in (*SUBSOLVE_QS, *SUBSOLVE_TIMED_QS):
            log(f"[build] subsolve launch at q={q}: "
                f"{sk.launch_geometry(q, sms)._asdict()}")

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
        prologue_err = 0.0
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
                    ran = [ks[fs.S_RUN], ks[fs.S_NITER]]
                    if ran != [1, 1] or ps[fs.S_NITER] != 1:
                        self.fail("kernel", f"{tag}: one body ran "
                                  f"(runs, n_iter) = {ran}")
                    # the prologue inside the kernel: rows, scalars, the
                    # alpha pair
                    perr = max(float((k.alpha - p.alpha).abs().max()),
                               float((ws.scalars - sc_p).abs().max()))
                    ptol = F_RTOL * max(1.0, float(sc_p.abs().max()))
                    prologue_err = max(prologue_err, perr)
                    rows_eq = torch.equal(ws.rows, rows_p)
                    if not rows_eq or not perr <= ptol:
                        self.fail("kernel", f"{tag}: prologue err {perr:.3g}"
                                  f" (tol {ptol:.3g}) rows equal {rows_eq}")
                    # the pass and the finalize: f, [i_hi, i_lo], [b_hi, b_lo]
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
        self.rec["prologue_err"] = prologue_err
        self.rec["near_ties"] = near_ties
        self.check_subsolve()
        self.check_subsolve_kinds()
        self.check_general_pair()

    def subsolve_inputs(self, q: int, seed: int, weighted=False, masked=0,
                        mid=False):
        """(K_WW, y, c, alpha, f, active) for a block of q planted rows:
        K_WW in exact float32, boxes C (or 2C / C/2 by class), the last
        ``masked`` slots inactive; alpha 0 and f = -y, or with ``mid`` a
        mid-run state with alpha at 0, at C and inside and f off -y."""
        torch = self.torch
        from dpsvm_tpu_torch.ops.kernels import (host_row_norms_sq,
                                                 rows_from_dots)
        xtr, ytr, _, _ = self.planted()
        rng = np.random.default_rng(seed)
        idx = np.sort(rng.choice(N, q, replace=False))
        rows = torch.from_numpy(xtr[idx]).to(self.dev)
        x2 = torch.from_numpy(host_row_norms_sq(xtr[idx])).to(self.dev)
        k = rows_from_dots(rows @ rows.T, x2, x2, GAMMA).contiguous()
        y = torch.from_numpy(ytr[idx].astype(np.float32)).to(self.dev)
        c = (torch.where(y > 0, 2.0 * C, C / 2.0) if weighted
             else torch.full((q,), C, device=self.dev))
        active = torch.arange(q, device=self.dev) < q - masked
        a = torch.zeros(q, device=self.dev)
        f = -y
        if mid:
            pick = torch.from_numpy(rng.integers(0, 3, q)).to(self.dev)
            inner = torch.from_numpy(rng.uniform(0.05, 0.95, q).astype(
                np.float32)).to(self.dev)
            a = torch.where(pick == 0, 0.0, torch.where(pick == 1, c,
                                                        inner * c))
            f = f + torch.from_numpy(rng.normal(0, 0.3, q).astype(
                np.float32)).to(self.dev)
        return k, y, c, a.contiguous(), f.contiguous(), active

    def subsolve_case(self, tag: str, inp, step_cap: int, max_cap: int,
                      pairwise: bool, cluster=None):
        """One launch through ``launch_inner_subsolve`` against the plain
        version on the same inputs: the same values, and NaN at the same
        places. Returns (t, max |difference| of the finite values, the
        kernel's outputs)."""
        torch = self.torch
        from dpsvm_tpu_torch.experimental import subsolve_kernel as sk
        runs = torch.zeros(2, dtype=torch.int32, device=self.dev)
        got = sk.launch_inner_subsolve(*inp, 1e-3, step_cap, max_cap=max_cap,
                                       pairwise=pairwise, runs=runs,
                                       cluster=cluster)
        ref = sk.inner_subsolve_plain(*inp, 1e-3, step_cap, max_cap=max_cap,
                                      pairwise=pairwise)
        torch.cuda.synchronize()
        t = int(got[4])
        err = max(float((u - v).nan_to_num().abs().max())
                  for u, v in zip(got[:4], ref[:4]))
        bitwise = all(u.dtype == v.dtype
                      and torch.equal(u.isnan(), v.isnan())
                      and torch.equal(u.nan_to_num(), v.nan_to_num())
                      for u, v in zip(got, ref))
        if not bitwise or t != int(ref[4]) or runs.tolist() != [1, t]:
            self.fail("kernel", f"subsolve {tag}: bitwise {bitwise}, t "
                      f"{t} vs plain {int(ref[4])}, max |diff| {err:.3g}, "
                      f"device runs/steps {runs.tolist()}")
        return t, err, got

    def check_subsolve(self) -> None:
        torch = self.torch
        from dpsvm_tpu_torch.experimental import subsolve_kernel as sk
        from dpsvm_tpu_torch.ops.selection import masked_scores_and_masks
        err, lines = 0.0, []
        for q in SUBSOLVE_QS:
            specs = [(f"cap {cap} {'pairwise' if pw else 'indep'}", cap, pw,
                      {}, cap)
                     for cap in (1, 37, DECOMP_CAP) for pw in (False, True)]
            specs += [(f"weighted masked {'pairwise' if pw else 'indep'}",
                       DECOMP_CAP, pw, dict(weighted=True, masked=8),
                       DECOMP_CAP) for pw in (False, True)]
            specs += [(f"mid-run {'pairwise' if pw else 'indep'}", DECOMP_CAP,
                       pw, dict(mid=True), DECOMP_CAP) for pw in (False, True)]
            specs += [("step_cap 7 < max_cap", DECOMP_CAP, False, {}, 7)]
            ts = []
            for i, (tag, cap, pw, kw, step_cap) in enumerate(specs):
                t, e, _ = self.subsolve_case(
                    f"q={q} {tag}", self.subsolve_inputs(q, q + i, **kw),
                    step_cap, cap, pw)
                ts.append(t)
                err = max(err, e)
            if ts[-1] != 7:
                self.fail("kernel", f"subsolve q={q}: the dynamic cap ran "
                          f"{ts[-1]} steps, not 7")
            # An already-optimal block: a mid-run state whose f closes the
            # gap (0 on slots in both index sets, +1 on I_up only, -1 on
            # I_low only), so b_lo <= b_hi at entry.
            k, y, c, a, f, act = self.subsolve_inputs(q, q + 99, mid=True)
            _, _, in_up, in_low = masked_scores_and_masks(a, y, f, c,
                                                          valid=act)
            f = torch.where(in_up & in_low, 0.0,
                            torch.where(in_up, 1.0, -1.0)).contiguous()
            got = sk.launch_inner_subsolve(k, y, c, a, f, act, 1e-3, 100,
                                           max_cap=100, pairwise=False)
            t, e, _ = self.subsolve_case(f"q={q} optimal block",
                                         (k, y, c, a, f, act), 100, 100,
                                         False)
            err = max(err, e)
            if t != 0 or not (torch.equal(got[0], a)
                              and torch.equal(got[1], f)):
                self.fail("kernel", f"subsolve q={q}: an optimal block took "
                          f"{t} steps or changed its state")
            lines.append(f"q={q}: t {ts}, then {t} on the optimal block")
        err = max(err, self.check_subsolve_edges(lines))
        for ln in lines:
            log(f"[kernel] subsolve {ln}")
        self.rec["max_abs_err"]["inner_subsolve"] = err

    def check_subsolve_edges(self, lines) -> float:
        """Kernel B where the cluster split could go wrong, at full width.
        Returns the largest |difference| of the finite values."""
        torch = self.torch
        from dpsvm_tpu_torch.experimental import subsolve_kernel as sk
        err = 0.0
        cases = [
            (f"q={sk.MAX_Q} (MAX_Q) {c}", sk.MAX_Q, None, dict(mid=True), pw)
            for c, pw in (("indep", False), ("pairwise", True))]
        cases += [(f"q=12290 short last block {c}", 12290, None,
                   dict(weighted=True, masked=8), pw)
                  for c, pw in (("indep", False), ("pairwise", True))]
        cases += [(f"q={q} in a forced cluster of 16", q, 16, {}, False)
                  for q in (4, 33)]
        for i, (tag, q, cl, kw, pw) in enumerate(cases):
            t, e, _ = self.subsolve_case(
                tag, self.subsolve_inputs(q, 7 + i, **kw), DECOMP_CAP,
                DECOMP_CAP, pw, cl)
            err = max(err, e)
            lines.append(f"{tag}: t {t}")
        q = DECOMP_Q
        g = sk.launch_geometry(q, 132)
        # Ties: two I_up slots with equal f, two I_low slots with equal f
        # and equal K rows and columns, each pair in two blocks.
        k, y, c, a, f, act = self.subsolve_inputs(q, 71)
        up, low = (100, q - 3 * g.slots // 2), (200, q - 7)
        for src, dst in (up, low):
            k[dst, :] = k[src, :]
            k[:, dst] = k[:, src]
        y[list(up)], y[list(low)] = 1.0, -1.0
        f = (-y).contiguous()
        f[list(up)], f[list(low)] = -5.0, 500.0
        act = torch.ones(q, dtype=torch.bool, device=self.dev)
        inp = (k, y, c, a, f, act)
        t1, e, got = self.subsolve_case(f"q={q} ties across blocks, one step",
                                        inp, 1, 1, False)
        moved = torch.nonzero(got[0]).flatten().tolist()
        t, e2, _ = self.subsolve_case(f"q={q} ties across blocks", inp,
                                      DECOMP_CAP, DECOMP_CAP, True)
        err = max(err, e, e2)
        if moved != [up[0], low[0]]:
            self.fail("kernel", f"subsolve q={q}: the tied first step moved "
                      f"{moved}, not the first indices {[up[0], low[0]]}")
        lines.append(f"q={q} ties across blocks {g.slots}-slot blocks: "
                     f"moved {moved}, then t {t}")
        del k
        # i_hi == i_lo: K = I, two active slots in the first and the last
        # block; the first step equalises their f at 0, the second finds
        # every objective at -1 and takes slot 0 for both.
        k = torch.eye(q, device=self.dev)
        y = torch.ones(q, device=self.dev)
        y[q - 1] = -1.0
        c = torch.full((q,), C, device=self.dev)
        act = torch.zeros(q, dtype=torch.bool, device=self.dev)
        act[[0, q - 1]] = True
        t, e, got = self.subsolve_case(
            f"q={q} i_hi == i_lo", (k, y, c, torch.zeros(q, device=self.dev),
                                    (-y).contiguous(), act), 100, 100, False)
        err = max(err, e)
        if t != 2 or got[0][0] != 1.0 or got[0][q - 1] != 1.0:
            self.fail("kernel", f"subsolve q={q}: i_hi == i_lo took {t} "
                      f"steps, alpha {got[0][[0, q - 1]].tolist()}")
        lines.append(f"q={q} i_hi == i_lo: t {t}")
        del k
        # NaN in f: at an I_up slot of the last block (b_hi NaN, no step),
        # and at a masked slot (the steps run around it).
        k, y, c, a, f0, act = self.subsolve_inputs(q, 73, masked=4)
        j = int(torch.nonzero(y[:q - 4] > 0).flatten()[-1])
        for where, slot, stops in (("I_up", j, True), ("masked", q - 2, False)):
            f = f0.clone()
            f[slot] = float("nan")
            t, e, got = self.subsolve_case(f"q={q} NaN in f at {where}",
                                           (k, y, c, a, f, act), DECOMP_CAP,
                                           DECOMP_CAP, False)
            err = max(err, e)
            if (t == 0) != stops or bool(torch.isnan(got[2])) != stops:
                self.fail("kernel", f"subsolve q={q}: NaN at {where}: t {t},"
                          f" b_hi {float(got[2])}")
            lines.append(f"q={q} NaN in f at {where}: t {t}, b's "
                         f"{float(got[2])}, {float(got[3])}")
        return err


    def kernel_matrix(self):
        """(K, y, K_test, y_test, x, x_test): the RBF matrix (gamma GAMMA)
        of the first PRE_N planted rows, built on the card in float32, and
        K(test, train) of the 10000 held-out rows, as numpy (the entry
        points take numpy); the rows themselves beside them."""
        if getattr(self, "_kmat", None) is None:
            torch = self.torch
            from dpsvm_tpu_torch.ops.kernels import (exact_f32, row_norms_sq,
                                                     rows_from_dots)
            xtr, ytr, xte, yte = self.planted()
            a = torch.from_numpy(xtr[:PRE_N]).to(self.dev)
            t = torch.from_numpy(xte).to(self.dev)
            a2, t2 = row_norms_sq(a), row_norms_sq(t)
            with exact_f32():
                k = rows_from_dots(a @ a.T, a2, a2, GAMMA).cpu().numpy()
                kte = rows_from_dots(t @ a.T, t2, a2, GAMMA).cpu().numpy()
            self._kmat = (k, ytr[:PRE_N], kte, yte, xtr[:PRE_N], xte)
        return self._kmat

    def kind_config(self, kind: str, **kw):
        """LIBSVM's defaults for the kind (gamma = 1/d, coef0 = 0, degree
        3) at C, as the kinds' phases run them."""
        from dpsvm_tpu_torch import SVMConfig
        return SVMConfig(c=C, kernel=kind, epsilon=1e-3, **kw)

    def check_subsolve_kinds(self) -> None:
        """Kernel B on the K_WW of each other kind: the first decomposition
        round at q = DECOMP_Q through ``decomp_step``, its subsolve inputs
        held kernel against plain, bitwise."""
        from dpsvm_tpu_torch.experimental import subsolve_kernel as sk
        from dpsvm_tpu_torch.solver import decomp as sd
        xtr, ytr, _, _ = self.planted()
        lines = []
        for kind in ("linear", "poly", "sigmoid", "precomputed"):
            x, y = (self.kernel_matrix()[:2] if kind == "precomputed"
                    else (xtr, ytr))
            cfg = self.kind_config(kind, working_set=DECOMP_Q,
                                   inner_iters=DECOMP_CAP)
            prob = sd.DecompProblem.build(x, y, cfg, self.dev)
            seen = []

            def capture(*args, **kw):
                seen[:] = [args, kw]
                return sk.launch_inner_subsolve(*args, **kw)

            sd.decomp_step(sd.init_carry(prob.y), prob, q=DECOMP_Q,
                           inner_cap=DECOMP_CAP, epsilon=1e-3,
                           step_cap=DECOMP_CAP, subsolve=capture)
            args, kw = seen
            t, e, _ = self.subsolve_case(f"{kind} first round", args[:6],
                                         args[7], kw["max_cap"],
                                         kw["pairwise"])
            self.rec["max_abs_err"]["inner_subsolve"] = max(
                self.rec["max_abs_err"]["inner_subsolve"], e)
            lines.append(f"{kind}: t {t}")
            del prob, seen, args
        log(f"[kernel] subsolve per kind, bitwise: {'; '.join(lines)}")

    def check_general_pair(self) -> None:
        """The general pair's captured chunk against its eager loop (the
        same ``smo_step``), bitwise, on the card at full width."""
        from dpsvm_tpu_torch.solver import smo as gs
        xtr, ytr, _, _ = self.planted()
        k, yk = self.kernel_matrix()[:2]
        cases = [("rbf second-order f32", xtr, ytr, dict(
                      kind="rbf", gamma=GAMMA, selection="second-order")),
                 ("rbf second-order bf16", xtr, ytr, dict(
                     kind="rbf", gamma=GAMMA, selection="second-order",
                     matmul_precision="default")),
                 ("rbf first-order f32", xtr, ytr, dict(kind="rbf",
                                                        gamma=GAMMA))]
        cases += [(f"{kind} second-order f32", xtr, ytr, dict(
            kind=kind, selection="second-order"))
                  for kind in ("linear", "poly", "sigmoid")]
        cases += [("precomputed second-order", k, yk, dict(
            kind="precomputed", selection="second-order"))]
        out = {}
        for tag, x, y, kw in cases:
            cfg = self.kind_config(kw.pop("kind"), max_iter=GRAPH_CHECK_ITERS,
                                   chunk_iters=64, **kw)
            gs.reset_counts()
            g = gs.train_single_device(x, y, cfg, self.dev)
            counts = dict(gs.COUNTS)
            e = gs.train_single_device(x, y, cfg, self.dev, plain=True)
            same = (g.n_iter == e.n_iter == GRAPH_CHECK_ITERS
                    and np.array_equal(g.alpha, e.alpha)
                    and (g.b_hi, g.b_lo) == (e.b_hi, e.b_lo))
            out[tag] = {"bitwise": bool(same), "n_iter": g.n_iter,
                        "max_alpha_diff": float(np.abs(g.alpha
                                                       - e.alpha).max()),
                        **counts}
            if not same or counts["captures"] != 1:
                self.fail("kernel", f"general pair {tag}: graph against "
                          f"eager {out[tag]}")
        self.rec["graph_vs_eager"] = out
        log(f"[kernel] general pair, graph against eager: {json.dumps(out)}")

    # ------------------------------------------------------------ phase 3
    def main_path(self) -> None:
        torch = self.torch
        from dpsvm_tpu_torch import SVMConfig, fit
        from dpsvm_tpu_torch.experimental import fused_step as fs
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
            same, finite, acc, io_s, eval_s = self._round_trip(model, xte,
                                                               yte)
            ok = (same and res.converged and finite and acc > 0.9
                  and np.all(np.isfinite(res.alpha)))
            if not ok:
                self.fail("main", f"{prec}: model round trip {same}, "
                          f"converged {res.converged}, finite {finite}, "
                          f"acc {acc}")
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
        self.main_decomp()
        self.main_general()
        self.main_kinds()
        self.main_precomputed()

    def counted(self, fn):
        """Run ``fn()`` with every count at 0 before it; return its result
        and the counts after it: kernel A's and B's launches and runs, B's
        steps, and the general pair's captures, replays and reads."""
        from dpsvm_tpu_torch.experimental import fused_step as fs
        from dpsvm_tpu_torch.experimental import subsolve_kernel as sk
        from dpsvm_tpu_torch.solver import smo as gs
        fs.reset_counts()
        sk.reset_counts()
        gs.reset_counts()
        out = fn()
        name = "inner_subsolve"
        return out, {"A_launches": fs.LAUNCHES["fused_update_select"],
                     "A_runs": fs.RUNS["fused_update_select"],
                     "B_launches": sk.LAUNCHES[name],
                     "B_runs": sk.RUNS[name], "B_steps": sk.STEPS[name],
                     **{f"pair_{k}": v for k, v in gs.COUNTS.items()}}

    def _pair_counts_ok(self, res, counts) -> bool:
        """The general pair launched neither kernel, captured one graph,
        read once a chunk, and enqueued enough bodies for its iterations."""
        from dpsvm_tpu_torch.solver import smo as gs
        return (counts["A_launches"] == counts["B_launches"] == 0
                and counts["pair_captures"] == 1
                and counts["pair_reads"] >= 1
                and counts["pair_replays"] * gs.GRAPH_BODIES >= res.n_iter)

    def main_general(self) -> None:
        """WSS2 on the general pair at full width through ``api.fit``,
        held to the fused pair's model by the bar between paths."""
        torch = self.torch
        from dpsvm_tpu_torch import fit
        from dpsvm_tpu_torch.solver import smo as gs
        xtr, ytr, xte, yte = self.planted()
        self.rec["general"] = {}
        for prec in ("highest", "default"):
            cfg = self.kind_config("rbf", gamma=GAMMA, max_iter=MAIN_MAX_ITER,
                                   selection="second-order",
                                   matmul_precision=prec)
            torch.cuda.reset_peak_memory_stats()
            (model, res), counts = self.counted(lambda: fit(xtr, ytr, cfg))
            peak = torch.cuda.max_memory_allocated()
            same, finite, acc, io_s, eval_s = self._round_trip(model, xte,
                                                               yte)
            pair = self.rec["main"][prec]
            bodies = counts["pair_replays"] * gs.GRAPH_BODIES
            r = {"n_iter": res.n_iter, "converged": res.converged,
                 "gap": res.gap, "n_sv": res.n_sv, "b": res.b,
                 "train_seconds": res.train_seconds,
                 "us_per_iteration": 1e6 * res.train_seconds / res.n_iter,
                 **counts, "bodies_enqueued": bodies,
                 "bodies_after_the_end": bodies - res.n_iter,
                 "peak_bytes": int(peak), "save_load_seconds": io_s,
                 "eval_seconds": eval_s, "heldout_accuracy": acc,
                 "fused_n_sv": pair["n_sv"],
                 "fused_heldout_accuracy": pair["heldout_accuracy"],
                 "fused_train_seconds": pair["train_seconds"]}
            ok = (same and finite and res.converged and acc > 0.9
                  and np.all(np.isfinite(res.alpha))
                  and self._pair_counts_ok(res, counts)
                  and abs(res.n_sv - pair["n_sv"]) <= 0.02 * pair["n_sv"]
                  and abs(acc - pair["heldout_accuracy"]) <= 0.005)
            if not ok:
                self.fail("main", f"general pair WSS2 {prec}: round trip "
                          f"{same}, finite {finite}: {json.dumps(r)}")
            self.rec["general"][prec] = r
            log(f"[main] general pair WSS2 {prec}: {json.dumps(r)}")

    def main_kinds(self) -> None:
        """Linear, poly and sigmoid at LIBSVM's defaults: a prefix of the
        general pair and a prefix of the decomposition (kernel B) at full
        width through ``api.train``."""
        from dpsvm_tpu_torch import train
        xtr, ytr, _, _ = self.planted()
        self.rec["kinds"] = {}
        for kind in ("linear", "poly", "sigmoid"):
            r = {}
            cfg = self.kind_config(kind, selection="second-order",
                                   max_iter=SMO_PREFIX_ITERS)
            res, counts = self.counted(lambda: train(xtr, ytr, cfg))
            r["pair"] = {"n_iter": res.n_iter, "gap": res.gap,
                         "n_sv": res.n_sv,
                         "train_seconds": res.train_seconds,
                         "us_per_iteration": 1e6 * res.train_seconds
                         / max(res.n_iter, 1), **counts}
            if not (res.n_iter == SMO_PREFIX_ITERS or res.converged) or not (
                    np.all(np.isfinite(res.alpha)) and np.isfinite(res.b)
                    and self._pair_counts_ok(res, counts)):
                self.fail("main", f"{kind} general pair: {r['pair']}")
            cfg = self.kind_config(kind, working_set=DECOMP_Q,
                                   inner_iters=DECOMP_CAP,
                                   max_iter=KIND_DECOMP_ROUNDS * DECOMP_CAP)
            res, counts = self.counted(lambda: train(xtr, ytr, cfg))
            r["decomposition"] = {"n_iter": res.n_iter, "rounds": res.rounds,
                                  "gap": res.gap, "n_sv": res.n_sv,
                                  "train_seconds": res.train_seconds,
                                  **counts}
            self._add_b_counts(counts)
            if not (counts["B_launches"] == counts["B_runs"] == res.rounds > 0
                    and counts["B_steps"] == res.n_iter
                    and np.all(np.isfinite(res.alpha))
                    and np.isfinite(res.b)):
                self.fail("main", f"{kind} decomposition: "
                          f"{r['decomposition']}")
            self.rec["kinds"][kind] = r
            log(f"[main] {kind}: {json.dumps(r)}")

    def _add_b_counts(self, counts) -> None:
        tot = self.rec["decomp_counts"]
        tot["launches"] += counts["B_launches"]
        tot["runs"] += counts["B_runs"]

    def main_precomputed(self) -> None:
        """A precomputed K (PRE_N planted rows, built on the card) to
        convergence on the general pair (WSS2) and on the decomposition,
        each held to the RBF model of the same path on the same rows (n_sv
        within 2%, held-out accuracy within 0.5%)."""
        from dpsvm_tpu_torch import evaluate, fit
        from dpsvm_tpu_torch.models.svm import decision_function
        k, y, kte, yte, x, xte = self.kernel_matrix()
        self.rec["precomputed"] = {}
        for path, kw in (("pair", dict(selection="second-order",
                                       max_iter=MAIN_MAX_ITER)),
                         ("decomposition", dict(working_set=PRE_Q,
                                                inner_iters=DECOMP_CAP,
                                                max_iter=DECOMP_MAX_ITER))):
            cfg = self.kind_config("precomputed", **kw)
            (model, res), counts = self.counted(lambda: fit(k, y, cfg))
            same, finite, acc, io_s, eval_s = self._round_trip(model, kte,
                                                               yte)
            rcfg = self.kind_config("rbf", gamma=GAMMA, **kw)
            (rmodel, rres), _ = self.counted(lambda: fit(x, y, rcfg))
            racc = evaluate(rmodel, xte, yte)
            dmax = float(np.abs(decision_function(model, kte)
                                - decision_function(rmodel, xte)).max())
            r = {"n": PRE_N, "n_iter": res.n_iter, "rounds": res.rounds,
                 "converged": res.converged, "n_sv": res.n_sv, "b": res.b,
                 "train_seconds": res.train_seconds, **counts,
                 "heldout_accuracy": acc, "save_load_seconds": io_s,
                 "rbf": {"n_iter": rres.n_iter, "n_sv": rres.n_sv,
                         "converged": rres.converged,
                         "train_seconds": rres.train_seconds,
                         "heldout_accuracy": racc},
                 "max_decision_diff": dmax}
            if path == "pair":
                counts_ok = self._pair_counts_ok(res, counts)
            else:
                self._add_b_counts(counts)
                counts_ok = (counts["B_launches"] == counts["B_runs"]
                             == res.rounds > 0
                             and counts["B_steps"] == res.n_iter)
            ok = (same and finite and res.converged and rres.converged
                  and counts_ok and acc > 0.9
                  and abs(res.n_sv - rres.n_sv) <= 0.02 * rres.n_sv
                  and abs(acc - racc) <= 0.005)
            if not ok:
                self.fail("main", f"precomputed {path}: round trip {same}, "
                          f"finite {finite}: {json.dumps(r)}")
            self.rec["precomputed"][path] = r
            log(f"[main] precomputed {path}: {json.dumps(r)}")

    def _round_trip(self, model, xte, yte):
        """save, load, evaluate on the held-out rows. Returns (same model,
        finite decisions of the right shape, accuracy, save+load s, eval
        s)."""
        from dpsvm_tpu_torch import evaluate, load_model, save_model
        from dpsvm_tpu_torch.models.svm import decision_function
        t = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "model.svm")
            wrote = save_model(model, path)
            loaded = load_model(path)
        io_s = time.perf_counter() - t
        same = (wrote == model.n_sv
                and (model.sv_idx is None
                     or np.array_equal(loaded.sv_idx, model.sv_idx))
                and np.array_equal(loaded.x_sv, model.x_sv)
                and np.array_equal(loaded.alpha, model.alpha)
                and np.array_equal(loaded.y_sv, model.y_sv))
        t = time.perf_counter()
        dec = decision_function(loaded, xte)
        eval_s = time.perf_counter() - t
        finite = bool(np.all(np.isfinite(dec)) and dec.shape == (len(yte),))
        return same, finite, evaluate(loaded, xte, yte), io_s, eval_s

    def main_decomp(self) -> None:
        """The decomposition at full width through ``api.fit``."""
        torch = self.torch
        from dpsvm_tpu_torch import SVMConfig, fit
        from dpsvm_tpu_torch.experimental import subsolve_kernel as sk
        from dpsvm_tpu_torch.solver import decomp as sd
        xtr, ytr, xte, yte = self.planted()
        self.rec["decomp"] = {}
        totals = {"launches": 0, "runs": 0}
        for prec in ("highest", "default"):
            cfg = SVMConfig(c=C, gamma=GAMMA, epsilon=1e-3,
                            max_iter=DECOMP_MAX_ITER, working_set=DECOMP_Q,
                            inner_iters=DECOMP_CAP, matmul_precision=prec)
            torch.cuda.reset_peak_memory_stats()
            sk.reset_counts()
            reads0 = sd.READS["stats"]
            model, res = fit(xtr, ytr, cfg)
            name = "inner_subsolve"
            got = {"launches": sk.LAUNCHES[name], "runs": sk.RUNS[name],
                   "steps": sk.STEPS[name]}
            reads = sd.READS["stats"] - reads0
            peak = torch.cuda.max_memory_allocated()
            for k in totals:
                totals[k] += got[k]
            same, finite, acc, io_s, eval_s = self._round_trip(model, xte,
                                                               yte)
            pair = self.rec["main"][prec]
            ok = (same and finite and res.converged and acc > 0.9
                  and np.all(np.isfinite(res.alpha))
                  and got["launches"] == got["runs"] == res.rounds > 0
                  and got["steps"] == res.n_iter
                  and abs(res.n_sv - pair["n_sv"]) <= 0.02 * pair["n_sv"]
                  and abs(acc - pair["heldout_accuracy"]) <= 0.005)
            r = {"n_iter": res.n_iter, "rounds": res.rounds,
                 "converged": res.converged, "gap": res.gap,
                 "n_sv": res.n_sv, "b": res.b,
                 "train_seconds": res.train_seconds,
                 "updates_per_s": res.n_iter / res.train_seconds,
                 "ms_per_round": 1e3 * res.train_seconds / res.rounds,
                 **got, "stats_reads": reads,
                 "reads_per_round": reads / res.rounds,
                 "peak_bytes": int(peak), "save_load_seconds": io_s,
                 "eval_seconds": eval_s, "heldout_accuracy": acc,
                 "pair_n_sv": pair["n_sv"],
                 "pair_heldout_accuracy": pair["heldout_accuracy"]}
            if not ok:
                self.fail("main", f"decomposition {prec}: round trip "
                          f"{same}, finite {finite}: {json.dumps(r)}")
            self.rec["decomp"][prec] = r
            log(f"[main] decomposition {prec}: {json.dumps(r)}")
        self.rec["decomp_counts"] = totals

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
        self.convergence_decomp()
        self.convergence_general()

    def convergence_general(self) -> None:
        """The general pair's first-order RBF path (its captured graph)
        against kernel A's fused path, both through their entry points, for
        PREFIX_ITERS iterations at 60000 x 784: the same working sets, so
        the float32 bars of the prefix above (decision values within
        5e-3), on sum(alpha y K) without b: a capped run's b's differ
        between the two by design (the fused carry holds the next
        iteration's selection, the general pair's the last body's)."""
        from dpsvm_tpu_torch import fit
        from dpsvm_tpu_torch.models.svm import SVMModel, decision_function
        from dpsvm_tpu_torch.solver import smo as gs
        xtr, ytr, xte, _ = self.planted()
        self.rec["convergence_general"] = {}
        for prec in ("highest", "default"):
            cfg = self.kind_config("rbf", gamma=GAMMA, max_iter=PREFIX_ITERS,
                                   matmul_precision=prec)
            mk, rk = fit(xtr, ytr, cfg)                      # kernel A
            rg = gs.train_single_device(xtr, ytr, cfg, self.dev)
            mg = SVMModel.from_train_result(xtr, ytr, rg)
            dmax = float(np.abs(
                decision_function(mk, xte, include_b=False)
                - decision_function(mg, xte, include_b=False)).max())
            r = {"n_iter": [rk.n_iter, rg.n_iter], "n_sv": [rk.n_sv, rg.n_sv],
                 "max_alpha_diff": float(np.abs(rk.alpha - rg.alpha).max()),
                 "max_decision_diff": dmax}
            if not (rk.n_iter == rg.n_iter == PREFIX_ITERS
                    and rk.n_sv == rg.n_sv and dmax <= 5e-3
                    and np.allclose(rk.alpha, rg.alpha, rtol=1e-4,
                                    atol=1e-5)):
                self.fail("convergence", f"general pair against kernel A "
                          f"{prec}: {r}")
            self.rec["convergence_general"][prec] = r
            log(f"[convergence] general pair against kernel A {prec}: "
                f"{json.dumps(r)}")

    def convergence_decomp(self) -> None:
        """The decomposition's kernel path (``fit``) against its plain path
        (``train_single_device_decomp(plain=True)``: the same rounds with
        ``inner_subsolve_plain``), both on the card. The subsolve is
        bitwise to its plain version (phase 2) and the rest of a round is
        the same PyTorch code, so the prefix is held to the float32 bars.
        Converged, on planted 8000 x 784 (the JAX package's scan data, in
        float32 as that scan ran), the two are held to the LibSVM bar on the
        training rows, as the pair's converged runs are."""
        from dpsvm_tpu_torch import SVMConfig, fit
        from dpsvm_tpu_torch.data.synthetic import make_planted
        from dpsvm_tpu_torch.models.svm import (SVMModel, decision_function,
                                                evaluate)
        from dpsvm_tpu_torch.solver.decomp import train_single_device_decomp
        xtr, ytr, xte, yte = self.planted()
        x8, y8 = make_planted(8000, D, GAMMA, seed=0)
        self.rec["convergence_decomp"] = {}
        for prec in ("highest", "default"):
            r = {}
            for what, (xa, ya, xb, yb), q, max_iter in (
                    ("prefix", (xtr, ytr, xte, yte), DECOMP_Q,
                     DECOMP_PREFIX_ROUNDS * DECOMP_CAP),
                    ("converged", (x8, y8, x8, y8), 4096, 200_000)
                    )[:2 if prec == "highest" else 1]:
                cfg = SVMConfig(c=C, gamma=GAMMA, epsilon=1e-3,
                                max_iter=max_iter, working_set=q,
                                inner_iters=DECOMP_CAP,
                                matmul_precision=prec)
                mk, rk = fit(xa, ya, cfg)
                rp = train_single_device_decomp(xa, ya, cfg, self.dev,
                                                plain=True)
                mp = SVMModel.from_train_result(xa, ya, rp)
                dmax = float(np.abs(decision_function(mk, xb)
                                    - decision_function(mp, xb)).max())
                acc_k, acc_p = evaluate(mk, xb, yb), evaluate(mp, xb, yb)
                r[what] = {
                    "n": len(ya), "q": q,
                    "kernel": {"n_iter": rk.n_iter, "rounds": rk.rounds,
                               "n_sv": rk.n_sv, "converged": rk.converged,
                               "b": rk.b, "seconds": rk.train_seconds,
                               "accuracy": acc_k},
                    "plain": {"n_iter": rp.n_iter, "rounds": rp.rounds,
                              "n_sv": rp.n_sv, "converged": rp.converged,
                              "b": rp.b, "seconds": rp.train_seconds,
                              "accuracy": acc_p},
                    "max_alpha_diff": float(np.abs(rk.alpha
                                                   - rp.alpha).max()),
                    "max_decision_diff": dmax}
                if what == "prefix":
                    ok = ((rk.n_iter, rk.rounds) == (rp.n_iter, rp.rounds)
                          and rk.rounds == DECOMP_PREFIX_ROUNDS
                          and dmax <= 5e-3
                          and np.allclose(rk.alpha, rp.alpha, rtol=1e-4,
                                          atol=1e-5))
                else:
                    r[what]["jax_cpu_updates"] = JAX_UPDATES_8000
                    ok = (rk.converged and rp.converged
                          and abs(rk.n_sv - rp.n_sv)
                          <= max(0.02 * rp.n_sv, 3.0)
                          and abs(acc_k - acc_p) <= 1.0 / len(yb) + 1e-9)
                if not ok:
                    self.fail("convergence", f"decomposition {prec} {what}: "
                              f"{r[what]}")
            self.rec["convergence_decomp"][prec] = r
            log(f"[convergence] decomposition {prec}: {json.dumps(r)}")

    # ------------------------------------------------------------ phase 5
    def shrinking(self) -> None:
        """Shrinking (``solver/shrink.py``) at full width through
        ``api.fit``, in float32: on the general pair with WSS2 (LIBSVM's
        own default, -h 1) and on the decomposition through kernel B, each
        held to its unshrunk model of phase 3 by the bar between paths;
        then the decomposition's kernel path against its plain path with
        shrinking on planted 8000 x 784."""
        self.shrink_general()
        self.shrink_decomp()
        self.shrink_convergence()

    def _shrink_record(self, res, run, counts, acc, unshrunk):
        return {"n_iter": res.n_iter, "rounds": res.rounds,
                "converged": res.converged, "gap": res.gap,
                "n_sv": res.n_sv, "b": res.b,
                "train_seconds": res.train_seconds,
                "heldout_accuracy": acc,
                "active_sizes": run["active_sizes"],
                "active_since": run["active_since"],
                "capacities": run["capacities"],
                "compactions": run["compactions"],
                "unshrinks": run["unshrinks"], "captures": run["captures"],
                "pulls": run["pulls"], "host_seconds": run["seconds"],
                **counts,
                "unshrunk": {k: unshrunk[k] for k in (
                    "n_iter", "n_sv", "train_seconds", "heldout_accuracy")}}

    def _path_bar(self, res, acc, unshrunk) -> bool:
        return (abs(res.n_sv - unshrunk["n_sv"]) <= 0.02 * unshrunk["n_sv"]
                and abs(acc - unshrunk["heldout_accuracy"]) <= 0.005)

    def shrink_general(self) -> None:
        """WSS2 with shrinking to convergence, save, load and evaluate;
        the captures at or under the distinct capacities; the inactive f
        the last unshrink rebuilt against a fresh streamed pass."""
        from dpsvm_tpu_torch import fit
        from dpsvm_tpu_torch.ops.diagnostics import _stream_kv
        from dpsvm_tpu_torch.solver import shrink
        xtr, ytr, xte, yte = self.planted()
        cfg = self.kind_config("rbf", gamma=GAMMA, max_iter=MAIN_MAX_ITER,
                               selection="second-order", shrinking=True)
        (model, res), counts = self.counted(lambda: fit(xtr, ytr, cfg))
        run = dict(shrink.RUN)
        same, finite, acc, _, _ = self._round_trip(model, xte, yte)
        r = self._shrink_record(res, run, counts, acc,
                                self.rec["general"]["highest"])
        f_ok = run["rebuilt"] is not None
        if f_ok:
            # The rebuilt f (sums over the SVs, in blocks of 8192 rows)
            # against a fresh _stream_kv over all rows: two float32 sums of
            # ~8k products in different orders, so F_RTOL is taken relative
            # to the size of what is summed, sum_j |alpha_j y_j K_ij|
            # (F_RTOL's own sums have 784 terms of size ~|f|).
            idx, f_rebuilt, alpha = run["rebuilt"]
            coef = alpha * ytr.astype(np.float32)
            spec = cfg.kernel_spec(D)
            fresh = (_stream_kv(xtr, coef, spec, 4096, self.dev)[idx]
                     - ytr[idx])
            size = _stream_kv(xtr, np.abs(coef), spec, 4096, self.dev)[idx]
            err = np.abs(f_rebuilt - fresh)
            r["rebuilt_rows"] = int(len(idx))
            r["rebuilt_f_max_err"] = float(err.max())
            r["rebuilt_f_max_rel_err"] = float(
                (err / np.maximum(1.0, size)).max())
            f_ok = r["rebuilt_f_max_rel_err"] <= F_RTOL
        ok = (same and finite and res.converged and f_ok
              and np.all(np.isfinite(res.alpha))
              and run["compactions"] >= 1
              and counts["A_launches"] == counts["B_launches"] == 0
              and counts["pair_captures"] == run["captures"]
              <= len(set(run["capacities"]))
              and self._path_bar(res, acc, self.rec["general"]["highest"]))
        if not ok:
            self.fail("shrinking", f"general pair WSS2: round trip {same}, "
                      f"finite {finite}, rebuilt f {f_ok}: {json.dumps(r)}")
        self.rec["shrink_general"] = r
        log(f"[shrinking] general pair WSS2 f32: {json.dumps(r)}")

    def _watch_masked_slots(self):
        """Wrap kernel B's wrapper so that each launch adds, on the device,
        the masked slots whose alpha it changed; returns (the count tensor,
        a function that restores the wrapper)."""
        from dpsvm_tpu_torch.experimental import subsolve_kernel as sk
        moved = self.torch.zeros((), dtype=self.torch.int64, device=self.dev)
        orig = sk.launch_inner_subsolve

        def watched(k_ww, y_w, c_w, a_w0, f_w0, active, *a, **kw):
            out = orig(k_ww, y_w, c_w, a_w0, f_w0, active, *a, **kw)
            moved.add_(((out[0] != a_w0) & ~active).sum())
            return out

        sk.launch_inner_subsolve = watched

        def restore():
            sk.launch_inner_subsolve = orig
        return moved, restore

    def shrink_decomp(self) -> None:
        """The decomposition with shrinking at q = DECOMP_Q, cap
        DECOMP_CAP, to convergence: kernel B's launches, runs and rounds
        equal, its steps adding up to n_iter, and no masked slot (capacity
        padding or W's own padding) ever updated."""
        from dpsvm_tpu_torch import fit
        from dpsvm_tpu_torch.solver import shrink
        xtr, ytr, xte, yte = self.planted()
        cfg = self.kind_config("rbf", gamma=GAMMA, max_iter=DECOMP_MAX_ITER,
                               working_set=DECOMP_Q, inner_iters=DECOMP_CAP,
                               shrinking=True)
        moved, restore = self._watch_masked_slots()
        try:
            (model, res), counts = self.counted(lambda: fit(xtr, ytr, cfg))
        finally:
            restore()
        run = dict(shrink.RUN)
        self._add_b_counts(counts)
        same, finite, acc, _, _ = self._round_trip(model, xte, yte)
        r = self._shrink_record(res, run, counts, acc,
                                self.rec["decomp"]["highest"])
        r["masked_slots_moved"] = int(moved)
        ok = (same and finite and res.converged
              and np.all(np.isfinite(res.alpha))
              and counts["B_launches"] == counts["B_runs"] == res.rounds > 0
              and counts["B_steps"] == res.n_iter and int(moved) == 0
              and min(run["active_sizes"]) >= DECOMP_Q
              and self._path_bar(res, acc, self.rec["decomp"]["highest"]))
        if not ok:
            self.fail("shrinking", f"decomposition: round trip {same}, "
                      f"finite {finite}: {json.dumps(r)}")
        self.rec["shrink_decomp"] = r
        log(f"[shrinking] decomposition f32: {json.dumps(r)}")

    def shrink_convergence(self) -> None:
        """The shrinking decomposition's kernel path (``fit``) against its
        plain path (``train_shrinking(plain=True)``), both on the card, on
        planted 8000 x 784 at q = 4096, to the bars of the ``convergence``
        phase (LibSVM bar on the training rows). The active set cannot
        halve there without going under q (8000 / 2 < 4096), so both runs
        stay at 8000 rows; the card tests hold kernel B on compacted,
        padded active sets against its plain version bitwise."""
        from dpsvm_tpu_torch import fit
        from dpsvm_tpu_torch.data.synthetic import make_planted
        from dpsvm_tpu_torch.models.svm import SVMModel, evaluate
        from dpsvm_tpu_torch.solver import shrink
        x8, y8 = make_planted(8000, D, GAMMA, seed=0)
        cfg = self.kind_config("rbf", gamma=GAMMA, max_iter=200_000,
                               working_set=4096, inner_iters=DECOMP_CAP,
                               shrinking=True)
        (mk, rk), counts = self.counted(lambda: fit(x8, y8, cfg))
        self._add_b_counts(counts)
        sizes_k = list(shrink.RUN["active_sizes"])
        rp = shrink.train_shrinking(x8, y8, cfg, self.dev, plain=True)
        sizes_p = list(shrink.RUN["active_sizes"])
        mp = SVMModel.from_train_result(x8, y8, rp)
        acc_k, acc_p = evaluate(mk, x8, y8), evaluate(mp, x8, y8)
        r = {"n": 8000, "q": 4096,
             "kernel": {"n_iter": rk.n_iter, "rounds": rk.rounds,
                        "n_sv": rk.n_sv, "converged": rk.converged,
                        "seconds": rk.train_seconds, "accuracy": acc_k,
                        "active_sizes": sizes_k},
             "plain": {"n_iter": rp.n_iter, "rounds": rp.rounds,
                       "n_sv": rp.n_sv, "converged": rp.converged,
                       "seconds": rp.train_seconds, "accuracy": acc_p,
                       "active_sizes": sizes_p},
             **counts}
        ok = (rk.converged and rp.converged
              and counts["B_launches"] == counts["B_runs"] == rk.rounds
              and counts["B_steps"] == rk.n_iter
              and abs(rk.n_sv - rp.n_sv) <= max(0.02 * rp.n_sv, 3.0)
              and abs(acc_k - acc_p) <= 1.0 / len(y8) + 1e-9)
        if not ok:
            self.fail("shrinking", f"decomposition kernel against plain: {r}")
        self.rec["shrink_convergence"] = r
        log(f"[shrinking] decomposition kernel against plain, 8000 x 784, "
            f"q=4096: {json.dumps(r)}")

    # ------------------------------------------------------------ phase 6
    def resume(self) -> None:
        """Kill and resume on each path at full width, f32, as a prefix
        comparison: 2K iterations straight against K with checkpoints
        (every K/2, two slots kept) resumed from the file to 2K, then,
        with the newest slot truncated, resumed from the rotation slot.
        The runs end bitwise equal (alpha, f, b_lo, b_hi, n_iter, read
        from checkpoints each writes at its end); on the fused pair kernel
        A's device-counted runs equal the iterations the resumed run made.
        Also the seconds a checkpoint costs its poll."""
        from dpsvm_tpu_torch import train
        from dpsvm_tpu_torch.solver import driver
        from dpsvm_tpu_torch.utils.checkpoint import load_checkpoint
        xtr, ytr, _, _ = self.planted()
        paths = (("fused", RESUME_PAIR_K, 512, {}),
                 ("general pair WSS2", RESUME_PAIR_K, 512,
                  dict(selection="second-order")),
                 ("decomposition", RESUME_DECOMP_K, RESUME_DECOMP_K // 2,
                  dict(working_set=DECOMP_Q, inner_iters=DECOMP_CAP)))
        self.rec["resume"] = {}
        with tempfile.TemporaryDirectory() as tmp:
            for name, k, chunk, kw in paths:
                cfg = self.kind_config("rbf", gamma=GAMMA, chunk_iters=chunk,
                                       **kw)

                def run(tag, max_iter, **extra):
                    end = os.path.join(tmp, f"{tag}.npz")
                    res, counts = self.counted(lambda: train(
                        xtr, ytr, dataclasses.replace(
                            cfg, max_iter=max_iter, checkpoint_path=end,
                            checkpoint_every=max_iter, **extra)))
                    if name == "decomposition":
                        self._add_b_counts(counts)
                    return res, counts, load_checkpoint(end)

                straight, _, want = run("straight", 2 * k)
                state = os.path.join(tmp, "state.npz")
                saves0 = dict(driver.CHECKPOINTS)
                first, _ = self.counted(lambda: train(
                    xtr, ytr, dataclasses.replace(
                        cfg, max_iter=k, checkpoint_path=state,
                        checkpoint_every=k // 2, checkpoint_keep=2)))
                saves = {s: driver.CHECKPOINTS[s] - saves0[s]
                         for s in ("saves", "pulls", "seconds")}
                r = {"k": k, "chunk_iters": chunk,
                     "straight_seconds": straight.train_seconds,
                     "first_seconds": first.train_seconds,
                     "checkpoint": {**saves, "seconds_a_save":
                                    saves["seconds"] / max(saves["saves"],
                                                           1)}}
                for tag, from_iter in (("resumed", k),
                                       ("rotation_slot", k // 2)):
                    if tag == "rotation_slot":
                        with open(state, "r+b") as fh:
                            fh.truncate(os.path.getsize(state) // 2)
                    res, counts, got = run(tag, 2 * k, resume_from=state)
                    bitwise = (np.array_equal(got.alpha, want.alpha)
                               and np.array_equal(got.f, want.f)
                               and (got.b_lo, got.b_hi, got.n_iter)
                               == (want.b_lo, want.b_hi, want.n_iter)
                               == (want.b_lo, want.b_hi, 2 * k))
                    runs = counts["A_runs"]
                    ok = bitwise and (name != "fused"
                                      or runs == 2 * k - from_iter)
                    r[tag] = {"bitwise": bool(bitwise), "from": from_iter,
                              "n_iter": res.n_iter,
                              "seconds": res.train_seconds, **counts}
                    if not ok:
                        self.fail("resume", f"{name} {tag}: {r}")
                self.rec["resume"][name] = r
                log(f"[resume] {name}: {json.dumps(r)}")

    # ------------------------------------------------------------ phase 7
    def libsvm(self) -> None:
        """The first LIBSVM_ROWS planted training rows (784 wide) written
        as a libsvm file and as a CSV, both loaded with ``load_dataset``:
        the same arrays, and the fused pair trained on each for
        PREFIX_ITERS iterations lands on the same alpha, b's and n_iter,
        bitwise."""
        from dpsvm_tpu_torch import SVMConfig, train
        from dpsvm_tpu_torch.data.loader import load_dataset
        xtr, ytr, _, _ = self.planted()
        xtr, ytr = xtr[:LIBSVM_ROWS], ytr[:LIBSVM_ROWS]
        r = {"rows": int(len(ytr)), "d": D}
        with tempfile.TemporaryDirectory() as tmp:
            lib, csv = (os.path.join(tmp, f"train.{e}")
                        for e in ("libsvm", "csv"))
            t = time.perf_counter()
            keys = [f"{j + 1}:" for j in range(D)]
            with open(lib, "w") as fl, open(csv, "w") as fc:
                for row, lab in zip(xtr.tolist(), ytr.tolist()):
                    vals = list(map(repr, row))
                    fl.write(f"{lab} " + " ".join(map(str.__add__, keys,
                                                      vals)) + "\n")
                    fc.write(f"{lab}," + ",".join(vals) + "\n")
            r["write_seconds"] = time.perf_counter() - t
            loaded = {}
            for fmt, path in (("libsvm", lib), ("csv", csv)):
                t = time.perf_counter()
                loaded[fmt] = load_dataset(path)
                r[f"{fmt}_load_seconds"] = time.perf_counter() - t
                r[f"{fmt}_bytes"] = os.path.getsize(path)
        (lx, ly), (cx, cy) = loaded["libsvm"], loaded["csv"]
        cfg = SVMConfig(c=C, gamma=GAMMA, epsilon=1e-3,
                        max_iter=PREFIX_ITERS)
        runs = [self.counted(lambda: train(x, y, cfg))
                for x, y in ((lx, ly), (cx, cy))]
        (a, ca), (b, _) = runs
        same_rows = (np.array_equal(lx, cx) and np.array_equal(ly, cy)
                     and np.array_equal(lx, xtr))
        same_run = (np.array_equal(a.alpha, b.alpha)
                    and (a.n_iter, a.b_lo, a.b_hi)
                    == (b.n_iter, b.b_lo, b.b_hi) == (PREFIX_ITERS, a.b_lo,
                                                      a.b_hi))
        r.update(same_rows=bool(same_rows), same_run=bool(same_run),
                 n_iter=a.n_iter, **ca)
        if not (same_rows and same_run and ca["A_runs"] == PREFIX_ITERS):
            self.fail("libsvm", f"{r}")
        self.rec["libsvm"] = r
        log(f"[libsvm] {json.dumps(r)}")

    # ------------------------------------------------------------ phase 8
    def timing(self) -> None:
        """Kernel A as the main path runs it: a training run's carry at its
        start, advanced by chunks of TIMED_ITERS iterations through
        ``launch_fused_chunk``. An iteration is one launch, so the kernel's
        time is CUDA events around one chunk over its iterations (the
        chunk's trailing slot, a launch that exits at once, and the poll's
        16-word read are in it). torch.profiler's sum over another chunk is
        kept beside it: with programmatic dependent launch a launch starts
        on the SMs the previous one has left and waits there, so that sum
        counts the overlap twice."""
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
            prof_ms = sum(_device_us(evt) for evt in prof.key_averages()
                          if KERNEL_A in evt.key) / 1e3 / TIMED_ITERS
            if not prof_ms > 0:
                raise RuntimeError(f"{key}: torch.profiler gave no device "
                                   f"time for {KERNEL_A}")
            # The plain versions and the yardstick on the same inputs: the
            # carry and the last body's rows and scalars.
            rows, scal = ws.rows.clone(), ws.scalars.clone()
            alpha, f = carry.alpha.clone(), carry.f.clone()
            scratch = fs.FusedCarry(alpha.clone(), f.clone(),
                                    carry.state.clone())

            def yardstick():
                dots = torch.matmul(rows, x.T).float()
                k = torch.exp(-scal[2] * (x2[None, :] + scal[3:5, None]
                                          - 2.0 * dots))
                fn = f + scal[0] * k[0] + scal[1] * k[1]
                f_up, f_low = masked_scores(alpha, y, fn, C)
                return torch.argmin(f_up), torch.argmax(f_low)

            plain = time_ms(lambda: fs.fused_smo_body_plain(
                scratch, x, x2, y, C, GAMMA), reps=20)
            lib = time_ms(yardstick, reps=20)
            el = x.element_size()
            bytes_ = N * D * el + 2 * D * el + 5 * N * 4 + 8 * 4
            flops = 4 * N * D
            bound = max(bytes_ / HBM_BYTES_PER_S,
                        flops / FP32_FLOPS_PER_S) * 1e3
            out[key] = {
                "iteration_ms": iter_ms,
                "fused_update_select": {
                    "ms": iter_ms, "profiler_ms": prof_ms,
                    "plain_ms": plain, "library_ms": lib,
                    "bound_ms": bound, "bound_share": bound / iter_ms,
                    "GBps": bytes_ / iter_ms / 1e6, "bytes": bytes_,
                    "flops": flops}}
            log(f"[timing] {key}: {json.dumps(out[key])}")
        self.rec["timing"] = out
        self.timing_decomp()

    def timing_decomp(self) -> None:
        """One decomposition round at full width from a real carry (the
        state after DECOMP_WARM_ROUNDS rounds), in both precisions: its
        wall time (CUDA events), the device time of each of its parts (the
        ``decomp.*`` profiler ranges of ``decomp_step``) and of kernel B,
        kernel B per launch on the round's own inputs (CUDA events over
        repeated launches), and the plain subsolve on the same inputs."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        from dpsvm_tpu_torch import SVMConfig
        from dpsvm_tpu_torch.experimental import subsolve_kernel as sk
        from dpsvm_tpu_torch.solver import decomp as sd
        xtr, ytr, _, _ = self.planted()
        q, cap = DECOMP_Q, DECOMP_CAP
        out = {}
        for prec in ("highest", "default"):
            key = "f32" if prec == "highest" else "bf16"
            cfg = SVMConfig(c=C, gamma=GAMMA, epsilon=1e-3, working_set=q,
                            inner_iters=cap, matmul_precision=prec,
                            max_iter=10 ** 9)
            prob = sd.DecompProblem.build(xtr, ytr, cfg, self.dev)
            run = sd.make_runner(prob, cfg, q, sd.DecompWorkspace(self.dev))
            carry, _ = run(sd.init_carry(prob.y), DECOMP_WARM_ROUNDS * cap)
            seen = []

            def capture(*args, **kw):
                seen[:] = [args, kw]
                return sk.launch_inner_subsolve(*args, **kw)

            def one_round(subsolve=sk.launch_inner_subsolve):
                fresh = carry._replace(alpha=carry.alpha.clone(),
                                       f=carry.f.clone())
                return sd.decomp_step(fresh, prob, q=q, inner_cap=cap,
                                      epsilon=1e-3, step_cap=cap,
                                      subsolve=subsolve)

            one_round(capture)                                 # warm up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            after = one_round()
            t1.record()
            torch.cuda.synchronize()
            round_ms = t0.elapsed_time(t1)
            peak = torch.cuda.max_memory_allocated()
            steps = int(after.n_iter - carry.n_iter)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                one_round()
                torch.cuda.synchronize()
            parts, kern_ms, busy_ms = {}, None, 0.0
            for evt in prof.key_averages():
                dev_us = _device_us(evt)
                if not evt.key.startswith("decomp."):
                    busy_ms += dev_us / 1e3
                if "subsolve_kernel" in evt.key:
                    kern_ms = dev_us / 1e3
                if evt.key.startswith("decomp."):
                    tot = getattr(evt, "device_time_total", None)
                    if tot is None:
                        tot = getattr(evt, "cuda_time_total", 0.0)
                    span = parts.setdefault(evt.key, {})
                    if dev_us:
                        span["gpu_span_ms"] = dev_us / 1e3
                    elif tot:
                        span["kernels_ms"] = float(tot) / 1e3
            if kern_ms is None:
                raise RuntimeError(f"{key}: torch.profiler gave no device "
                                   "time for subsolve_kernel")
            args, kw = seen
            launch_ms = time_ms(lambda: sk.launch_inner_subsolve(*args, **kw),
                                reps=20)
            plain = dict(kw)
            plain.pop("runs", None)
            plain_ms = time_ms(lambda: sk.inner_subsolve_plain(*args, **plain),
                               reps=3, warmup=1)
            # Each step reads two K rows; the state goes in and out once
            # (y, c, alpha, f, diag in; active bytes; alpha, f, stats out).
            # Operations: 7 a slot for the partner's objective, 4 for the
            # f update, each step.
            bytes_ = 8 * q * steps + 4 * q * 5 + q + 4 * q * 2 + 12
            flops = 11 * q * steps
            bound = max(bytes_ / HBM_BYTES_PER_S,
                        flops / FP32_FLOPS_PER_S) * 1e3
            out[key] = {
                "round_ms": round_ms, "steps": steps, "peak_bytes": int(peak),
                "device_busy_ms": busy_ms, "parts": parts,
                "inner_subsolve": {
                    "ms": kern_ms, "launch_ms": launch_ms,
                    "ms_per_step": kern_ms / max(steps, 1),
                    "plain_ms": plain_ms, "library_ms": None,
                    "bound_ms": bound, "bytes": bytes_, "flops": flops}}
            log(f"[timing] decomposition {key}: {json.dumps(out[key])}")
        self.rec["timing_decomp"] = out
        self.timing_subsolve_sizes()

    def timing_subsolve_sizes(self) -> None:
        """Kernel B alone at each q of SUBSOLVE_TIMED_QS: a launch of
        DECOMP_CAP steps from alpha = 0, f = -y on planted rows (CUDA
        events over 20 launches), with the launch shape it took."""
        torch = self.torch
        from dpsvm_tpu_torch.experimental import subsolve_kernel as sk
        sms = torch.cuda.get_device_properties(self.dev).multi_processor_count
        out = []
        for q in SUBSOLVE_TIMED_QS:
            inp = self.subsolve_inputs(q, 5 * q)
            run = lambda: sk.launch_inner_subsolve(
                *inp, 1e-3, DECOMP_CAP, max_cap=DECOMP_CAP, pairwise=False)
            steps = int(run()[4])
            ms = time_ms(run, reps=20)
            g = sk.launch_geometry(q, sms)
            r = {"q": q, "ms": ms, "steps": steps,
                 "us_per_step": 1e3 * ms / max(steps, 1),
                 "cluster": g.cluster, "threads": g.threads,
                 "slots": g.slots}
            out.append(r)
            log(f"[timing] subsolve {json.dumps(r)}")
            del inp
        self.rec["timing_subsolve"] = out
        self.timing_general()

    def timing_general(self) -> None:
        """The general pair's WSS2 iteration at full width, from the carry
        at alpha = 0 after a warm-up chunk: CUDA events over a chunk of
        SMO_TIMED_ITERS iterations (a graph replay runs GRAPH_BODIES
        bodies), the host's time to enqueue those replays, and from
        torch.profiler over another chunk the device's busy share (the sum
        of the kernels' device time over the chunk's device span, an upper
        bound: kernels do not overlap on one stream) and its top
        operations."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        from dpsvm_tpu_torch.solver import smo as gs
        xtr, ytr, _, _ = self.planted()
        out = {}
        for prec in ("highest", "default"):
            key = "f32" if prec == "highest" else "bf16"
            cfg = self.kind_config("rbf", gamma=GAMMA, max_iter=10 ** 9,
                                   selection="second-order",
                                   matmul_precision=prec)
            prob = gs.SMOProblem.build(xtr, ytr, cfg, self.dev)
            carry = gs.init_carry(prob.y)
            chunk = gs.GraphChunk(carry, prob, gs.SMOOptions.from_config(cfg),
                                  gs.two_eps_f32(cfg.epsilon))
            done = 0

            def run(iters):
                nonlocal done
                t = time.perf_counter()
                replays = chunk.run(done, done + iters)
                host = time.perf_counter() - t
                done += iters
                return replays, host

            run(64)
            torch.cuda.synchronize()
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            replays, host_s = run(SMO_TIMED_ITERS)
            t1.record()
            torch.cuda.synchronize()
            ms = t0.elapsed_time(t1)
            if int(carry.n_iter) != done:
                raise RuntimeError(f"{key}: the chunk ran {int(carry.n_iter)}"
                                   f" of {done} iterations")
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                p0 = torch.cuda.Event(enable_timing=True)
                p1 = torch.cuda.Event(enable_timing=True)
                p0.record()
                run(SMO_TIMED_ITERS)
                p1.record()
                torch.cuda.synchronize()
            span_ms = p0.elapsed_time(p1)
            ops = sorted(((_device_us(e) / 1e3, e.key, e.count)
                          for e in prof.key_averages() if _device_us(e) > 0),
                         reverse=True)
            busy_ms = sum(t for t, _, _ in ops)
            if not busy_ms > 0:
                raise RuntimeError(f"{key}: torch.profiler gave no device "
                                   "time for the general pair")
            out[key] = {
                "us_per_iteration": 1e3 * ms / SMO_TIMED_ITERS,
                "replays": replays, "bodies_per_replay": gs.GRAPH_BODIES,
                "host_enqueue_us_per_iteration": 1e6 * host_s
                / SMO_TIMED_ITERS,
                "profiled_span_ms": span_ms, "device_busy_ms": busy_ms,
                "busy_share": busy_ms / span_ms,
                "kernels_per_iteration": sum(c for _, _, c in ops)
                / SMO_TIMED_ITERS,
                "top_ops": [{"name": n[:80], "ms": t, "count": c}
                            for t, n, c in ops[:8]]}
            log(f"[timing] general pair WSS2 {key}: {json.dumps(out[key])}")
            del chunk, carry, prob
        self.rec["timing_general"] = out

    def kernels_line(self) -> dict:
        t, errs = self.rec["timing"], self.rec["max_abs_err"]
        name = "fused_update_select"
        f32, bf16 = t["f32"][name], t["bf16"][name]
        rows = [{
            "name": name, "route": "cuda",
            "source": "dpsvm_tpu_torch/csrc/fused_step.cu",
            "replaces": "dpsvm_tpu/experimental/fused_step.py:55 "
                        "(_fused_iter_kernel, pallas_call at :137) and the "
                        "scalar prologue of fused_smo_body at :193",
            "includes": "the scalar prologue and the finalize: one launch "
                        "an iteration",
            "launches": self.rec["main_launches"][name],
            "runs": self.rec["main_runs"][name],
            "max_abs_err": errs[name], "max_err": errs[name],
            "prologue_max_err": self.rec["prologue_err"],
            "ms": f32["ms"], "plain_ms": f32["plain_ms"],
            "bound_ms": f32["bound_ms"], "bound_by": "bytes",
            "library_ms": f32["library_ms"],
            "profiler_ms": f32["profiler_ms"],
            "bf16": {k: bf16[k] for k in ("ms", "plain_ms", "bound_ms",
                                          "library_ms", "profiler_ms")}}]
        td = self.rec["timing_decomp"]
        f32, bf16 = td["f32"]["inner_subsolve"], td["bf16"]["inner_subsolve"]
        counts = self.rec["decomp_counts"]
        from dpsvm_tpu_torch.experimental import subsolve_kernel as sk
        g = sk.launch_geometry(DECOMP_Q, self.torch.cuda.get_device_properties(
            self.dev).multi_processor_count)
        rows.append({
            "name": "inner_subsolve", "route": "cuda",
            "source": "dpsvm_tpu_torch/csrc/subsolve.cu",
            "replaces": "dpsvm_tpu/experimental/subsolve_kernel.py:45 "
                        "(_subsolve_kernel, pallas_call at :152)",
            "launches": counts["launches"], "runs": counts["runs"],
            "max_abs_err": errs["inner_subsolve"],
            "max_err": errs["inner_subsolve"],
            "ms": f32["ms"], "plain_ms": f32["plain_ms"],
            "bound_ms": f32["bound_ms"], "bound_by": "bytes",
            "library_ms": None, "ms_per_step": f32["ms_per_step"],
            "cluster": g.cluster, "threads": g.threads, "q": DECOMP_Q,
            "bf16": {k: bf16[k] for k in ("ms", "plain_ms", "bound_ms",
                                          "library_ms", "ms_per_step")},
            "by_q": self.rec["timing_subsolve"]})
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
                   ("shrinking", s.shrinking), ("resume", s.resume),
                   ("libsvm", s.libsvm), ("timing", s.timing)]
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

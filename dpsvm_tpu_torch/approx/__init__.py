"""Kernel approximation (port of ``dpsvm_tpu/approx``): explicit feature
maps + a primal linear solver, the million-row training path.

* ``features`` — Random Fourier Features (RBF) and Nystrom maps,
                 deterministic in ``approx_seed`` and bit for bit the
                 JAX package's; featurization on the device in blocks,
                 the feature matrix left there;
* ``primal``   — squared-hinge SVC / epsilon-insensitive SVR by
                 deterministic Nesterov steps, a chunk a captured CUDA
                 graph of gated bodies, driven by
                 ``solver/driver.host_training_loop``;
* ``model``    — ``ApproxSVMModel`` (feature map + primal weights, no SV
                 set) and its one-file ``.npz`` (the JAX format), behind
                 ``models/io.save_model`` / ``load_model``;
* ``screening``— the cascade's margin-band screening (pure NumPy).

Selected by ``SVMConfig.solver = "approx-rff" | "approx-nystrom"`` (+
``approx_dim`` / ``approx_seed``; CLI ``train --solver ...``).

``python -m dpsvm_tpu_torch.approx --selfcheck [--device cpu]`` checks
(1) the RFF kernel-approximation error bound on an embedded sample, and
that it shrinks as approx_dim grows; (2) the capture economy: one graph
capture a fit on the card (none on the CPU), none a chunk, and one
packed-stats read a chunk; (3) checkpoint/resume bitwise identity of the
final weights, and the model file round trip; (4) the cascade: screen ->
polish -> zero screened-out KKT violators, and the bitwise
stage-boundary kill -> resume drill at every boundary.
"""

from __future__ import annotations

import sys
from typing import List, Optional

__all__ = ["ApproxSVMModel", "FeatureMap", "build_feature_map",
           "featurize", "fit_approx", "load_approx_model",
           "save_approx_model", "selfcheck", "main"]

_LAZY = {
    "ApproxSVMModel": ("dpsvm_tpu_torch.approx.model", "ApproxSVMModel"),
    "load_approx_model": ("dpsvm_tpu_torch.approx.model",
                          "load_approx_model"),
    "save_approx_model": ("dpsvm_tpu_torch.approx.model",
                          "save_approx_model"),
    "FeatureMap": ("dpsvm_tpu_torch.approx.features", "FeatureMap"),
    "build_feature_map": ("dpsvm_tpu_torch.approx.features",
                          "build_feature_map"),
    "featurize": ("dpsvm_tpu_torch.approx.features", "featurize"),
    "fit_approx": ("dpsvm_tpu_torch.approx.primal", "fit_approx"),
}


def __getattr__(name: str):
    """PEP 562 lazy re-exports: torch loads only when something trains or
    featurizes."""
    try:
        mod, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}") from None
    import importlib
    return getattr(importlib.import_module(mod), attr)


def selfcheck(tmp_dir: Optional[str] = None, device=None) -> List[str]:
    """Run the subsystem end to end on an embedded sample; return a list
    of problems (empty = healthy). See the module docstring."""
    import dataclasses as _dc
    import os
    import tempfile

    import numpy as np

    problems: List[str] = []
    ctx = tempfile.TemporaryDirectory() if tmp_dir is None else None
    base = tmp_dir if tmp_dir is not None else ctx.name
    try:
        from dpsvm_tpu_torch.approx import primal
        from dpsvm_tpu_torch.approx.features import (build_feature_map,
                                                     featurize)
        from dpsvm_tpu_torch.approx.primal import fit_approx
        from dpsvm_tpu_torch.config import SVMConfig
        from dpsvm_tpu_torch.data.synthetic import make_blobs
        from dpsvm_tpu_torch.device import resolve_device
        from dpsvm_tpu_torch.ops.kernels import KernelSpec

        dev = resolve_device(device)
        # 1. RFF error bound, and monotone improvement with dim.
        x, y = make_blobs(n=192, d=6, seed=11)
        gamma = 0.25
        spec = KernelSpec(kind="rbf", gamma=gamma, coef0=0.0, degree=3)
        sub = x[:64]
        d2 = (np.sum(sub ** 2, 1)[:, None] - 2.0 * sub @ sub.T
              + np.sum(sub ** 2, 1)[None, :])
        k_exact = np.exp(-gamma * np.maximum(d2, 0.0))
        errs = {}
        for dim in (64, 2048):
            fm = build_feature_map("rff", x, dim, 0, spec)
            phi = featurize(fm, sub, device=dev).cpu().numpy()
            errs[dim] = float(np.max(np.abs(phi @ phi.T - k_exact)))
        if errs[2048] > 0.12:
            problems.append(
                f"RFF error bound: max |phi.phi' - K| = {errs[2048]:.3f} "
                "at D=2048 (expected <= 0.12)")
        if errs[2048] >= errs[64]:
            problems.append(
                f"RFF error did not shrink with dim: D=64 -> {errs[64]:.3f}, "
                f"D=2048 -> {errs[2048]:.3f}")

        # 2. Capture economy: one capture a fit on the card (none on the
        # CPU), none a chunk; one packed-stats read a chunk.
        cfg = SVMConfig(solver="approx-rff", approx_dim=128,
                        approx_seed=3, gamma=gamma, c=1.0,
                        epsilon=1e-3, max_iter=2000, chunk_iters=256)
        want = 1 if dev.type == "cuda" else 0
        for run in ("cold", "warm"):
            primal.reset_counts()
            model2, res2 = fit_approx(x, y, cfg, device=dev)
            polls = -(-max(res2.n_iter, 1) // cfg.chunk_iters)
            got = dict(primal.COUNTS)
            if got["captures"] != want:
                problems.append(
                    f"{run} training captured {got['captures']} graph(s), "
                    f"expected {want} (one a fit on the card, none on "
                    "the CPU)")
            if not polls <= got["reads"] <= polls + 1:
                problems.append(
                    f"{run} training read the packed stats {got['reads']} "
                    f"time(s) for {res2.n_iter} iterations in chunks of "
                    f"{cfg.chunk_iters} (expected one read a chunk)")

        # 3. Checkpoint/resume bitwise identity.
        ck = os.path.join(base, "approx_ck.npz")
        full_cfg = _dc.replace(cfg, approx_seed=5, max_iter=600,
                               epsilon=1e-9)
        model_full, _ = fit_approx(x, y, full_cfg, device=dev)
        half_cfg = _dc.replace(full_cfg, max_iter=300,
                               checkpoint_path=ck, checkpoint_every=100)
        fit_approx(x, y, half_cfg, device=dev)
        resume_cfg = _dc.replace(full_cfg, resume_from=ck)
        model_res, res = fit_approx(x, y, resume_cfg, device=dev)
        if res.n_iter != 600:
            problems.append(
                f"resumed run stopped at iter {res.n_iter}, expected 600")
        if not np.array_equal(model_full.w, model_res.w) or \
                model_full.b != model_res.b:
            problems.append(
                "checkpoint/resume is not bitwise-identical: "
                f"max |dw| = "
                f"{float(np.max(np.abs(model_full.w - model_res.w)))}")

        # Round trip (save -> load -> identical decisions).
        from dpsvm_tpu_torch.approx.model import (decision_function,
                                                  load_approx_model,
                                                  save_approx_model)
        path = os.path.join(base, "approx_selfcheck.npz")
        save_approx_model(model2, path)
        loaded = load_approx_model(path)
        if not np.array_equal(decision_function(model2, x[:32], device=dev),
                              decision_function(loaded, x[:32],
                                                device=dev)):
            problems.append("save/load round trip changed decisions")

        # 4. Cascade: zero screened-out KKT violators after repair, and
        # the bitwise kill -> resume drill at every stage boundary.
        from dpsvm_tpu_torch.resilience import faultinject
        from dpsvm_tpu_torch.solver.cascade import (CascadeInterrupted,
                                                    fit_cascade)

        xc, yc = make_blobs(n=320, d=8, seed=23)
        casc_cfg = SVMConfig(solver="cascade", approx_dim=64,
                             c=5.0, gamma=0.25, epsilon=1e-3,
                             max_iter=100_000)
        model_c, res_c = fit_cascade(xc, yc, casc_cfg, device=dev)
        if not res_c.converged or res_c.kkt_violators != 0:
            problems.append(
                f"cascade gate: converged={res_c.converged}, "
                f"{res_c.kkt_violators} screened-out KKT violator(s) "
                "after repair (expected a converged run with zero)")
        if not (0 < res_c.n_kept <= 320):
            problems.append(
                f"cascade gate: implausible kept count {res_c.n_kept}")
        prior_plan = faultinject.current()
        try:
            for stage in (1, 2, 3):
                ck = os.path.join(base, f"casc_s{stage}.npz")
                cfg_k = _dc.replace(casc_cfg, checkpoint_path=ck)
                faultinject.install(faultinject.FaultPlan(
                    cascade_stop_stage=stage))
                try:
                    fit_cascade(xc, yc, cfg_k, device=dev)
                    problems.append(
                        f"cascade stage-{stage} kill point never fired")
                except CascadeInterrupted:
                    pass
                faultinject.install(None)
                model_r, _res_r = fit_cascade(xc, yc, cfg_k, device=dev)
                if not (np.array_equal(model_c.alpha, model_r.alpha)
                        and np.array_equal(model_c.x_sv, model_r.x_sv)
                        and model_c.b == model_r.b):
                    problems.append(
                        f"cascade stage-{stage} kill->resume is not "
                        "bitwise-identical to the uninterrupted run")
        finally:
            faultinject.install(prior_plan)
    except Exception as e:                      # pragma: no cover
        problems.append(f"selfcheck crashed: {type(e).__name__}: {e}")
    finally:
        if ctx is not None:
            ctx.cleanup()
    return problems


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="python -m dpsvm_tpu_torch.approx")
    p.add_argument("--selfcheck", action="store_true",
                   help="run the kernel-approximation subsystem gate")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to run it (default: the GPU)")
    args = p.parse_args(argv)
    if not args.selfcheck:
        p.print_help()
        return 2
    problems = selfcheck(device=args.device)
    if problems:
        print("approx selfcheck FAILED:", file=sys.stderr)
        for q in problems:
            print(f"  - {q}", file=sys.stderr)
        return 1
    print("approx selfcheck OK (RFF error bound + monotone dim "
          "improvement, one graph capture a fit and one stats read a "
          "chunk, bitwise checkpoint/resume, save/load parity, cascade "
          "screen->polish->zero-violators + bitwise stage-boundary "
          "resume)")
    return 0

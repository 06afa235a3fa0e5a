"""nu-SVM family: nu-SVC (LIBSVM -s 1) and nu-SVR (-s 4) (port of
``dpsvm_tpu/models/nusvm.py``).

The nu formulations replace C's per-example cost with a single nu in
(0, 1] that lower-bounds the SV fraction and upper-bounds the margin-
error fraction. Their duals carry TWO equality constraints (one per
class), which the general pair honors with ``nu_selection``: working
pairs share a label and the class with the larger KKT gap is optimized
first (LIBSVM's Solver_NU, svm.cpp). Everything else (the captured chunk
on the card, the masks, the pair update) is the unmodified general pair,
reached through the same ``alpha_init``/``f_init`` seeds SVR and
one-class use. No hand-written kernel runs here: the JAX package's
``nu_selection`` is plain XLA, and the port's is PyTorch calls inside the
general pair's captured graph.

  * nu-SVC (solve_nu_svc): box [0, 1], sum of each class's alphas
    = nu*n/2, zero linear term (f0 = K (alpha0 y), no -y), pairwise
    clip (the class sums are invariants). After the solve f is rebuilt
    on the device from the final alphas, and the per-class thresholds
    r1/r2 (``_class_thresholds``, NumPy float64) give r = (r1+r2)/2 and
    rho = (r1-r2)/2; the stored model rescales alpha/r with intercept
    rho/r so the decision function matches C-SVC's form.
  * nu-SVR (solve_nu_svr): the 2n doubled variables of epsilon-SVR
    (``models/svr.py``) with alpha = alpha* = min(C, remaining) seeding
    (sum C*nu*n/2 per half), linear term -+z instead of the epsilon tube
    (the tube width is a RESULT: epsilon_eff = -(r1+r2)/2, intercept
    b = -(r1-r2)/2).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from dpsvm_tpu_torch.config import SVMConfig, TrainResult
from dpsvm_tpu_torch.models.svm import SVMModel


def _solve_nu(x, y_pm, alpha0, f0, config: SVMConfig,
              device=None) -> TrainResult:
    """Run the nu_selection solver: the general pair on one device,
    called directly (the nu family's two-constraint selection has no
    decomposition or distributed variant). The JAX package's refusal
    table, row for row and message for message, for the fields the port
    has: its ``backend`` and ``use_pallas`` rows drop out (the port's
    config has no ``backend``, and its ``use_pallas`` picks no path)."""
    from dpsvm_tpu_torch.device import resolve_device
    from dpsvm_tpu_torch.solver.smo import train_single_device

    # The nu family supports neither shrinking nor decomposition, so
    # "auto" sentinels always concretize to the classic path here.
    if config.shrinking == "auto" or config.working_set == 0:
        config = dataclasses.replace(
            config,
            shrinking=(False if config.shrinking == "auto"
                       else config.shrinking),
            working_set=(2 if config.working_set == 0
                         else config.working_set))
    for field, bad in (("shards", config.shards > 1),
                       ("working_set", config.working_set > 2),
                       ("shrinking", config.shrinking is True),
                       ("cache_size", config.cache_size > 0),
                       ("selection", config.selection != "first-order"),
                       ("select_impl",
                        config.select_impl != "argminmax"),
                       # Checkpoints carry no task tag, and a shape-
                       # compatible C-SVC checkpoint resuming here would
                       # silently replace the nu seeding with alphas
                       # violating both equality constraints.
                       ("resume_from", bool(config.resume_from)),
                       ("checkpoint_path", bool(config.checkpoint_path)),
                       ("weight_pos/weight_neg",
                        config.weight_pos != 1.0
                        or config.weight_neg != 1.0)):
        if bad:
            raise ValueError(f"nu-SVM training does not support {field} "
                             "(the two-constraint Solver_NU selection "
                             "runs on the single-device first-order "
                             "path; class weights and checkpoints do "
                             "not compose with the nu constraints)")
    return train_single_device(x, y_pm, config, resolve_device(device),
                               f_init=f0, alpha_init=alpha0,
                               guard_eta=True, nu_selection=True)


def _class_thresholds(f, y_pm, alpha, c_box):
    """LIBSVM Solver_NU::calculate_rho's (r1, r2) from the final state.

    G_i = y_i f_i (f maintains K(alpha y); the nu duals have no linear
    term). Per class: the average G over free SVs, else the midpoint of
    the active-bound extremes."""
    g = y_pm * f
    out = []
    for sign in (1.0, -1.0):
        cls = y_pm == sign
        free = cls & (alpha > 0) & (alpha < c_box)
        if free.any():
            out.append(float(g[free].mean()))
            continue
        at0 = cls & (alpha == 0)
        atc = cls & (alpha == c_box)
        # alpha=0 can only increase (G too low is a violation): upper
        # candidate; alpha=C can only decrease: lower candidate.
        ub = float(g[at0].min()) if at0.any() else np.inf
        lb = float(g[atc].max()) if atc.any() else -np.inf
        out.append((ub + lb) / 2.0)
    return out[0], out[1]


def _nu_head_seed(total: float, cap: float, n: int) -> np.ndarray:
    """LIBSVM's prefix seeding, min(cap, remaining) in data order, in
    closed form (a_i = clip(total - i*cap, 0, cap))."""
    a = np.clip(total - cap * np.arange(n, dtype=np.float64), 0.0, cap)
    return a.astype(np.float32)


def _kv(x, coef, config: SVMConfig, precomp: bool, dev) -> np.ndarray:
    """K @ coef: one matvec for a precomputed K, else one streamed kernel
    pass on the device (blocks of 4096 rows, as the JAX package)."""
    from dpsvm_tpu_torch.ops.diagnostics import _stream_kv
    if precomp:
        return (x @ coef).astype(np.float32)
    return _stream_kv(x, coef, config.kernel_spec(x.shape[1]), block=4096,
                      device=dev)


def train_nusvc(x: np.ndarray, y: np.ndarray, nu: float = 0.5,
                config: Optional[SVMConfig] = None, device=None
                ) -> Tuple[SVMModel, TrainResult]:
    """Fit a nu-SVC (LIBSVM -s 1). ``config.c`` is ignored (the nu-SVC
    box is 1 by construction); labels are +/-1. ``device`` None means the
    GPU; ``"cpu"`` runs the plain PyTorch path."""
    from dpsvm_tpu_torch.device import resolve_device
    from dpsvm_tpu_torch.utils import densify

    x = densify(x)
    config = config or SVMConfig()
    precomp = config.kernel == "precomputed"
    if not 0.0 < nu <= 1.0:
        raise ValueError(f"nu must be in (0, 1], got {nu}")
    if config.weight_pos != 1.0 or config.weight_neg != 1.0:
        raise ValueError("class weights do not apply to nu-SVC (the nu "
                         "constraint fixes each class's alpha mass)")
    x = np.asarray(x, np.float32)
    y = np.asarray(y)
    if x.ndim != 2 or y.shape != (x.shape[0],):
        raise ValueError(f"x must be (n, d) with y (n,), got {x.shape} "
                         f"and {y.shape}")
    if not np.all(np.isin(np.unique(y), (-1, 1))):
        raise ValueError("nu-SVC labels must be +/-1 (binary); for "
                         "multiclass data use models.multiclass")
    if precomp and x.shape[0] != x.shape[1]:
        raise ValueError(
            "precomputed nu-SVC training needs the square (n, n) "
            f"kernel matrix K(train, train); got {x.shape}")
    n, d = x.shape
    pos = y > 0
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    # Feasibility (LIBSVM svm_check_parameter): nu*n/2 alphas of size
    # <= 1 must fit in each class.
    if nu * n / 2.0 > min(n_pos, n_neg) + 1e-9:
        raise ValueError(
            f"nu={nu} is infeasible: nu*n/2 = {nu * n / 2:.1f} exceeds "
            f"the smaller class ({min(n_pos, n_neg)} examples)")
    dev = resolve_device(device)
    half = nu * n / 2.0
    alpha0 = np.zeros(n, np.float32)
    for cls in (pos, ~pos):
        idx = np.nonzero(cls)[0]
        alpha0[idx] = _nu_head_seed(half, 1.0, len(idx))
    yf = np.where(pos, 1.0, -1.0).astype(np.float32)
    f0 = _kv(x, alpha0 * yf, config, precomp, dev)

    config = dataclasses.replace(config, c=1.0, clip="pairwise")
    result = _solve_nu(x, yf, alpha0, f0, config, dev)

    alpha = np.asarray(result.alpha, np.float32)
    f = _kv(x, alpha * yf, config, precomp, dev)
    r1, r2 = _class_thresholds(f, yf, alpha, 1.0)
    r = (r1 + r2) / 2.0
    if not np.isfinite(r) or r <= 0:
        raise RuntimeError(f"degenerate nu-SVC solution (r={r}); the "
                           "problem may be unseparated at this nu/gamma")
    rho = (r1 - r2) / 2.0

    keep = alpha > 0
    extra = {}
    if precomp:
        extra = dict(sv_idx=np.flatnonzero(keep).astype(np.int64),
                     n_train=n)
    model = SVMModel(
        x_sv=(np.zeros((int(keep.sum()), 0), np.float32) if precomp
              else np.ascontiguousarray(x[keep])),
        alpha=(alpha[keep] / np.float32(r)),
        y_sv=np.where(pos[keep], 1, -1).astype(np.int32),
        b=float(rho / r),
        gamma=float(config.resolve_gamma(d)),
        kernel=config.kernel, coef0=float(config.coef0),
        degree=int(config.degree), **extra)
    result.b = float(rho / r)
    result.n_sv = int(keep.sum())
    return model, result


def train_nusvr(x: np.ndarray, z: np.ndarray, nu: float = 0.5,
                config: Optional[SVMConfig] = None, device=None
                ) -> Tuple[SVMModel, TrainResult]:
    """Fit a nu-SVR (LIBSVM -s 4): the tube width is learned, nu bounds
    the fraction of points outside it. ``config.c`` is the usual cost;
    ``config.svr_epsilon`` is ignored (epsilon is a result, in
    ``TrainResult.learned_epsilon``). ``device`` None means the GPU."""
    from dpsvm_tpu_torch.device import resolve_device
    from dpsvm_tpu_torch.utils import densify

    x = densify(x)
    config = config or SVMConfig()
    precomp = config.kernel == "precomputed"
    if not 0.0 < nu <= 1.0:
        raise ValueError(f"nu must be in (0, 1], got {nu}")
    x = np.asarray(x, np.float32)
    z = np.asarray(z, np.float32)
    if precomp and (x.ndim != 2 or x.shape[0] != x.shape[1]):
        raise ValueError(
            "precomputed nu-SVR training needs the square (n, n) "
            f"kernel matrix K(train, train); got {x.shape}")
    n, d = x.shape
    if z.shape != (n,):
        raise ValueError(f"targets must be ({n},), got {z.shape}")
    C = float(config.c)
    dev = resolve_device(device)

    # LIBSVM solve_nu_svr seeding: alpha_j = alpha*_j = min(C, rem), rem
    # from C*nu*n/2.
    seed = _nu_head_seed(C * nu * n / 2.0, C, n)
    alpha0 = np.concatenate([seed, seed]).astype(np.float32)
    # Doubled problem (models/svr.py): rows [x; x], pseudo-labels
    # [+1; -1]. f_i = K(a y)_i - z_i on both halves, and the seed's kernel
    # term vanishes (alpha_j == alpha*_j with opposite labels), so
    # f0 = -z: no kernel pass.
    x2n = np.tile(x, (2, 2)) if precomp else np.concatenate([x, x], axis=0)
    y_pm = np.concatenate([np.ones(n), -np.ones(n)]).astype(np.float32)
    f0 = np.concatenate([-z, -z]).astype(np.float32)

    config = dataclasses.replace(config, clip="pairwise")
    result = _solve_nu(x2n, y_pm, alpha0, f0, config, dev)

    a2 = np.asarray(result.alpha, np.float32)
    delta = a2[:n] - a2[n:]
    kv = _kv(x, delta, config, precomp, dev)
    f = np.concatenate([kv - z, kv - z]).astype(np.float32)
    r1, r2 = _class_thresholds(f, y_pm, a2, np.float32(C))
    # The learned tube half-width -(r1+r2)/2 (LIBSVM's "epsilon = -r",
    # svm.cpp svm_train for NU_SVR); intercept b = -(r1-r2)/2.
    eps_eff = -(r1 + r2) / 2.0
    b = -(r1 - r2) / 2.0

    keep = delta != 0
    extra = {}
    if precomp:
        extra = dict(sv_idx=np.flatnonzero(keep).astype(np.int64),
                     n_train=n)
    model = SVMModel(
        x_sv=(np.zeros((int(keep.sum()), 0), np.float32) if precomp
              else np.ascontiguousarray(x[keep])),
        alpha=np.abs(delta[keep]).astype(np.float32),
        y_sv=np.sign(delta[keep]).astype(np.int32),
        b=float(-b),      # stored so that sum - b == sum + b_intercept
        gamma=float(config.resolve_gamma(d)),
        kernel=config.kernel, coef0=float(config.coef0),
        degree=int(config.degree), task="svr", **extra)
    result.b = float(b)
    result.n_sv = int(keep.sum())
    result.learned_epsilon = float(eps_eff)
    return model, result

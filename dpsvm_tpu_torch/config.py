"""Solver configuration and result types for the PyTorch/CUDA port.

A copy of the fields of ``dpsvm_tpu.config.SVMConfig`` that training and
testing read, with the same names, defaults and validation messages. The
port keeps its own copy: it never imports the JAX package.

Three solver paths are ported, each with the envelope a method names:

* ``working_set == 2`` within ``fused_incompatibility`` (binary RBF C-SVC,
  first-order selection, the reference's independent clip, one device, no
  class weights, no row cache): the fused first-order SMO pair;
* every other ``working_set == 2`` config: the general SMO pair,
  ``solver/smo.py`` on one device, ``parallel/dist_smo.py`` over
  ``shards`` ranks — first- or
  second-order selection, both clips, class weights, every kernel kind,
  and the kernel-row cache (``cache_size > 0``, ``ops/rowcache.py``) on
  its first-order branch (``validate`` rejects the cache with
  second-order selection, precomputed, shrinking and working_set > 2,
  as the JAX package does);
* ``working_set > 2``: the large-working-set decomposition
  (``solver/decomp.py``, or ``parallel/dist_decomp.py`` over ``shards``
  ranks), every kernel kind, both clips and class weights.

``solver`` picks the family: "exact" (the three paths above),
"approx-rff" / "approx-nystrom" (``approx/``) or "cascade"
(``solver/cascade.py``), with the JAX package's per-solver knob table
(``_KNOB_TABLE``: a knob another family owns is refused, naming it).
``shards > 1`` runs in a process group of that many ranks (``api.train``
raises without one, naming the ways to start it).
``shrinking`` (``solver/shrink.py``) wraps the general pair or the
decomposition; ``checkpoint_*`` and ``resume_from`` apply to all three
paths. ``resolved`` turns the "auto" sentinels into concrete values
through the JAX package's shape table, copied here (``_PLAN_TABLE``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

# Sentinel used by the reference for masked I-set scores
# (svmTrain.cu:59,66 use +/-1e9); kept identical for parity.
SENTINEL = 1.0e9

_PRECISIONS = ("highest", "high", "default")

_SOLVERS = ("exact", "approx-rff", "approx-nystrom", "cascade")

# Default cascade screening band (SVMConfig.screen_margin): one name so the
# field default, the capability table's "is the knob set" test and the
# cascade's stage sub-config resets cannot drift apart.
SCREEN_MARGIN_DEFAULT = 0.35

# Per-solver knob capability table, the JAX package's row for row (its row
# on a field the port does not have, backend, drops out): (field label,
# is-set predicate, solvers that accept it, why the others reject it). A
# rejection names the solver(s) that would accept the knob. The cascade
# accepts both families' knobs: its stage 1 is an approx primal train, its
# stage 3 an exact dual polish.
_DUAL = ("exact", "cascade")
_CASCADE = ("cascade",)
_KNOB_TABLE = (
    ("selection", lambda c: c.selection != "first-order", _DUAL,
     "there is no working-set selection in the primal solver"),
    ("select_impl", lambda c: c.select_impl != "argminmax", _DUAL,
     "there is no extrema selection to lower"),
    ("working_set", lambda c: c.working_set not in (0, 2), _DUAL,
     "there is no dual working set; the minibatch size is chosen by "
     "the primal solver"),
    ("inner_iters", lambda c: bool(c.inner_iters), _DUAL,
     "there is no decomposition subsolve"),
    ("grow_working_set", lambda c: c.grow_working_set, _DUAL,
     "there is no working set to grow"),
    ("shrinking", lambda c: c.shrinking is True, _DUAL,
     "there is no active set; every row rides the feature matmul"),
    ("cache_size", lambda c: c.cache_size > 0, _DUAL,
     "there are no kernel rows to cache"),
    ("use_pallas", lambda c: c.use_pallas == "on", _DUAL,
     "the Pallas kernels implement the dual iteration"),
    ("polish", lambda c: c.polish, ("exact",),
     "the two-phase precision schedule refines a dual trajectory — "
     "and the cascade is itself a screen-and-polish schedule; set "
     "matmul_precision directly"),
    ("screen_margin",
     lambda c: c.screen_margin != SCREEN_MARGIN_DEFAULT, _CASCADE,
     "margin-band SV screening is the cascade's stage-2 knob"),
    ("screen_cap", lambda c: c.screen_cap != 0, _CASCADE,
     "the screened-subproblem row cap is the cascade's stage-2 knob"),
)


@dataclasses.dataclass(frozen=True)
class SVMConfig:
    """Hyperparameters + execution options for the SMO solver."""

    # --- algorithm (reference-parity) ---
    c: float = 1.0                      # box constraint C
    gamma: Optional[float] = None       # kernel gamma; None => 1.0 / d
    kernel: str = "rbf"                 # LIBSVM -t family: "linear" (u.v),
                                        # "poly" ((g u.v + r)^deg), "rbf"
                                        # (the reference's only kernel),
                                        # "sigmoid" (tanh(g u.v + r)),
                                        # "precomputed" (x is K)
    degree: int = 3                     # poly degree (LIBSVM -d)
    coef0: float = 0.0                  # poly/sigmoid coef0 (LIBSVM -r)
    epsilon: float = 0.001              # convergence tolerance
    svr_epsilon: float = 0.1            # epsilon-SVR tube half-width
                                        # (LIBSVM -p; models/svr.py)
    max_iter: int = 150_000             # iteration cap
    cache_size: int = 0                 # kernel-row cache lines (0 = off)
    weight_pos: float = 1.0             # class-weighted costs: the box
    weight_neg: float = 1.0             # bound is C*weight_pos for y=+1,
                                        # C*weight_neg for y=-1
    selection: str = "first-order"      # working-set rule
    working_set: int = 2                # 2 = the reference's SMO pair;
                                        # even q > 2 = large-working-set
                                        # decomposition (solver/decomp.py);
                                        # 0 = auto, which resolves to 2
    inner_iters: int = 0                # decomposition inner-step cap per
                                        # outer round (0 = auto: q/4, at
                                        # least 32)
    grow_working_set: bool = False      # adaptive decomposition: grow q
                                        # when the SV count approaches it
    shrinking: object = False           # LIBSVM -h: active-set training
                                        # (solver/shrink.py): compact the
                                        # problem to the rows that can
                                        # still move, validate on the full
                                        # problem at the end. True | False
                                        # | "auto" (shape-resolved by
                                        # resolved()). Off by default (the
                                        # reference has no shrinking; the
                                        # unshrunk path is the parity path)
    clip: str = "independent"           # "independent" (the reference's)
                                        # or "pairwise" (textbook/LIBSVM)
    select_impl: str = "argminmax"      # first-order selection: "argminmax"
                                        # (argmin + argmax) or "packed"
                                        # (one min and one max over 64-bit
                                        # (value, index) keys; the same
                                        # answer on finite scores)
    polish: bool = False                # two-phase precision schedule: the
                                        # configured path at bf16 X, then an
                                        # exact-f32 warm start to the same
                                        # epsilon (api.train)
    solver: str = "exact"               # "exact" = the dual paths above;
                                        # "approx-rff" / "approx-nystrom" =
                                        # explicit feature map + primal
                                        # linear solver (approx/): api.fit
                                        # returns an ApproxSVMModel;
                                        # "cascade" = approx warm-start ->
                                        # margin-band SV screening -> exact
                                        # dual polish with KKT re-admission
                                        # (solver/cascade.py): api.fit
                                        # returns an ordinary SVMModel
    approx_dim: int = 1024              # feature-map dimension D: RFF uses
                                        # D/2 cos/sin pairs (D even);
                                        # Nystrom up to D landmarks
                                        # (capped by n, rank-truncated)
    approx_seed: int = 0                # feature-map seed (RFF frequencies,
                                        # Nystrom landmarks, the primal
                                        # shuffle), persisted with the model
    screen_margin: float = SCREEN_MARGIN_DEFAULT
                                        # cascade stage 2: a row survives
                                        # screening when its calibrated
                                        # approx margin y f(x) <= 1 +
                                        # screen_margin
    screen_cap: int = 0                 # cascade stage 2: hard cap on the
                                        # screened subproblem's rows (0 =
                                        # uncapped); over-cap rows drop
                                        # largest-margin first

    # --- execution ---
    shards: int = 1                     # ranks along the data axis, one
                                        # process a device (parallel/)
    shard_x: bool = True                # shard X rows over the ranks;
                                        # False replicates X (reference
                                        # parity: every rank holds full X,
                                        # svmTrainMain.cpp:180)
    chunk_iters: int = 512              # host polls convergence every chunk
    use_pallas: str = "auto"            # accepted and validated as in the
                                        # JAX package, where it picks the
                                        # Pallas kernels. It changes no path
                                        # here: on the card the fused
                                        # iteration and the decomposition's
                                        # inner subsolve always run their
                                        # CUDA kernels
    matmul_precision: str = "highest"   # "highest"/"high": X stored f32;
                                        # "default": X stored bf16 (half
                                        # the bytes of the per-iteration
                                        # pass); accumulation is f32 always
    verbose: bool = False
    log_every: int = 0                  # 0 = no per-chunk logging
    wall_budget_s: float = 0.0          # stop dispatching chunks after this
                                        # much wall-clock (0 = no budget)

    # --- persistence (the reference has none) ---
    checkpoint_path: Optional[str] = None   # .npz solver-state file
    checkpoint_every: int = 0               # iterations between saves (0=off)
    checkpoint_keep: int = 2                # rotation slots kept (state.npz,
                                            # state.1.npz, ...): the newest
                                            # write can never destroy the
                                            # only intact state; 1 = no
                                            # rotation
    resume_from: Optional[str] = None       # checkpoint to resume from
                                            # (a corrupt file falls back to
                                            # the newest intact rotation
                                            # slot)

    def fused_incompatibility(self) -> Optional[str]:
        """Why the fused iteration cannot run this config (None if it can).
        ``api.train`` sends such a config to the general pair."""
        if self.shards > 1:
            return "shards > 1"
        if self.kernel != "rbf":
            return f"kernel {self.kernel!r} (RBF only)"
        if self.clip != "independent":
            return f"clip {self.clip!r} (reference clip only)"
        if self.cache_size > 0:
            return "the kernel-row cache (cache_size > 0)"
        if self.selection != "first-order":
            return f"selection {self.selection!r}"
        if self.working_set != 2:
            return "working_set > 2 (decomposition)"
        if self.weight_pos != 1.0 or self.weight_neg != 1.0:
            return "class-weighted costs"
        return None

    def box_bound(self, y):
        """Per-example box bound C_i = C * w(y_i), or the scalar C when
        unweighted: the float32 values the solvers' exact ``alpha == C``
        membership tests compare against."""
        import numpy as np
        if self.weight_pos == 1.0 and self.weight_neg == 1.0:
            return self.c
        return np.where(np.asarray(y) > 0,
                        np.float32(self.c * self.weight_pos),
                        np.float32(self.c * self.weight_neg))

    def resolve_gamma(self, num_attributes: int) -> float:
        if self.gamma is not None:
            return float(self.gamma)
        return 1.0 / float(num_attributes)

    def kernel_spec(self, num_attributes: int):
        """The KernelSpec every solver path consumes."""
        from dpsvm_tpu_torch.ops.kernels import KernelSpec
        return KernelSpec(kind=self.kernel,
                          gamma=self.resolve_gamma(num_attributes),
                          coef0=float(self.coef0),
                          degree=int(self.degree))

    def resolved(self, n: int, d: int) -> "SVMConfig":
        """Concretize the auto solver-path sentinels for an (n, d)
        problem: ``shrinking="auto"`` and ``working_set=0`` become
        shape-chosen values (``_auto_solver_plan``), so everything
        downstream of ``api.train`` sees concrete configs. No-op when
        nothing is "auto"."""
        if self.shrinking != "auto" and self.working_set != 0:
            return self
        cfg = dataclasses.replace(
            self, **_auto_solver_plan(int(n), int(d), self))
        cfg.validate()
        return cfg

    def validate(self) -> None:
        if self.c <= 0:
            raise ValueError(f"cost must be > 0, got {self.c}")
        if self.epsilon <= 0:
            raise ValueError(f"epsilon must be > 0, got {self.epsilon}")
        if self.max_iter <= 0:
            raise ValueError(f"max_iter must be > 0, got {self.max_iter}")
        if self.shards < 1:
            raise ValueError(f"shards must be >= 1, got {self.shards}")
        if self.cache_size < 0:
            raise ValueError(f"cache_size must be >= 0, got {self.cache_size}")
        if self.chunk_iters <= 0:
            raise ValueError(
                f"chunk_iters must be > 0, got {self.chunk_iters}")
        if self.checkpoint_every < 0:
            raise ValueError(
                f"checkpoint_every must be >= 0, got {self.checkpoint_every}")
        if self.checkpoint_every and not self.checkpoint_path:
            raise ValueError("checkpoint_every set without checkpoint_path")
        if self.checkpoint_keep < 1:
            raise ValueError(
                f"checkpoint_keep must be >= 1, got {self.checkpoint_keep}")
        if self.wall_budget_s < 0:
            raise ValueError(
                f"wall_budget_s must be >= 0, got {self.wall_budget_s}")
        if not (math.isfinite(self.weight_pos) and self.weight_pos > 0
                and math.isfinite(self.weight_neg)
                and self.weight_neg > 0):
            raise ValueError("class weights must be > 0 and finite, got "
                             f"({self.weight_pos}, {self.weight_neg})")
        if self.svr_epsilon < 0:
            raise ValueError(
                f"svr_epsilon must be >= 0, got {self.svr_epsilon}")
        if self.clip not in ("independent", "pairwise"):
            raise ValueError(f"clip must be 'independent' or 'pairwise', "
                             f"got {self.clip!r}")
        if self.kernel not in ("linear", "poly", "rbf", "sigmoid",
                               "precomputed"):
            raise ValueError(f"kernel must be 'linear', 'poly', 'rbf', "
                             f"'sigmoid' or 'precomputed', got "
                             f"{self.kernel!r}")
        if self.kernel == "precomputed":
            if self.shrinking is True:
                raise ValueError(
                    "precomputed kernel does not support shrinking: the "
                    "unshrink f reconstruction evaluates kernels between "
                    "row subsets, which a gathered K cannot provide")
            if self.cache_size > 0:
                raise ValueError(
                    "precomputed kernel has nothing to cache: the row "
                    "fetch is already a 2-row gather of the stored K")
            if self.use_pallas == "on":
                raise ValueError(
                    "the Pallas kernels are built around the vector-"
                    "kernel row fetch; precomputed uses the plain XLA "
                    "gather path")
        if self.kernel == "poly" and self.degree < 1:
            raise ValueError(f"poly degree must be >= 1, got {self.degree}")
        if self.solver not in _SOLVERS:
            raise ValueError(f"solver must be one of {_SOLVERS}, got "
                             f"{self.solver!r}")
        if self.approx_dim < 2:
            raise ValueError(
                f"approx_dim must be >= 2, got {self.approx_dim}")
        for field, is_set, accepted, what in _KNOB_TABLE:
            if self.solver not in accepted and is_set(self):
                raise ValueError(
                    f"solver={self.solver!r} does not support {field}: "
                    f"{what} (accepted by solver "
                    f"{', '.join(repr(s) for s in accepted)})")
        if self.solver != "exact":
            if self.solver == "approx-rff" and self.kernel != "rbf":
                raise ValueError(
                    "approx-rff is the RBF spectral feature map "
                    "(Rahimi-Recht); for other kernels use "
                    "approx-nystrom or the exact solver")
            if (self.approx_dim % 2
                    and (self.solver == "approx-rff"
                         or (self.solver == "cascade"
                             and self.kernel == "rbf"))):
                raise ValueError(
                    "approx-rff pairs cos/sin features, so "
                    f"approx_dim must be even, got {self.approx_dim}"
                    + (" (the cascade's RBF warm-start stage is "
                       "approx-rff)" if self.solver == "cascade" else ""))
            if self.kernel == "precomputed":
                raise ValueError(
                    "approx solvers evaluate kernels between new rows "
                    "and landmarks/frequencies; a precomputed K has no "
                    "row vectors to featurize"
                    + (" (the cascade's warm-start stage is an approx "
                       "train)" if self.solver == "cascade" else ""))
        if self.solver == "cascade":
            if not (math.isfinite(self.screen_margin)
                    and self.screen_margin > 0):
                raise ValueError("screen_margin must be finite and > 0, "
                                 f"got {self.screen_margin}")
            if self.screen_cap < 0:
                raise ValueError(
                    f"screen_cap must be >= 0, got {self.screen_cap}")
            # Stage state lives under checkpoint_path (stage-boundary
            # files, auto-resumed: solver/cascade.py).
            if self.resume_from:
                raise ValueError(
                    "cascade does not support resume_from: it "
                    "auto-resumes from its stage-boundary state files "
                    "under checkpoint_path (delete them to restart)")
            if self.checkpoint_every:
                raise ValueError(
                    "cascade does not support checkpoint_every: stage "
                    "boundaries are its checkpoint cadence — set "
                    "checkpoint_path alone to name where stage state "
                    "lives")
        if self.selection not in ("first-order", "second-order"):
            raise ValueError(f"selection must be 'first-order' or "
                             f"'second-order', got {self.selection!r}")
        if self.select_impl not in ("argminmax", "packed"):
            raise ValueError(f"select_impl must be 'argminmax' or "
                             f"'packed', got {self.select_impl!r}")
        if (self.select_impl != "argminmax" and self.use_pallas == "on"
                and self.working_set == 2):
            raise ValueError("the fused Pallas kernel has its own "
                             "in-kernel selection; select_impl does "
                             "not apply (use_pallas='on')")
        if self.selection == "second-order":
            if self.cache_size > 0:
                raise ValueError("second-order selection needs the hi row "
                                 "before the lo index is known; the pair "
                                 "row-cache does not apply (cache_size=0)")
            if self.use_pallas == "on" and self.working_set == 2:
                raise ValueError("the fused Pallas kernel implements "
                                 "first-order selection only")
            if self.select_impl != "argminmax":
                raise ValueError("select_impl applies to first-order "
                                 "selection only (WSS2's argmax-over-"
                                 "objective has no packed lowering)")
        # Identity checks, not equality: 1 == True and np.True_ == True
        # would pass a membership test yet skip every 'is True' guard.
        if not (self.shrinking is True or self.shrinking is False
                or self.shrinking == "auto"):
            raise ValueError("shrinking must be True, False or 'auto', "
                             f"got {self.shrinking!r}")
        if self.working_set == 0:
            # The sentinel may resolve to either 2 or q > 2; knobs whose
            # meaning depends on which must be pinned by an explicit
            # working_set.
            if self.inner_iters:
                raise ValueError(
                    "inner_iters requires an explicit working_set > 2 "
                    "(working_set=0 may resolve to the classic pair)")
            if self.use_pallas == "on":
                raise ValueError(
                    "use_pallas='on' pins a specific kernel (fused "
                    "iteration at working_set=2, inner subsolve at "
                    "q > 2); use an explicit working_set with it")
        if self.working_set not in (0, 2):
            if (self.working_set < 4 or self.working_set % 2
                    or self.working_set > 16384):
                raise ValueError("working_set must be 0 (auto), 2 "
                                 "(classic SMO pair) or an even value "
                                 f"in [4, 16384], got {self.working_set}")
            # The JAX guard table, row for row (its row on a field the
            # port does not have, backend, cannot fire).
            for field, bad, what in (
                    ("selection", self.selection != "first-order",
                     "the decomposition subsolve is WSS2 internally"),
                    ("cache_size", self.cache_size > 0,
                     "the block fetch replaces the pair row-cache"),
                    ("use_pallas+shards",
                     self.use_pallas == "on" and self.shards > 1,
                     "the Pallas inner subsolve is single-device today"),
                    ("use_pallas+working_set",
                     self.use_pallas == "on" and self.working_set > 2048,
                     "the inner-subsolve kernel keeps the (q, q) f32 "
                     "block VMEM-resident; q caps at 2048 (16 MB)"),
                    ("select_impl", self.select_impl != "argminmax",
                     "outer selection is top_k, not packed extrema")):
                if bad:
                    raise ValueError(
                        f"working_set > 2 does not support {field}: {what}")
        if self.grow_working_set:
            for field, bad, what in (
                    ("working_set", self.working_set in (0, 2),
                     "growth needs an explicit starting q > 2 "
                     "(working_set=0 may resolve to the classic pair)"),
                    ("use_pallas", self.use_pallas == "on",
                     "the Pallas inner subsolve caps q at 2048, which "
                     "growth would cross")):
                if bad:
                    raise ValueError(
                        f"grow_working_set does not support {field}: "
                        f"{what}")
        if self.shrinking is True:
            # The JAX table, row for row, for the fields the port has
            # ("auto" is exempt: the plan never picks shrinking when one
            # of them is set).
            for field, bad, what in (
                    ("cache_size", self.cache_size > 0,
                     "cached row indices would dangle across "
                     "compactions"),
                    ("use_pallas",
                     self.use_pallas == "on" and self.working_set == 2,
                     "the 2-violator fused kernel hard-codes the "
                     "full-problem init (the decomposition's inner "
                     "kernel composes fine)"),
                    ("checkpoint_path", bool(self.checkpoint_path),
                     "checkpoint/resume does not capture active-set "
                     "state"),
                    ("resume_from", bool(self.resume_from),
                     "checkpoint/resume does not capture active-set "
                     "state")):
                if bad:
                    raise ValueError(
                        f"shrinking does not support {field}: {what}")
        if self.inner_iters < 0:
            raise ValueError(
                f"inner_iters must be >= 0, got {self.inner_iters}")
        if self.inner_iters and self.working_set == 2:
            raise ValueError("inner_iters applies only to working_set > 2")
        if self.use_pallas not in ("auto", "on", "off"):
            raise ValueError(f"use_pallas must be 'auto', 'on' or 'off', "
                             f"got {self.use_pallas!r}")
        if (self.use_pallas == "on" and self.working_set == 2
                and self.fused_incompatibility()):
            raise ValueError("the fused Pallas kernel does not support "
                             f"{self.fused_incompatibility()}; use "
                             "use_pallas='auto' or 'off'")
        if self.matmul_precision not in _PRECISIONS:
            raise ValueError(f"matmul_precision must be one of "
                             f"{_PRECISIONS}, got {self.matmul_precision!r}")


def _shape_class(n: int, d: int) -> str:
    """Problem-shape class of the auto plan (the JAX package's
    boundaries)."""
    if n >= 200_000:
        return "hbm"        # covtype/epsilon-like
    if d >= 512:
        return "highd"      # mnist-like
    if d <= 32:
        return "lowd"       # ijcnn1-like
    return "mid"            # adult-like


# (want_shrink, want_q, want_cap) per shape class: the JAX package's
# table. It resolves to the unshrunk classic pair at every class, which
# are the explicit defaults; a slot changes only on measured evidence.
_PLAN_TABLE = {
    "highd": (False, 2, 0),
    "lowd": (False, 2, 0),
    "mid": (False, 2, 0),
    "hbm": (False, 2, 0),
}


def _auto_solver_plan(n: int, d: int, config: SVMConfig) -> dict:
    """The shape-based choice for the "auto" sentinels: ``_PLAN_TABLE``
    applied without ever choosing a path that a conflicting explicit
    field rules out (auto declines the path instead)."""
    want_shrink, want_q, want_cap = _PLAN_TABLE[_shape_class(n, d)]
    plan = {}
    if config.shrinking == "auto":
        shrink_supported = (config.kernel != "precomputed"
                            and config.cache_size == 0
                            and not config.checkpoint_path
                            and not config.resume_from
                            and not (config.use_pallas == "on"
                                     and config.working_set == 2))
        plan["shrinking"] = bool(want_shrink and shrink_supported)
    if config.working_set == 0:
        decomp_supported = (config.selection == "first-order"
                            and config.cache_size == 0
                            and config.select_impl == "argminmax")
        if want_q > 2 and decomp_supported:
            plan["working_set"] = want_q
            if want_cap and config.inner_iters == 0:
                plan["inner_iters"] = want_cap
        else:
            plan["working_set"] = 2
    return plan


@dataclasses.dataclass
class TrainResult:
    """Outcome of a training run (``svmTrainMain.cpp:313-348``): intercept
    b, iteration count, convergence status, wall time, plus the solver
    state needed to build a model (alpha) and the final optimality gap."""

    alpha: "object"                     # (n,) float array
    b: float
    n_iter: int
    converged: bool
    b_lo: float
    b_hi: float
    train_seconds: float
    gamma: float
    n_sv: int
    kernel: str = "rbf"
    coef0: float = 0.0
    degree: int = 3
    rounds: int = 0                     # decomposition outer rounds (the
                                        # JAX package reports them in its
                                        # run trace)
    cache_hits: int = 0                 # row-cache lookups, two a fetch
    cache_misses: int = 0               # (the JAX run trace's counters)
    learned_epsilon: Optional[float] = None     # nu-SVR only: the tube
                                        # half-width the optimization found
                                        # (LIBSVM -s 4 prints it as
                                        # "epsilon = ...")

    @property
    def gap(self) -> float:
        return self.b_lo - self.b_hi

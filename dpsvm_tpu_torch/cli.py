"""Command-line front end of the port: the ``train`` and ``test``
subcommands of ``dpsvm_tpu/cli.py``, with the same flag names and closing
report, plus ``--device {cuda,cpu}`` (default cuda).

    python -m dpsvm_tpu_torch.cli train -f train.csv -m model.svm -c 10 -g 0.25
    python -m dpsvm_tpu_torch train -f train.csv -m model.svm -c 10 -g 0.25 \
        --working-set 12288 --inner-iters 128      # the decomposition
    python -m dpsvm_tpu_torch train -f train.csv -m model.svm -c 10 \
        -t poly -d 3 -r 1 --selection second-order # the general pair
    python -m dpsvm_tpu_torch train -f train.libsvm -m model.svm -c 10 \
        --shrinking --selection second-order       # LIBSVM's -h 1, WSS2
    python -m dpsvm_tpu_torch train -f train.csv -m model.svm -c 10 \
        --checkpoint state.npz --checkpoint-every 20000
    python -m dpsvm_tpu_torch train -f train.csv -m model.svm -c 10 \
        --resume state.npz                         # after a kill
    python -m dpsvm_tpu_torch train -f train.csv -m model.svm -c 10 \
        -s 10 --clip pairwise                      # the row cache (10 lines)
    python -m dpsvm_tpu_torch train -f train.csv -m model.svm -c 10 -b
                                                   # + model.svm.platt.json
    python -m dpsvm_tpu_torch train -f digits.csv -m mc_dir -c 10 -g 0.25 \
        --multiclass [--batched] [-b | --probability-cv] [--weight 3:2.0]
    python -m dpsvm_tpu_torch train -f train.csv -c 10 -v 5 [--batched]
    python -m dpsvm_tpu_torch train -f train.csv -v 5 \
        --c-sweep 1,10,100 --gamma-sweep 0.125,0.25  # one batched grid
    python -m dpsvm_tpu_torch train -f reg.csv -m model.svr --svr -c 10 \
        -p 0.05 [--working-set 4096 --inner-iters 128]  # epsilon-SVR
    python -m dpsvm_tpu_torch train -f x.csv -m model.oc --one-class --nu 0.1
    python -m dpsvm_tpu_torch train -f train.csv -m model.svm --nu-svc \
        --nu 0.2 [--multiclass]                    # nu-SVC (LIBSVM -s 1)
    python -m dpsvm_tpu_torch train -f reg.csv -m model.svr --nu-svr --nu 0.5
    python -m dpsvm_tpu_torch train -f train.csv -m model.model \
        --model-format libsvm                      # LIBSVM .model text
    python -m dpsvm_tpu_torch train -f train.csv -m model.npz -c 10 \
        --solver approx-rff --approx-dim 1024      # (or approx-nystrom)
    python -m dpsvm_tpu_torch train -f train.csv -m model.svm -c 10 \
        --solver cascade [--screen-margin 0.35 --screen-cap N]
    python -m dpsvm_tpu_torch.cli test  -f test.csv  -m model.svm \
        [--proba p.txt] [--predictions pred.txt] [--no-b]
    python -m dpsvm_tpu_torch test -f test.csv -m mc_dir --proba p.txt
    python -m dpsvm_tpu_torch train -f train.csv -m model.svm -c 10 \
        --shards 4 [--replicate-x]                 # 4 local ranks, a GPU each
    python -m dpsvm_tpu_torch train ... --shards 4 --device cpu  # gloo ranks
    python -m dpsvm_tpu_torch train ... --shards 8 --coordinator host0:29500 \
        --num-hosts 8 --host-id $RANK              # one command a rank
    torchrun --nproc-per-node 4 -m dpsvm_tpu_torch train ... --shards 4

``-f`` takes a dense CSV or a libsvm file (sniffed). With ``-t precomputed`` (LIBSVM -t 4) the training CSV holds the (n, n)
kernel matrix as its rows (``label,K_i1,...,K_in``) and the test CSV the
rows of K(test, train). ``--multiclass`` writes a model directory
(``index.json`` and a model file per pair), which ``test`` reads when
``-m`` names a directory. ``test`` reads every model file the train
command writes, LIBSVM ``.model`` files included, and reports by the
model's task: accuracy (classifiers), MSE/MAE/R^2 (regression) or the
inlier fraction (one-class). The flag conflicts and their messages are
the JAX CLI's. ``--solver approx-*`` writes an approx ``.npz`` model (no
SV set), which ``test`` reads like any other.

Distributed training (``--shards P``, the reference's ``mpirun -np P``):
without ``--coordinator`` and outside ``torchrun`` the command starts P
ranks on this host (``parallel.multihost.launch_local``), a GPU each
under NCCL, or gloo ranks with ``--device cpu``; more NCCL ranks than
GPUs are refused. With ``--coordinator/--num-hosts/--host-id`` (the JAX
CLI's checks and messages) this process is one rank of a group across
hosts; under ``torchrun`` the group comes from its environment. Every
rank reads the dataset and trains; rank 0 alone writes the model file and
prints the report.
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import time
from typing import List, Optional


def _finite_weight(v: str) -> float:
    """Class weights must be finite and > 0, rejected at parse time."""
    try:
        w = float(v)
    except ValueError:
        raise argparse.ArgumentTypeError(f"{v!r} is not a number")
    if not (math.isfinite(w) and w > 0):
        raise argparse.ArgumentTypeError(
            f"class weights must be finite and > 0, got {v}")
    return w


_KERNEL_BY_T = {"0": "linear", "1": "poly", "2": "rbf", "3": "sigmoid",
                "4": "precomputed"}


def _kernel_name(v: str) -> str:
    """Accept LIBSVM -t integers as aliases for the kernel names; reject
    anything else at parse time (before the dataset is loaded)."""
    name = _KERNEL_BY_T.get(v, v)
    if name not in _KERNEL_BY_T.values():
        raise argparse.ArgumentTypeError(
            f"{v!r} is not a kernel (linear | poly | rbf | sigmoid | "
            "precomputed, or LIBSVM -t 0..4)")
    return name


def _shrinking_value(v: str):
    """LIBSVM-style -h values plus the shape-resolved sentinel:
    0/off/false, 1/on/true, auto."""
    lv = v.strip().lower()
    if lv in ("0", "off", "false"):
        return False
    if lv in ("1", "on", "true"):
        return True
    if lv == "auto":
        return "auto"
    raise argparse.ArgumentTypeError(
        f"--shrinking takes 0, 1 or auto, got {v!r}")


def _existing_checkpoint(v: str) -> str:
    """--resume paths are checked at parse time, before the dataset
    load, so a mistyped path is a one-line error."""
    if not os.path.isfile(v):
        raise argparse.ArgumentTypeError(
            f"no such checkpoint file: {v}")
    return v


def _add_common(p: argparse.ArgumentParser, model_help: str,
                model_required: bool = True) -> None:
    p.add_argument("-f", "--input", required=True,
                   help="dataset: dense CSV 'label,f1,...,fd' or libsvm "
                        "'label idx:val ...' (sniffed)")
    p.add_argument("-m", "--model", required=model_required,
                   default=None, help=model_help)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to run (default cuda; cpu runs the plain "
                        "PyTorch versions of the kernels)")


def build_parser() -> argparse.ArgumentParser:
    from dpsvm_tpu_torch.config import SCREEN_MARGIN_DEFAULT

    root = argparse.ArgumentParser(prog="dpsvm_tpu_torch")
    sub = root.add_subparsers(dest="command", required=True)

    tr = sub.add_parser("train", help="train a binary SVM (RBF default)")
    _add_common(tr, "model file to write (a directory with --multiclass; "
                "not needed with --cv)", model_required=False)
    tr.add_argument("-c", "--cost", type=float, default=1.0)
    tr.add_argument("-g", "--gamma", type=float, default=None,
                    help="kernel gamma (default 1/num_attributes)")
    tr.add_argument("-t", "--kernel", default="rbf", type=_kernel_name,
                    help="kernel: linear | poly | rbf | sigmoid | "
                         "precomputed, or the LIBSVM -t integer 0..4 "
                         "(default rbf — the reference's only kernel; "
                         "-t 4 trains on a (n, n) kernel matrix CSV and "
                         "tests on K(test, train) rows)")
    tr.add_argument("-d", "--degree", type=int, default=3,
                    help="poly kernel degree (LIBSVM -d)")
    tr.add_argument("-r", "--coef0", type=float, default=0.0,
                    help="poly/sigmoid coef0 (LIBSVM -r)")
    tr.add_argument("-e", "--epsilon", type=float, default=0.001)
    tr.add_argument("-n", "--max-iter", type=int, default=150_000)
    tr.add_argument("-s", "--cache-size", type=int, default=None,
                    help="kernel-row cache lines (0 = no cache, the "
                         "default): first-order selection on the general "
                         "pair")
    tr.add_argument("--precision", default="highest",
                    choices=["highest", "high", "default"],
                    help="'highest'/'high': X stored float32; 'default': "
                         "X stored bfloat16 (half the bytes per "
                         "iteration); accumulation is float32 always")
    tr.add_argument("--weight-pos", type=_finite_weight, default=1.0,
                    help="cost weight for y=+1 examples (box bound "
                         "C*weight; LIBSVM -w1)")
    tr.add_argument("--weight-neg", type=_finite_weight, default=1.0,
                    help="cost weight for y=-1 examples (LIBSVM -w-1)")
    tr.add_argument("--clip", default=None,
                    choices=["independent", "pairwise"],
                    help="alpha-step clip rule: 'independent' = the "
                         "reference's (both alphas clipped separately; "
                         "the default), 'pairwise' = the textbook/LIBSVM "
                         "joint box")
    tr.add_argument("--weight", action="append", default=[],
                    metavar="LABEL:W",
                    help="per-label cost weight for --multiclass or --cv "
                         "(repeatable; LIBSVM -wi for any label set): "
                         "each OvO pair trains with C*W on that label's "
                         "examples; unlisted labels weigh 1")
    tr.add_argument("--solver", default="exact",
                    choices=["exact", "approx-rff", "approx-nystrom",
                             "cascade"],
                    help="'exact' = the dual SMO/decomposition paths "
                         "(reference parity). 'approx-rff'/'approx-"
                         "nystrom' = explicit feature map + primal "
                         "linear solver: O(n*D) matmul work instead of "
                         "O(n^2) kernel work — the million-row path; "
                         "the model file is a .npz with no support "
                         "vectors. 'cascade' = approx warm-start -> "
                         "margin-band SV screening -> exact dual polish "
                         "on the screened subproblem with KKT "
                         "re-admission repair; writes an ordinary SV "
                         "model")
    tr.add_argument("--screen-margin", type=float,
                    default=SCREEN_MARGIN_DEFAULT, metavar="DELTA",
                    help="cascade stage 2: margin-band safety delta — "
                         "a row survives screening when its approx "
                         "margin y*f(x) <= 1 + DELTA (bigger = safer "
                         "band, bigger exact subproblem; the KKT "
                         "repair loop re-admits anything the band "
                         "missed)")
    tr.add_argument("--screen-cap", type=int, default=0, metavar="N",
                    help="cascade stage 2: hard cap on the screened "
                         "subproblem's rows (0 = uncapped); over-cap "
                         "rows drop best-margin-first")
    tr.add_argument("--approx-dim", type=int, default=1024, metavar="D",
                    help="approx solvers: feature-map dimension "
                         "(accuracy-vs-cost knob; RFF needs it even)")
    tr.add_argument("--approx-seed", type=int, default=0,
                    help="approx solvers: deterministic feature-map "
                         "seed (persisted with the model)")
    tr.add_argument("--selection", default="first-order",
                    choices=["first-order", "second-order"],
                    help="working-set rule: 'first-order' = reference "
                         "parity; 'second-order' = LIBSVM WSS2 (usually "
                         "far fewer iterations)")
    tr.add_argument("--select-impl", default="argminmax",
                    choices=["argminmax", "packed"],
                    help="first-order selection: 'packed' = one min and "
                         "one max over 64-bit (value, index) keys (the "
                         "same answer)")
    tr.add_argument("--working-set", type=int, default=2, metavar="Q",
                    help="violators optimized per kernel fetch: 2 = the "
                         "reference's SMO pair; even Q > 2 = large-"
                         "working-set decomposition (one (Q,d)@(d,n) "
                         "pass per outer round + an inner subsolve)")
    tr.add_argument("--inner-iters", type=int, default=0,
                    help="decomposition inner-step cap per round "
                         "(0 = auto: Q/4; only with --working-set > 2)")
    tr.add_argument("--grow-working-set", action="store_true",
                    help="adaptive decomposition: grow Q when the SV "
                         "count approaches it; start with a modest "
                         "--working-set")
    tr.add_argument("--shrinking", nargs="?", const=True, default=False,
                    type=_shrinking_value, metavar="{0,1,auto}",
                    help="LIBSVM -h analog: active-set training — "
                         "periodically drop rows that are provably "
                         "stuck at their bound, validate on the full "
                         "problem at the end. Bare flag = on; "
                         "'--shrinking 0' forces off")
    tr.add_argument("--shards", type=int, default=1,
                    help="ranks along the data axis, one process a device "
                         "(replaces mpirun -np)")
    tr.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                    help="multi-host training: join a process group "
                         "through this coordinator (tcp://) — one "
                         "command per rank, same flags plus "
                         "--num-hosts/--host-id")
    tr.add_argument("--num-hosts", type=int, default=None, metavar="N",
                    help="process count of the multi-host group "
                         "(requires --coordinator)")
    tr.add_argument("--host-id", type=int, default=None, metavar="K",
                    help="this process's rank, 0..N-1 (requires "
                         "--coordinator)")
    tr.add_argument("--replicate-x", action="store_true",
                    help="replicate X on every shard (reference layout)")
    tr.add_argument("--checkpoint", default=None,
                    help="solver-state .npz path for periodic checkpoints")
    tr.add_argument("--checkpoint-every", type=int, default=0,
                    help="iterations between checkpoints (0 = off)")
    tr.add_argument("--checkpoint-keep", type=int, default=2,
                    metavar="N",
                    help="rotation slots kept (state.npz, state.1.npz, "
                         "...): a corrupt newest file still leaves an "
                         "intact older state to resume; 1 = no rotation")
    tr.add_argument("--resume", default=None, type=_existing_checkpoint,
                    help="resume training from a checkpoint file "
                         "(checked at parse time; a corrupt file falls "
                         "back to its newest intact rotation slot)")
    tr.add_argument("-v", "--cv", type=int, default=0, metavar="K",
                    help="k-fold cross-validation mode (LIBSVM -v): "
                         "report pooled held-out accuracy (or MSE for "
                         "--svr) instead of writing a model")
    tr.add_argument("--one-class", action="store_true",
                    help="one-class SVM / novelty detection on unlabeled "
                         "rows (LIBSVM svm-train -s 2 analog; the label "
                         "column is ignored)")
    tr.add_argument("--nu", type=float, default=0.5,
                    help="one-class outlier-fraction bound (LIBSVM -n)")
    tr.add_argument("--nu-svc", action="store_true",
                    help="nu-SVC (LIBSVM -s 1): --nu replaces -c; nu "
                         "lower-bounds the SV fraction and upper-bounds "
                         "the margin-error fraction")
    tr.add_argument("--nu-svr", action="store_true",
                    help="nu-SVR (LIBSVM -s 4): the epsilon tube width "
                         "is learned; --nu bounds the outside-tube "
                         "fraction, -c is the usual cost")
    tr.add_argument("--svr", action="store_true",
                    help="epsilon-SVR regression (float targets; LIBSVM "
                         "svm-train -s 3 analog)")
    tr.add_argument("-p", "--svr-epsilon", type=float, default=0.1,
                    help="SVR tube half-width (LIBSVM -p, default 0.1)")
    tr.add_argument("--model-format", default="reference",
                    choices=["reference", "libsvm"],
                    help="model file layout: 'reference' (the MPI "
                         "trainer's CSV-ish format) or 'libsvm' "
                         "(svm-train .model text, readable by LIBSVM/"
                         "sklearn tooling); the test command "
                         "auto-detects either format")
    tr.add_argument("--multiclass", action="store_true",
                    help="one-vs-one multi-class training (labels may be "
                         "any integers; -m becomes a model DIRECTORY)")
    tr.add_argument("--c-sweep", default=None, metavar="C1,C2,...",
                    help="with --cv: CV accuracy at every C of the comma "
                         "list in ONE batched program (all folds x all C "
                         "points; binary classification only) and the "
                         "best C")
    tr.add_argument("--gamma-sweep", default=None, metavar="G1,G2,...",
                    help="with --cv --c-sweep: the full C x gamma grid, "
                         "still one batched program")
    tr.add_argument("--batched", action="store_true",
                    help="train independent subproblems in ONE batched "
                         "program: all one-vs-one pairs with "
                         "--multiclass, all folds with --cv (folds x "
                         "pairs for multiclass CV); plain first-order "
                         "single-device path only")
    tr.add_argument("-b", "--probability", action="store_true",
                    help="LIBSVM -b 1 analog: Platt-scaled probabilities "
                         "fit on the training decision values — a "
                         "<model>.platt.json sidecar for binary models; "
                         "per-pair sigmoids in index.json with "
                         "--multiclass")
    tr.add_argument("--probability-cv", action="store_true",
                    help="like -b, but fit the sigmoid on 5-fold "
                         "held-out decision values (LIBSVM's -b 1 "
                         "procedure; 5 extra trainings)")
    tr.add_argument("-q", "--quiet", action="store_true")

    te = sub.add_parser("test", help="evaluate a saved model on a dataset")
    _add_common(te, "model file (or --multiclass model directory) to read")
    te.add_argument("--no-b", action="store_true",
                    help="drop the intercept like seq_test.cpp:197")
    te.add_argument("--predictions", default=None, metavar="PATH",
                    help="also write one predicted label per line "
                         "(binary models: 'label,decision_value')")
    te.add_argument("--proba", default=None, metavar="PATH",
                    help="binary model: write Platt-calibrated P(y=+1|x) "
                         "per line + Brier/log-loss (needs the "
                         "<model>.platt.json sidecar). Multiclass model "
                         "dir: per-class probabilities (pairwise "
                         "coupling) + log-loss, predicting by the coupled "
                         "argmax. Both need train --probability")
    return root


def _train_conflicts(args: argparse.Namespace):
    """(error message or None, class_weight) from the flags alone, before
    the dataset is parsed: the JAX CLI's rules and messages for the flags
    the port has. Its rows on flags the port does not have (``--pallas``,
    ``--polish``, ``--check-kkt``, ``--trace-out``) drop out."""
    if args.model_format == "libsvm" and args.multiclass:
        return ("--model-format libsvm applies to binary models; "
                "--multiclass writes a directory of reference-format "
                "per-pair files"), None
    if args.gamma_sweep is not None and args.c_sweep is None:
        return "--gamma-sweep extends --c-sweep (pass both)", None
    if args.solver != "exact":
        # The cascade's outputs are ordinary SV models, so --model-format
        # libsvm stays valid there; the batched programs stay
        # dual-solver-only.
        approx = args.solver.startswith("approx")
        for flag, on, hint in (
                ("--c-sweep", args.c_sweep is not None,
                 " (the batched sweep is a dual-solver program)"),
                ("--batched", args.batched,
                 " (the batched program solves the dual iteration)"),
                ("--model-format libsvm",
                 approx and args.model_format == "libsvm",
                 " (approx models persist as .npz — no SV lines to "
                 "write; --solver cascade writes ordinary SV models)")):
            if on:
                return (f"{flag} does not apply to --solver "
                        f"{args.solver}{hint}"), None
    if args.c_sweep is not None and not args.cv:
        return ("--c-sweep requires --cv K (it selects C by "
                "cross-validated accuracy)"), None
    if args.c_sweep is not None and (args.svr or args.multiclass):
        return "--c-sweep is binary-classification-only", None
    if args.batched and not (args.multiclass or args.cv):
        return "--batched applies to --multiclass or --cv training", None
    if args.batched and args.svr:
        return ("batched CV is classification-only (SVR folds train on "
                "per-fold pseudo-examples)"), None
    if args.multiclass:
        if args.model and os.path.isfile(args.model):
            return (f"-m {args.model} is an existing file; --multiclass "
                    "writes a model DIRECTORY"), None
        if args.checkpoint or args.resume:
            return ("--checkpoint/--resume are single-model flags; they "
                    "cannot be shared across the pairwise multiclass "
                    "subproblems"), None
        if args.weight_pos != 1.0 or args.weight_neg != 1.0:
            # '+1' is just the lower-sorted label of each pair
            return ("--weight-pos/--weight-neg are binary-problem flags; "
                    "weight multiclass classes by LABEL with "
                    "--weight LABEL:W instead"), None
        if args.weight and args.batched:
            return ("--weight needs per-pair box bounds; the batched "
                    "program shares one weight pair across all "
                    "subproblems — drop --batched"), None
        if args.weight and args.clip == "independent":
            return ("--weight trains each pair with the joint (pairwise) "
                    "alpha update — LIBSVM -wi semantics; the independent "
                    "clip drifts sum(alpha*y) at asymmetric bounds. Drop "
                    "--clip independent"), None
    elif args.weight and not args.cv:
        return ("--weight maps costs by class LABEL and applies to "
                "--multiclass or --cv training; use "
                "--weight-pos/--weight-neg for a plain binary problem"), None
    elif args.weight:
        if args.batched:
            return ("--weight needs per-pair box bounds; the batched "
                    "program shares one weight pair across all "
                    "subproblems — drop --batched"), None
        if args.svr:
            return ("--weight is classification-only (SVR has no "
                    "classes)"), None
        if args.c_sweep is not None:
            return ("--weight is not supported with --c-sweep (the "
                    "batched grid program shares one weight pair)"), None
        if args.clip == "independent":
            return ("--weight trains with the joint (pairwise) alpha "
                    "update — LIBSVM -wi semantics; drop "
                    "--clip independent"), None
    class_weight = None
    if args.weight:
        class_weight = {}
        for spec in args.weight:
            label, sep, w = spec.partition(":")
            try:
                if not sep:
                    raise ValueError
                key = int(label) if "." not in label else float(label)
                wv = float(w)
            except ValueError:
                return (f"--weight {spec!r} is not LABEL:W "
                        "(e.g. --weight 3:5.0)"), None
            if not (math.isfinite(wv) and wv > 0):
                return (f"--weight {spec!r}: weights must be finite "
                        "and > 0"), None
            class_weight[key] = wv
    if not args.cv and not args.model:
        return ("-m/--model is required (or pass --cv K for "
                "cross-validation)"), None
    if args.cv:
        if args.cv < 2:
            return f"--cv needs K >= 2, got {args.cv}", None
        for flag, on, hint in (
                ("--one-class", args.one_class, ""),
                ("--probability-cv" if args.probability_cv
                 else "--probability",
                 args.probability or args.probability_cv, ""),
                ("--multiclass", args.multiclass,
                 " (CV dispatches to one-vs-one automatically when the "
                 "labels have more than two classes)"),
                ("--checkpoint/--resume",
                 bool(args.checkpoint or args.resume), "")):
            if on:
                return f"{flag} does not apply to --cv mode{hint}", None
    modes = [f for f, on in (("--svr", args.svr),
                             ("--one-class", args.one_class),
                             ("--nu-svc", args.nu_svc),
                             ("--nu-svr", args.nu_svr)) if on]
    if len(modes) > 1:
        return f"{' and '.join(modes)} are mutually exclusive", None
    if modes:
        # One conflict table for every restricted mode.
        mode = modes[0]
        nu_mode = mode in ("--nu-svc", "--nu-svr")
        # nu-SVC composes with --multiclass (LIBSVM -s 1 is OvO for >2
        # classes) and there with --probability (sigmoid on training
        # decisions); --probability-cv stays refused (its held-out
        # refits are C-SVC)
        nu_multiclass = args.multiclass and mode == "--nu-svc"
        conflicts = [("--multiclass",
                      args.multiclass and mode != "--nu-svc"),
                     # approx SVC/SVR are the supported primal tasks (the
                     # cascade's band is a classification-margin rule)
                     (f"--solver {args.solver}",
                      args.solver != "exact"
                      and (mode != "--svr" or args.solver == "cascade")),
                     ("--probability-cv" if args.probability_cv
                      else "--probability",
                      (args.probability_cv or
                       (args.probability and not nu_multiclass))),
                     ("--weight-pos/--weight-neg",
                      args.weight_pos != 1.0 or args.weight_neg != 1.0),
                     # these modes' duals live on an equality
                     # constraint whose VALUE is part of the model;
                     # they force the conserving pairwise rule
                     ("--clip independent", args.clip == "independent")]
        if nu_mode:
            conflicts += [("--cv", bool(args.cv)),
                          ("--checkpoint/--resume",
                           bool(args.checkpoint or args.resume))]
        for flag, on in conflicts:
            if on:
                return f"{flag} does not apply to {mode}", None
    return None, class_weight


def cmd_train(args: argparse.Namespace) -> int:
    import numpy as np

    from dpsvm_tpu_torch.api import fit
    from dpsvm_tpu_torch.config import SVMConfig
    from dpsvm_tpu_torch.data.loader import load_dataset
    from dpsvm_tpu_torch.models.io import save_model
    from dpsvm_tpu_torch.models.svm import evaluate

    err, class_weight = _train_conflicts(args)
    if err is not None:
        print(f"error: {err}", file=sys.stderr)
        return 2
    if args.model_format == "libsvm":
        from dpsvm_tpu_torch.models.libsvm_io import save_libsvm_model
        save_model = save_libsvm_model
    x, y = load_dataset(args.input, float_labels=(
        args.svr or args.one_class or args.nu_svr))
    config = SVMConfig(c=args.cost, gamma=args.gamma, kernel=args.kernel,
                       degree=args.degree, coef0=args.coef0,
                       epsilon=args.epsilon, svr_epsilon=args.svr_epsilon,
                       max_iter=args.max_iter,
                       cache_size=args.cache_size or 0,
                       selection=args.selection,
                       select_impl=args.select_impl,
                       working_set=args.working_set,
                       inner_iters=args.inner_iters,
                       grow_working_set=args.grow_working_set,
                       weight_pos=args.weight_pos,
                       weight_neg=args.weight_neg,
                       clip=args.clip or "independent",
                       matmul_precision=args.precision,
                       shrinking=args.shrinking,
                       checkpoint_path=args.checkpoint,
                       checkpoint_every=args.checkpoint_every,
                       checkpoint_keep=args.checkpoint_keep,
                       resume_from=args.resume,
                       shards=args.shards, shard_x=not args.replicate_x,
                       solver=args.solver, approx_dim=args.approx_dim,
                       approx_seed=args.approx_seed,
                       screen_margin=args.screen_margin,
                       screen_cap=args.screen_cap,
                       verbose=not args.quiet)
    dev = args.device
    if args.multiclass:
        from dpsvm_tpu_torch.models.multiclass import (evaluate_multiclass,
                                                       save_multiclass,
                                                       train_multiclass)
        proba_mode = "cv" if args.probability_cv else args.probability
        mc, results = train_multiclass(x, y, config, probability=proba_mode,
                                       batched=args.batched,
                                       class_weight=class_weight,
                                       nu=args.nu if args.nu_svc else None,
                                       device=dev)
        save_multiclass(mc, args.model)
        acc = evaluate_multiclass(mc, x, y, device=dev)
        if proba_mode:
            print(f"Platt calibration: {len(mc.models)} per-pair sigmoids"
                  + (" (5-fold held-out fit)" if proba_mode == "cv" else "")
                  + " (pairwise-coupled at test time; LIBSVM -b)")
        print(f"Classes: {[int(c) for c in mc.classes]} "
              f"({len(mc.models)} pairwise models)")
        print(f"Training iterations: {sum(r.n_iter for r in results)} total"
              + ("" if all(r.converged for r in results)
                 else " (some pairs NOT converged)"))
        print(f"Training accuracy: {acc:.6f}")
        print(f"Training time: "
              f"{sum(r.train_seconds for r in results):.3f} s")
        return 0
    if args.cv:
        return _train_cv(args, x, y, config, class_weight)
    if args.nu_svc or args.nu_svr or args.one_class or args.svr:
        return _train_task(args, x, y, config, save_model)

    model, result = fit(x, y, config, device=dev)
    n_sv = save_model(model, args.model)
    acc = evaluate(model, x, y, device=dev)
    # Same closing report the reference prints (svmTrainMain.cpp:313-336).
    if getattr(model, "is_approx", False):
        print(f"Approx model: {model.model_kind} dim={model.fmap.dim} "
              "(no SV set)")
    else:
        print(f"Number of SVs: {n_sv}")
    if hasattr(result, "n_kept"):
        print(f"Cascade: screened {result.n_total} -> {result.n_kept} "
              f"rows ({result.readmit_rounds} polish round(s), "
              f"{result.n_readmitted} re-admitted, "
              f"{result.kkt_violators} KKT violator(s))")
    print(f"b: {result.b:.6f}")
    print(f"Training iterations: {result.n_iter}"
          + ("" if result.converged else " (max-iter reached, NOT converged)"))
    print(f"Training accuracy: {acc:.6f}")
    print(f"Training time: {result.train_seconds:.3f} s")
    if args.probability or args.probability_cv:
        from dpsvm_tpu_torch.models.calibration import (fit_platt,
                                                        fit_platt_cv,
                                                        save_platt)
        from dpsvm_tpu_torch.models.svm import decision_function
        if args.probability_cv:
            pa, pb = fit_platt_cv(x, y, config, device=dev)
        else:
            pa, pb = fit_platt(np.asarray(decision_function(
                model, x, device=dev)), y)
        save_platt(args.model, pa, pb)
        print(f"Platt calibration: A={pa:.6f} B={pb:.6f} "
              f"(saved {args.model}.platt.json)")
    return 0


def _train_task(args, x, y, config, save_model) -> int:
    """``train --nu-svc | --nu-svr | --one-class | --svr``: fit, write the
    model and print the JAX CLI's report for the task."""
    import numpy as np

    dev = args.device
    if args.nu_svc:
        from dpsvm_tpu_torch.models.nusvm import train_nusvc
        from dpsvm_tpu_torch.models.svm import evaluate
        model, result = train_nusvc(x, np.asarray(y, np.int32), args.nu,
                                    config, device=dev)
        n_sv = save_model(model, args.model)
        print(f"Number of SVs: {n_sv}")
        print(f"b: {result.b:.6f}")
        print(f"Training iterations: {result.n_iter}"
              + ("" if result.converged else " (NOT converged)"))
        print(f"Training accuracy: {evaluate(model, x, y, device=dev):.6f} "
              f"(nu = {args.nu})")
        print(f"Training time: {result.train_seconds:.3f} s")
        return 0
    if args.nu_svr:
        from dpsvm_tpu_torch.models.nusvm import train_nusvr
        from dpsvm_tpu_torch.models.svr import evaluate_svr
        model, result = train_nusvr(x, y, args.nu, config, device=dev)
        n_sv = save_model(model, args.model)
        m = evaluate_svr(model, x, y, device=dev)
        print(f"Number of SVs: {n_sv}")
        print(f"b: {result.b:.6f}")
        print(f"epsilon: {result.learned_epsilon:.6f}")   # learned tube
        print(f"Training iterations: {result.n_iter}"
              + ("" if result.converged else " (NOT converged)"))
        print(f"Training MSE: {m['mse']:.6f}  R^2: {m['r2']:.6f} "
              f"(nu = {args.nu})")
        print(f"Training time: {result.train_seconds:.3f} s")
        return 0
    if args.one_class:
        from dpsvm_tpu_torch.models.oneclass import (predict_oneclass,
                                                     train_oneclass)
        model, result = train_oneclass(x, args.nu, config, device=dev)
        n_sv = save_model(model, args.model)
        inlier = predict_oneclass(model, x, device=dev)
        print(f"Number of SVs: {n_sv}")
        print(f"rho: {result.b:.6f}")
        print(f"Training iterations: {result.n_iter}"
              + ("" if result.converged else " (NOT converged)"))
        print(f"Training inlier fraction: {float(np.mean(inlier > 0)):.6f} "
              f"(nu = {args.nu})")
        print(f"Training time: {result.train_seconds:.3f} s")
        return 0
    from dpsvm_tpu_torch.models.svr import evaluate_svr, train_svr
    model, result = train_svr(x, y, config, device=dev)
    approx = getattr(model, "is_approx", False)
    if model.n_sv == 0 and not approx:
        print("error: the fitted tube contains every target "
              f"(svr_epsilon={config.svr_epsilon}) — the model has no "
              "support vectors and predicts the constant "
              f"{-result.b:.6g}; decrease -p", file=sys.stderr)
        return 1
    n_sv = save_model(model, args.model)
    m = evaluate_svr(model, x, y, device=dev)
    if approx:
        print(f"Approx model: {model.model_kind} dim={model.fmap.dim} "
              "(no SV set)")
    else:
        print(f"Number of SVs: {n_sv}")
    print(f"b: {result.b:.6f}")
    print(f"Training iterations: {result.n_iter}"
          + ("" if result.converged else " (NOT converged)"))
    print(f"Training MSE: {m['mse']:.6f}  MAE: {m['mae']:.6f}  "
          f"R^2: {m['r2']:.6f}")
    print(f"Training time: {result.train_seconds:.3f} s")
    return 0


def _train_cv(args, x, y, config, class_weight) -> int:
    """``train --cv K``: pooled held-out accuracy (LIBSVM's -v), or the
    batched C (x gamma) sweep of it."""
    from dpsvm_tpu_torch.models.cv import (cross_validate,
                                           cross_validate_c_sweep)
    if args.c_sweep is not None:
        try:
            cs = [float(t) for t in args.c_sweep.split(",") if t]
            gs = ([float(t) for t in args.gamma_sweep.split(",") if t]
                  if args.gamma_sweep is not None else None)
        except ValueError:
            print("error: --c-sweep/--gamma-sweep need comma lists of "
                  "numbers", file=sys.stderr)
            return 2
        r = cross_validate_c_sweep(x, y, args.cv, cs, config, gammas=gs,
                                   device=args.device)
        if gs is None:
            for c, a in zip(r["cs"], r["accuracies"]):
                print(f"C={c:g}: Cross Validation Accuracy = "
                      f"{a * 100:.4f}%")
            print(f"Best: C={r['best_c']:g} "
                  f"({r['best_accuracy'] * 100:.4f}%)")
            return 0
        for i, c in enumerate(r["cs"]):
            for j, g in enumerate(r["gammas"]):
                print(f"C={c:g} gamma={g:g}: Cross Validation Accuracy = "
                      f"{r['accuracies'][i, j] * 100:.4f}%")
        print(f"Best: C={r['best_c']:g} gamma={r['best_gamma']:g} "
              f"({r['best_accuracy'] * 100:.4f}%)")
        return 0
    r = cross_validate(x, y, args.cv, config,
                       task="svr" if args.svr else "svc",
                       batched=args.batched, class_weight=class_weight,
                       device=args.device)
    if args.svr:
        print(f"Cross Validation ({args.cv}-fold) MSE: {r['mse']:.6f}  "
              f"MAE: {r['mae']:.6f}  R^2: {r['r2']:.6f}")
    else:
        # LIBSVM's svm-train -v output shape
        print(f"Cross Validation Accuracy = {r['accuracy'] * 100:.4f}%")
    return 0


def _test_multiclass(args: argparse.Namespace) -> int:
    """``test`` on a --multiclass model directory: the OvO vote (or, with
    --proba, the coupled argmax of LIBSVM -b 1), one shared pass for the
    P pairwise decisions."""
    import numpy as np

    from dpsvm_tpu_torch.data.loader import load_dataset
    from dpsvm_tpu_torch.models.multiclass import (load_multiclass,
                                                   pairwise_decisions,
                                                   predict_multiclass,
                                                   predict_proba_multiclass)
    mc = load_multiclass(args.model)
    if args.proba and mc.platt is None:
        print("error: this multiclass model was trained without "
              "calibration — train with --multiclass --probability",
              file=sys.stderr)
        return 2
    d_model = mc.models[0].num_attributes
    x, y = load_dataset(args.input)
    if x.shape[1] != d_model:
        print(f"error: dataset has {x.shape[1]} attributes, model has "
              f"{d_model}", file=sys.stderr)
        return 2
    decisions = pairwise_decisions(mc, x, include_b=not args.no_b,
                                   device=args.device)
    proba = None
    if args.proba:
        # the sigmoids were fit on intercept-included decisions
        dec_b = ([d - np.float32(m.b) for d, m in zip(decisions, mc.models)]
                 if args.no_b else decisions)
        proba = predict_proba_multiclass(mc, x, decisions=dec_b)
        if args.no_b:
            pred = predict_multiclass(mc, x, include_b=False,
                                      decisions=decisions)
        else:
            # LIBSVM -b 1 predicts by the coupled argmax
            pred = mc.classes[np.argmax(proba, axis=1)]
    else:
        pred = predict_multiclass(mc, x, include_b=not args.no_b,
                                  decisions=decisions)
    acc = float(np.mean(pred == y))
    if args.predictions:
        with open(args.predictions, "w") as f:
            f.writelines(f"{int(p)}\n" for p in pred)
    print(f"Classes: {[int(c) for c in mc.classes]}")
    print(f"Test accuracy: {acc:.6f}")
    if proba is not None:
        with open(args.proba, "w") as f:
            f.writelines(",".join(f"{v:.6g}" for v in row) + "\n"
                         for row in proba)
        cls_index = {int(c): i for i, c in enumerate(mc.classes)}
        truth = np.asarray([cls_index.get(int(v), -1) for v in y])
        known = truth >= 0
        if known.any():
            pc = np.clip(proba[np.flatnonzero(known), truth[known]], 1e-12,
                         None)
            print(f"Log-loss: {float(-np.mean(np.log(pc))):.6f} "
                  f"({int(known.sum())} examples)")
        else:
            print("Log-loss: n/a (no test label matches a training class)")
    return 0


def _reconcile_width(args, model, x):
    """(model, x) at one width, or (None, x) after printing the error.
    Both sparse formats mean "absent index == zero", so the narrower side
    widens with zero columns: a libsvm test file may undershoot the
    model, and a LIBSVM ``.model`` file the data when trailing columns are
    zero in every SV. A dense CSV carries its true width, so a mismatch
    there (or wider data against a reference-format model) is an error."""
    import dataclasses

    import numpy as np

    from dpsvm_tpu_torch.data.loader import sniff_format
    from dpsvm_tpu_torch.models.io import is_libsvm_model
    width = model.num_attributes
    if x.shape[1] < width and sniff_format(args.input) == "libsvm":
        return model, np.pad(x, ((0, 0), (0, width - x.shape[1])))
    if (x.shape[1] > width and not getattr(model, "is_approx", False)
            and is_libsvm_model(args.model)):
        if model.kernel == "precomputed":
            # LIBSVM stores no n_train; serials only bound it from below
            return dataclasses.replace(model, n_train=x.shape[1],
                                       n_train_exact=True), x
        return dataclasses.replace(model, x_sv=np.pad(
            model.x_sv, ((0, 0), (0, x.shape[1] - width)))), x
    print(f"error: dataset has {x.shape[1]} attributes, model has "
          f"{width}", file=sys.stderr)
    return None, x


def _test_task(args, model, x, y) -> int:
    """``test`` on a one-class model (the inlier fraction, and accuracy
    against +1/-1 labels) or a regression model (MSE/MAE/R^2)."""
    import numpy as np

    if args.proba:
        print("error: --proba applies to classifiers only",
              file=sys.stderr)
        return 2
    if model.task == "oneclass":
        from dpsvm_tpu_torch.models.oneclass import predict_oneclass
        # one-class decisions always include rho: --no-b does not apply
        pred = predict_oneclass(model, x, device=args.device)
        if args.predictions:
            with open(args.predictions, "w") as f:
                f.writelines(f"{int(v)}\n" for v in pred)
        print(f"Number of SVs: {model.n_sv}")
        print(f"Inlier fraction: {float(np.mean(pred > 0)):.6f}")
        labs = np.asarray(y)
        if set(np.unique(labs.astype(np.int64))) <= {-1, 1}:
            acc = float(np.mean(pred == labs.astype(np.int32)))
            print(f"Test accuracy (+1 inlier / -1 outlier labels): "
                  f"{acc:.6f}")
        return 0
    from dpsvm_tpu_torch.models.svr import predict_svr, regression_metrics
    pred = predict_svr(model, x, include_b=not args.no_b,
                       device=args.device)
    if args.predictions:
        with open(args.predictions, "w") as f:
            f.writelines(f"{float(v):.9g}\n" for v in pred)
    m = regression_metrics(pred, y)
    print(f"Number of SVs: {model.n_sv}")
    print(f"Test MSE: {m['mse']:.6f}  MAE: {m['mae']:.6f}  "
          f"R^2: {m['r2']:.6f}")
    return 0


def cmd_test(args: argparse.Namespace) -> int:
    import numpy as np

    from dpsvm_tpu_torch.data.loader import load_dataset
    from dpsvm_tpu_torch.models.io import load_model
    from dpsvm_tpu_torch.models.svm import decision_function

    if os.path.isdir(args.model):
        return _test_multiclass(args)
    model = load_model(args.model)
    x, y = load_dataset(args.input, float_labels=model.task == "svr")
    if x.shape[1] != model.num_attributes:
        model, x = _reconcile_width(args, model, x)
        if model is None:
            return 2
    if model.task != "svc":
        return _test_task(args, model, x, y)
    t_eval = time.perf_counter()
    dec = decision_function(model, x, include_b=not args.no_b,
                            device=args.device)
    t_eval = time.perf_counter() - t_eval
    pred = np.where(dec < 0, -1, 1)                    # svmTrain.cu:650-656
    acc = float(np.mean(pred == np.asarray(y, np.int32)))
    if args.predictions:
        with open(args.predictions, "w") as f:
            f.writelines(f"{int(p)},{v:.6g}\n" for p, v in zip(pred, dec))
    print(f"Number of SVs: {model.n_sv}")
    print(f"Test accuracy: {acc:.6f}")
    print(f"Evaluation time: {t_eval:.3f} s "
          f"({len(pred)} examples, {len(pred) / t_eval:,.0f} ex/s)")
    if args.proba:
        from dpsvm_tpu_torch.models.calibration import (load_platt,
                                                        sigmoid_proba)
        try:
            pa, pb = load_platt(args.model)
        except FileNotFoundError:
            print(f"error: no Platt sidecar {args.model}.platt.json — "
                  "train with --probability first", file=sys.stderr)
            return 2
        # the sigmoid was fit on intercept-included decision values
        dec_b = (np.asarray(dec) - np.float32(model.b)
                 if args.no_b else dec)
        proba = sigmoid_proba(dec_b, pa, pb)
        with open(args.proba, "w") as f:
            f.writelines(f"{p:.6g}\n" for p in proba)
        t = (np.asarray(y) > 0).astype(np.float64)
        brier = float(np.mean((proba - t) ** 2))
        pc = np.clip(proba, 1e-12, 1.0 - 1e-12)
        logloss = float(-np.mean(t * np.log(pc) + (1 - t) * np.log(1 - pc)))
        print(f"Brier score: {brier:.6f}")
        print(f"Log-loss: {logloss:.6f}")
    return 0


def _host_flag_error(args) -> Optional[str]:
    """The JAX CLI's checks of the multi-host flags."""
    coord = args.coordinator
    if not coord and (args.num_hosts is not None
                      or args.host_id is not None):
        return ("--num-hosts/--host-id require --coordinator "
                "(docs/DISTRIBUTED.md 'Multi-host')")
    if coord:
        nh, hid = args.num_hosts, args.host_id
        if (nh is None) != (hid is None):
            return "--num-hosts and --host-id must be given together"
        if nh is not None and not 0 <= hid < nh:
            return f"--host-id {hid} out of range for --num-hosts {nh}"
    return None


def _as_rank(args, rank: int, scratch: str) -> None:
    """Rank 0 alone writes the model file and prints the report: every
    other rank writes into a scratch directory and prints nothing."""
    if rank != 0:
        sys.stdout = open(os.devnull, "w")
        if args.model:
            args.model = os.path.join(scratch,
                                      os.path.basename(args.model) or "m")


def _train_rank(rank: int, argv: List[str]) -> int:
    """One rank of ``train --shards P`` started by ``launch_local``."""
    import tempfile
    args = build_parser().parse_args(argv)
    with tempfile.TemporaryDirectory() as scratch:
        _as_rank(args, rank, scratch)
        return _run(args)


def _train_distributed(args, argv: List[str]) -> Optional[int]:
    """Join or start the process group of ``train --shards P``; returns
    the exit code when this process only launched the ranks, else None
    (this process is a rank: train here)."""
    from dpsvm_tpu_torch.parallel import multihost
    err = _host_flag_error(args)
    if err:
        print(f"error: {err}", file=sys.stderr)
        return 2
    if args.coordinator:
        if args.num_hosts is None:
            host, _, port = args.coordinator.rpartition(":")
            os.environ.setdefault("MASTER_ADDR", host or "127.0.0.1")
            os.environ.setdefault("MASTER_PORT", port)
            multihost.initialize(device=args.device)
        else:
            multihost.initialize(args.coordinator, args.num_hosts,
                                 args.host_id, device=args.device)
    elif args.shards > 1 and not multihost.is_initialized():
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            multihost.initialize(device=args.device)      # torchrun
        else:
            rcs = multihost.launch_local(args.shards, _train_rank, (argv,),
                                         device=args.device)
            return max(rcs)
    return None


def _run(args) -> int:
    from dpsvm_tpu_torch.solver.driver import DivergenceError
    try:
        if args.command == "train":
            return cmd_train(args)
        return cmd_test(args)
    except DivergenceError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    except FileNotFoundError as e:
        print(f"error: file not found: {e}", file=sys.stderr)
        return 2
    except (ValueError, NotImplementedError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    if args.command == "train" and (args.shards > 1 or args.coordinator
                                    or args.num_hosts is not None
                                    or args.host_id is not None):
        try:
            rc = _train_distributed(args, argv)
        except (ValueError, RuntimeError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        if rc is not None:
            return rc
        from dpsvm_tpu_torch.parallel import multihost
        import tempfile
        with tempfile.TemporaryDirectory() as scratch:
            _as_rank(args, multihost.host_id(), scratch)
            return _run(args)
    return _run(args)


if __name__ == "__main__":
    sys.exit(main())

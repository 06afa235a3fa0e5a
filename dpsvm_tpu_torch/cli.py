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
    python -m dpsvm_tpu_torch.cli test  -f test.csv  -m model.svm \
        [--proba p.txt] [--predictions pred.txt] [--no-b]
    python -m dpsvm_tpu_torch test -f test.csv -m mc_dir --proba p.txt

``-f`` takes a dense CSV or a libsvm file (sniffed). With ``-t precomputed`` (LIBSVM -t 4) the training CSV holds the (n, n)
kernel matrix as its rows (``label,K_i1,...,K_in``) and the test CSV the
rows of K(test, train). ``--multiclass`` writes a model directory
(``index.json`` and a model file per pair), which ``test`` reads when
``-m`` names a directory. The flag conflicts and their messages are the
JAX CLI's.
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
                         "report pooled held-out accuracy instead of "
                         "writing a model")
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
    the port has."""
    if args.gamma_sweep is not None and args.c_sweep is None:
        return "--gamma-sweep extends --c-sweep (pass both)", None
    if args.c_sweep is not None and not args.cv:
        return ("--c-sweep requires --cv K (it selects C by "
                "cross-validated accuracy)"), None
    if args.c_sweep is not None and args.multiclass:
        return "--c-sweep is binary-classification-only", None
    if args.batched and not (args.multiclass or args.cv):
        return "--batched applies to --multiclass or --cv training", None
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
    x, y = load_dataset(args.input)
    config = SVMConfig(c=args.cost, gamma=args.gamma, kernel=args.kernel,
                       degree=args.degree, coef0=args.coef0,
                       epsilon=args.epsilon, max_iter=args.max_iter,
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

    model, result = fit(x, y, config, device=dev)
    n_sv = save_model(model, args.model)
    acc = evaluate(model, x, y, device=dev)
    # Same closing report the reference prints (svmTrainMain.cpp:313-336).
    print(f"Number of SVs: {n_sv}")
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
    r = cross_validate(x, y, args.cv, config, batched=args.batched,
                       class_weight=class_weight, device=args.device)
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


def cmd_test(args: argparse.Namespace) -> int:
    import numpy as np

    from dpsvm_tpu_torch.data.loader import load_dataset
    from dpsvm_tpu_torch.models.io import load_model
    from dpsvm_tpu_torch.models.svm import decision_function

    if os.path.isdir(args.model):
        return _test_multiclass(args)
    model = load_model(args.model)
    x, y = load_dataset(args.input)
    if x.shape[1] != model.num_attributes:
        print(f"error: dataset has {x.shape[1]} attributes, model has "
              f"{model.num_attributes}", file=sys.stderr)
        return 2
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


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
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


if __name__ == "__main__":
    sys.exit(main())

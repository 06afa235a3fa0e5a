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
    python -m dpsvm_tpu_torch.cli test  -f test.csv  -m model.svm

``-f`` takes a dense CSV or a libsvm file (sniffed). With ``-t precomputed`` (LIBSVM -t 4) the training CSV holds the (n, n)
kernel matrix as its rows (``label,K_i1,...,K_in``) and the test CSV the
rows of K(test, train).
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


def _add_common(p: argparse.ArgumentParser, model_help: str) -> None:
    p.add_argument("-f", "--input", required=True,
                   help="dataset: dense CSV 'label,f1,...,fd' or libsvm "
                        "'label idx:val ...' (sniffed)")
    p.add_argument("-m", "--model", required=True, help=model_help)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to run (default cuda; cpu runs the plain "
                        "PyTorch versions of the kernels)")


def build_parser() -> argparse.ArgumentParser:
    root = argparse.ArgumentParser(prog="dpsvm_tpu_torch")
    sub = root.add_subparsers(dest="command", required=True)

    tr = sub.add_parser("train", help="train a binary SVM (RBF default)")
    _add_common(tr, "model file to write")
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
    tr.add_argument("--clip", default="independent",
                    choices=["independent", "pairwise"],
                    help="alpha-step clip rule: 'independent' = the "
                         "reference's (both alphas clipped separately), "
                         "'pairwise' = the textbook/LIBSVM joint box")
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
    tr.add_argument("-q", "--quiet", action="store_true")

    te = sub.add_parser("test", help="evaluate a saved model on a dataset")
    _add_common(te, "model file to read")
    return root


def cmd_train(args: argparse.Namespace) -> int:
    from dpsvm_tpu_torch.api import fit
    from dpsvm_tpu_torch.config import SVMConfig
    from dpsvm_tpu_torch.data.loader import load_dataset
    from dpsvm_tpu_torch.models.io import save_model
    from dpsvm_tpu_torch.models.svm import evaluate

    x, y = load_dataset(args.input)
    config = SVMConfig(c=args.cost, gamma=args.gamma, kernel=args.kernel,
                       degree=args.degree, coef0=args.coef0,
                       epsilon=args.epsilon, max_iter=args.max_iter,
                       selection=args.selection,
                       select_impl=args.select_impl,
                       working_set=args.working_set,
                       inner_iters=args.inner_iters,
                       grow_working_set=args.grow_working_set,
                       weight_pos=args.weight_pos,
                       weight_neg=args.weight_neg,
                       clip=args.clip,
                       matmul_precision=args.precision,
                       shrinking=args.shrinking,
                       checkpoint_path=args.checkpoint,
                       checkpoint_every=args.checkpoint_every,
                       checkpoint_keep=args.checkpoint_keep,
                       resume_from=args.resume,
                       verbose=not args.quiet)
    model, result = fit(x, y, config, device=args.device)
    n_sv = save_model(model, args.model)
    acc = evaluate(model, x, y, device=args.device)
    # Same closing report the reference prints (svmTrainMain.cpp:313-336).
    print(f"Number of SVs: {n_sv}")
    print(f"b: {result.b:.6f}")
    print(f"Training iterations: {result.n_iter}"
          + ("" if result.converged else " (max-iter reached, NOT converged)"))
    print(f"Training accuracy: {acc:.6f}")
    print(f"Training time: {result.train_seconds:.3f} s")
    return 0


def cmd_test(args: argparse.Namespace) -> int:
    import numpy as np

    from dpsvm_tpu_torch.data.loader import load_dataset
    from dpsvm_tpu_torch.models.io import load_model
    from dpsvm_tpu_torch.models.svm import decision_function

    model = load_model(args.model)
    x, y = load_dataset(args.input)
    if x.shape[1] != model.num_attributes:
        print(f"error: dataset has {x.shape[1]} attributes, model has "
              f"{model.num_attributes}", file=sys.stderr)
        return 2
    t_eval = time.perf_counter()
    dec = decision_function(model, x, device=args.device)
    t_eval = time.perf_counter() - t_eval
    pred = np.where(dec < 0, -1, 1)                    # svmTrain.cu:650-656
    acc = float(np.mean(pred == np.asarray(y, np.int32)))
    print(f"Number of SVs: {model.n_sv}")
    print(f"Test accuracy: {acc:.6f}")
    print(f"Evaluation time: {t_eval:.3f} s "
          f"({len(pred)} examples, {len(pred) / t_eval:,.0f} ex/s)")
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

"""Command-line front end of the port: the ``train`` and ``test``
subcommands of ``dpsvm_tpu/cli.py``, with the same flag names and closing
report, plus ``--device {cuda,cpu}`` (default cuda).

    python -m dpsvm_tpu_torch.cli train -f train.csv -m model.svm -c 10 -g 0.25
    python -m dpsvm_tpu_torch.cli test  -f test.csv  -m model.svm
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional


def _add_common(p: argparse.ArgumentParser, model_help: str) -> None:
    p.add_argument("-f", "--input", required=True,
                   help="dataset: dense CSV 'label,f1,...,fd'")
    p.add_argument("-m", "--model", required=True, help=model_help)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to run (default cuda; cpu runs the plain "
                        "PyTorch versions of the kernels)")


def build_parser() -> argparse.ArgumentParser:
    root = argparse.ArgumentParser(prog="dpsvm_tpu_torch")
    sub = root.add_subparsers(dest="command", required=True)

    tr = sub.add_parser("train", help="train a binary RBF SVM")
    _add_common(tr, "model file to write")
    tr.add_argument("-c", "--cost", type=float, default=1.0)
    tr.add_argument("-g", "--gamma", type=float, default=None,
                    help="kernel gamma (default 1/num_attributes)")
    tr.add_argument("-e", "--epsilon", type=float, default=0.001)
    tr.add_argument("-n", "--max-iter", type=int, default=150_000)
    tr.add_argument("--precision", default="highest",
                    choices=["highest", "high", "default"],
                    help="'highest'/'high': X stored float32; 'default': "
                         "X stored bfloat16 (half the bytes per "
                         "iteration); accumulation is float32 always")
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
    config = SVMConfig(c=args.cost, gamma=args.gamma, epsilon=args.epsilon,
                       max_iter=args.max_iter,
                       matmul_precision=args.precision,
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

"""Command-line front end of the port: the ``train``, ``test``,
``convert``, ``scale``, ``grid``, ``serve`` and ``loadgen`` subcommands of
``dpsvm_tpu/cli.py``, with the same flag names and closing report, plus
``--device {cuda,cpu}`` (default cuda).

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
    python -m dpsvm_tpu_torch convert shards train.csv shard_dir \
        [--rows-per-shard 4096]                    # resumable, CRC manifest
    python -m dpsvm_tpu_torch convert libsvm a9a.libsvm a9a.csv
    python -m dpsvm_tpu_torch scale train.csv scaled.csv -s train.range
    python -m dpsvm_tpu_torch train -f shard_dir -m model.npz -c 10 \
        --solver approx-rff [--mem-budget-mb 512 --on-bad-shard quarantine]
    python -m dpsvm_tpu_torch train -f shard_dir -m model.svm -c 10 \
        --solver cascade                           # out of core, exact model
    python -m dpsvm_tpu_torch test -f shard_dir -m model.svm
    python -m dpsvm_tpu_torch train -f shard_dir -m model.npz -c 10 \
        --solver approx-rff --live                 # a live append log
    python -m dpsvm_tpu_torch test -f test.csv -m model.svm --batch 256
                                                   # the serving engine
    python -m dpsvm_tpu_torch grid -f train.csv --cs 1,10 \
        --gammas 0.125,0.25 [--polish --compare-sequential --out w.svm \
        --promote served.svm --json]              # the C x gamma grid
    python -m dpsvm_tpu_torch tune [--device cpu] [--out profile.json]
                                                   # this device's knobs

``-f`` takes a dense CSV, a libsvm file (sniffed) or a shard directory
from ``convert shards``: ``train --solver approx-*`` streams it
(``approx.primal.fit_approx_stream``), ``--solver cascade`` runs the
out-of-core cascade (``solver.cascade.fit_cascade_stream``), and every
other mode, and ``test``, materialize it through its integrity-checked
reads, under ``--mem-budget-mb``. With ``-t precomputed`` (LIBSVM -t 4) the training CSV holds the (n, n)
kernel matrix as its rows (``label,K_i1,...,K_in``) and the test CSV the
rows of K(test, train). ``--multiclass`` writes a model directory
(``index.json`` and a model file per pair), which ``test`` reads when
``-m`` names a directory. ``test`` reads every model file the train
command writes, LIBSVM ``.model`` files included, and reports by the
model's task: accuracy (classifiers), MSE/MAE/R^2 (regression) or the
inlier fraction (one-class). The flag conflicts and their messages are
the JAX CLI's. ``--solver approx-*`` writes an approx ``.npz`` model (no
SV set), which ``test`` reads like any other. ``train --live`` treats a
shard directory as a live append log (``data/live.py``); it applies to
the streaming approx path only and is refused elsewhere. ``test --batch
N`` evaluates through the serving engine's ladder (``serving/engine.py``)
instead of one monolithic pass. ``grid`` trains a C x gamma grid
(``fleet/grid.py``), with its run trace (``--trace-out``) and its
perf-ledger rows (``--no-ledger`` turns them off). ``train --trace-out``,
``--metrics-out``, ``--metrics-port``, ``--watch-rules``, ``--bundle-dir``
and ``--profile-dir`` observe a run; ``report``, ``compare``, ``perf``,
``profile``, ``watch``, ``bundle`` and ``info`` are the JAX CLI's
subcommands of the same names (either package's traces). ``tune`` measures
this device's knobs into a tuned profile (``tuning/``) that ``train`` and
``serve`` consult for knobs left at their defaults (``--no-tuned`` opts
out).

Distributed training (``--shards P``, the reference's ``mpirun -np P``):
without ``--coordinator`` and outside ``torchrun`` the command starts P
ranks on this host (``parallel.multihost.launch_local``), a GPU each
under NCCL, or gloo ranks with ``--device cpu``; more NCCL ranks than
GPUs are refused (``--dist-backend gloo`` lets CUDA ranks share cards,
as the host-loss drill's hosts share one). With ``--coordinator/--num-hosts/--host-id`` (the JAX
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
                   help="dataset: dense CSV 'label,f1,...,fd', libsvm "
                        "'label idx:val ...' (sniffed), or a shard "
                        "directory from `convert shards` (integrity-"
                        "checked reads)")
    p.add_argument("--mem-budget-mb", type=float, default=None,
                   metavar="MB",
                   help="host-memory admission guard: refuse (up front, "
                        "with the shard-count math) any load whose "
                        "materialized arrays exceed this many MiB; for "
                        "shard directories the streaming train path "
                        "bounds its per-shard working set by the same "
                        "budget")
    p.add_argument("--allow-nonfinite", action="store_true",
                   help="escape hatch: load rows containing NaN/Inf "
                        "features instead of rejecting the file (the "
                        "solver will NOT converge on them)")
    p.add_argument("-m", "--model", required=model_required,
                   default=None, help=model_help)
    p.add_argument("-a", "--num-att", type=int, default=None,
                   help="attribute count (inferred when omitted)")
    p.add_argument("-x", "--num-ex", type=int, default=None,
                   help="example count (inferred when omitted)")
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
                    help="kernel-row cache lines (0 = no cache): "
                         "first-order selection on the general pair "
                         "(default: the device's tuned profile when one "
                         "is active, else 0)")
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
    tr.add_argument("--dist-backend", default=None,
                    choices=["nccl", "gloo"],
                    help="the collectives of --shards/--coordinator "
                         "(default: NCCL between CUDA ranks, gloo between "
                         "CPU ranks); gloo with --device cuda lets ranks "
                         "share a card, staging through the host")
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
    tr.add_argument("--chunk-iters", type=int, default=None, metavar="I",
                    help="host poll cadence: iterations a chunk between "
                         "convergence polls (default: the device's tuned "
                         "profile when one is active, else 512)")
    tr.add_argument("--no-tuned", action="store_true",
                    help="ignore the tuned per-device profile (`tune`): "
                         "knobs left at their defaults stay at the "
                         "built-in defaults (DPSVM_NO_TUNED=1 is the env "
                         "equivalent; explicit flags always win either "
                         "way)")
    tr.add_argument("--on-divergence", default="raise",
                    choices=["raise", "rollback", "ignore"],
                    help="poll-loop health policy for a sick run "
                         "(non-finite gap, stagnation, SV collapse, a "
                         "desynchronized mesh): 'rollback' restores the "
                         "newest intact checkpoint and halves the poll "
                         "chunk (needs --checkpoint)")
    tr.add_argument("--health-window", type=int, default=0, metavar="I",
                    help="iterations without best-gap improvement "
                         "before the stagnation guard trips (0 = off)")
    tr.add_argument("--retries", type=int, default=0, metavar="N",
                    help="supervise training in a child process and "
                         "relaunch up to N times after transient deaths "
                         "(preemption exit 75, stall 124, SIGTERM/"
                         "SIGKILL), resuming from the newest intact "
                         "checkpoint")
    tr.add_argument("--retry-backoff", type=float, default=5.0,
                    metavar="S",
                    help="base of the exponential retry backoff: "
                         "attempt k waits S * 2^k seconds (default 5)")
    tr.add_argument("--debug-nans", action="store_true",
                    help="each poll also checks that alpha and f are "
                         "finite and raises on the first chunk that "
                         "leaves them not (one extra read a poll)")
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
    tr.add_argument("--on-bad-shard", default="raise",
                    choices=["raise", "quarantine"],
                    help="streaming-ingest policy when a shard fails its "
                         "manifest CRC or finiteness check (shard-"
                         "directory inputs): 'quarantine' drops the "
                         "shard, bounded by the bad-fraction abort")
    tr.add_argument("--live", action="store_true",
                    help="treat a shard-directory input as a LIVE append "
                         "log: streaming approx training polls the "
                         "manifest at sweep boundaries and admits newly "
                         "durable shards mid-run (append_admitted / "
                         "ingest_grow events; checkpoints carry the "
                         "consumed generation)")
    tr.add_argument("--profile-dir", default=None,
                    help="write a windowed torch.profiler trace here "
                         "(the first polls skipped, K polls captured, "
                         "phases annotated) plus a profile_summary.json "
                         "sidecar — render with `profile summarize DIR`")
    tr.add_argument("--metrics-port", type=int, default=None,
                    metavar="N",
                    help="opt-in read-only metrics sidecar: serve the "
                         "live metric registry on this port (0 = OS-"
                         "assigned; bound port printed to stderr) as "
                         "/metricsz JSON and /metricsz?format="
                         "prometheus, torn down at run end — fed from "
                         "the existing packed-stats polls, zero extra "
                         "device transfers")
    tr.add_argument("--metrics-out", default=None, metavar="FILE",
                    help="scrape-less CI: rewrite FILE with the "
                         "Prometheus text exposition at every poll "
                         "(atomic replace)")
    tr.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a run-telemetry JSONL here (manifest + "
                         "per-chunk gap/SV-count/cache-counter records "
                         "+ capture/build records + summary — zero "
                         "extra device polls; render with `report "
                         "PATH`)")
    tr.add_argument("--watch-rules", default=None, metavar="FILE",
                    help="alert-rules JSON for the continuous watch "
                         "(gap stagnation, compile storm, roofline drop "
                         "vs the perf-ledger median; default rules when "
                         "only --bundle-dir is given)")
    tr.add_argument("--bundle-dir", default=None, metavar="DIR",
                    help="arm the black-box flight recorder: a firing "
                         "watch rule dumps a self-contained incident "
                         "bundle here (ring trace + metrics + doctor + "
                         "ledger context; render with `bundle DIR`)")
    tr.add_argument("-q", "--quiet", action="store_true")

    te = sub.add_parser("test", help="evaluate a saved model on a dataset")
    _add_common(te, "model file (or --multiclass model directory) to read")
    te.add_argument("--no-b", action="store_true",
                    help="drop the intercept like seq_test.cpp:197")
    te.add_argument("--predictions", default=None, metavar="PATH",
                    help="also write one predicted label per line "
                         "(binary models: 'label,decision_value')")
    te.add_argument("--batch", type=int, default=0, metavar="N",
                    help="evaluate through the serving engine's bucket "
                         "ladder at up to N rows a device pass (one "
                         "captured CUDA graph a bucket) instead of one "
                         "monolithic pass; bounds device memory on large "
                         "test splits (0 = monolithic)")
    te.add_argument("--proba", default=None, metavar="PATH",
                    help="binary model: write Platt-calibrated P(y=+1|x) "
                         "per line + Brier/log-loss (needs the "
                         "<model>.platt.json sidecar). Multiclass model "
                         "dir: per-class probabilities (pairwise "
                         "coupling) + log-loss, predicting by the coupled "
                         "argmax. Both need train --probability")

    cv = sub.add_parser(
        "convert", help="dataset converters (the reference's scripts/ and "
                        "the out-of-core shard format)")
    cv.add_argument("format", choices=["libsvm", "mnist-odd-even",
                                       "shards"],
                    help="libsvm: sparse 'label idx:val ...' -> dense CSV "
                         "(scripts/convert_adult.py); mnist-odd-even: "
                         "'digit,p1,...' -> +/-1 even/odd with /255 pixels "
                         "(scripts/convert_mnist_to_odd_even.py); shards: "
                         "any loader-supported file -> a directory of "
                         "fixed-shape .npz shards + a CRC-carrying "
                         "manifest, streamed row by row and resumable")
    cv.add_argument("src", help="input file")
    cv.add_argument("dst", help="output CSV (or, for shards, the output "
                                "directory)")
    cv.add_argument("-a", "--num-att", type=int, default=None,
                    help="libsvm/shards: force the dense width (default: "
                         "max feature index seen)")
    cv.add_argument("--rows-per-shard", type=int, default=4096,
                    metavar="R",
                    help="shards: rows per fixed-shape shard (the "
                         "streaming path's block and per-shard memory "
                         "peak; default 4096)")
    cv.add_argument("--float-labels", action="store_true",
                    help="shards: store float32 labels (regression "
                         "targets); default int32 labels, non-integer "
                         "labels rejected")
    cv.add_argument("--allow-nonfinite", action="store_true",
                    help="shards: shard rows containing NaN/Inf instead of "
                         "rejecting the conversion")
    cv.add_argument("--no-resume", dest="resume", action="store_false",
                    default=True,
                    help="shards: ignore a previous conversion's cursor "
                         "and restart from row 0")

    gd = sub.add_parser(
        "grid", help="C x gamma grid trainer: the whole grid as batched "
                     "sweeps spread over the devices, per-cell held-out "
                     "accuracy, optional cascade polish of the winner; "
                     "prints one JSON row and can promote the winner "
                     "into a serving artifact atomically")
    _add_common(gd, "unused (the winner goes to --out / --promote)",
                model_required=False)
    gd.add_argument("--cs", default="0.25,1,4,16", metavar="C1,C2",
                    help="comma list of C values: the grid rows "
                         "(default 0.25,1,4,16)")
    gd.add_argument("--gammas", default=None, metavar="G1,G2",
                    help="comma list of gamma values: the grid columns "
                         "(default: one column at the 1/d default)")
    gd.add_argument("-k", "--kernel", default="rbf",
                    choices=["rbf", "linear", "poly", "sigmoid"])
    gd.add_argument("-d", "--degree", type=int, default=3)
    gd.add_argument("--coef0", type=float, default=0.0)
    gd.add_argument("--max-iter", type=int, default=None,
                    help="per-cell iteration cap (default: the config "
                         "default)")
    gd.add_argument("--holdout-frac", type=float, default=0.2,
                    help="fraction of rows held out for per-cell scoring "
                         "(seeded shuffle split; the winner is the best "
                         "held-out accuracy, row-major first on ties)")
    gd.add_argument("--seed", type=int, default=0,
                    help="holdout-split shuffle seed")
    gd.add_argument("--polish", action="store_true",
                    help="re-fit the winning cell with the cascade solver "
                         "on ALL rows (train + holdout) before saving or "
                         "promoting")
    gd.add_argument("--compare-sequential", action="store_true",
                    help="also fit every cell sequentially (one api.fit "
                         "each) and report the grid_vs_sequential "
                         "speedup")
    gd.add_argument("--out", default=None, metavar="PATH",
                    help="save the winning model here (atomic tmp + "
                         "rename in the target directory)")
    gd.add_argument("--promote", default=None, metavar="PATH",
                    help="promote the winner onto this serving artifact "
                         "path through the registry's atomic "
                         "promote_file (os.replace + a warmed reload)")
    gd.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write the grid training trace here "
                         "(solver='grid': one grid_cell event per "
                         "cell, grid_winner, summary) — the "
                         "provenance pointer the ledger rows carry")
    gd.add_argument("--no-ledger", dest="ledger", action="store_false",
                    default=True,
                    help="skip the perf-ledger append (the grid_train "
                         "and grid_vs_sequential rows)")
    gd.add_argument("--json", action="store_true",
                    help="print only the JSON row")
    gd.add_argument("-q", "--quiet", action="store_true")

    dr = sub.add_parser(
        "doctor", help="training preflight: the card and its roofline "
                       "row, a timed all-reduce over the requested "
                       "ranks, checkpoint-dir writability and newest-"
                       "slot integrity, data and host-group health; "
                       "exits non-zero with a one-line diagnosis")
    dr.add_argument("--shards", type=int, default=0,
                    help="ranks to probe (0 = every visible device)")
    dr.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="probe the card (NCCL) or the CPU (gloo)")
    dr.add_argument("--checkpoint", default=None, metavar="PATH",
                    help="checkpoint path a run would use: the doctor "
                         "checks the directory is writable and the "
                         "newest rotation slot is intact (reporting its "
                         "recorded mesh and iteration)")
    dr.add_argument("--data", default=None, metavar="DIR",
                    help="shard-dataset directory to probe: manifest, "
                         "CRC spot-check, free disk, a timed one-shard "
                         "read; exit 7 (integrity) / 8 (disk space)")
    dr.add_argument("--timeout", type=float, default=60.0,
                    help="bounded wait for the collective probe")
    dr.add_argument("--serving-url", default=None, metavar="URL",
                    help="also report a live `serve` process's tenant "
                         "budget, model cache and front door (never "
                         "changes the exit code)")
    dr.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                    help="multi-host preflight: TCP reach of the "
                         "coordinator (the doctor never joins a group); "
                         "exit 9 = host group degraded")
    dr.add_argument("--hosts-dir", default=None, metavar="DIR",
                    help="host-group heartbeat directory: each host's "
                         "last-beat age, iteration and generation; exit "
                         "9 when a host is missing or stale")
    dr.add_argument("--num-hosts", type=int, default=0, metavar="N",
                    help="expected group size for --hosts-dir (0 = "
                         "whatever heartbeats exist)")
    dr.add_argument("--heartbeat-max-age", type=float, default=60.0,
                    metavar="S",
                    help="heartbeat age past which a host is stale "
                         "(default 60)")

    inf = sub.add_parser(
        "info", help="environment diagnostics: torch, CUDA, the "
                     "card and its power limit, native helper, kernel "
                     "builds")
    inf.add_argument("--timeout", type=float, default=20.0,
                     help="seconds to wait for nvidia-smi before "
                          "reporting the power limit unknown")

    rp = sub.add_parser(
        "report", help="render a run-telemetry trace (train "
                       "--trace-out): convergence curve, phase "
                       "breakdown, cache hit rate, compile/HBM/FLOP "
                       "facts")
    rp.add_argument("trace", help="trace JSONL written by --trace-out "
                                  "(either package's), or a directory "
                                  "of traces — the newest *.jsonl is "
                                  "picked")
    rp.add_argument("--json", action="store_true",
                    help="machine-readable digest instead of the human "
                         "rendering")
    rp.add_argument("--width", type=int, default=60,
                    help="plot width in columns")
    rp.add_argument("--follow", action="store_true",
                    help="live mode: tail an in-flight trace and "
                         "refresh the report until a terminal record "
                         "(summary / stall / preempt) or a stall "
                         "timeout — makes a run in progress watchable")
    rp.add_argument("--interval", type=float, default=1.0, metavar="S",
                    help="--follow refresh poll interval (default 1 s)")
    rp.add_argument("--stall-timeout", type=float, default=300.0,
                    metavar="S",
                    help="--follow exits 3 when the trace file stops "
                         "growing for this long (default 300 s; a run "
                         "killed too hard to stamp its own terminal "
                         "event)")

    cp = sub.add_parser(
        "compare", help="delta table + regression gate between two "
                        "run-telemetry traces (it/s, gap trajectory at "
                        "matched iteration marks, phase split, cache "
                        "hit rate, compile count/seconds, HBM peak)")
    cp.add_argument("a", help="baseline trace JSONL (or a directory — "
                              "newest *.jsonl)")
    cp.add_argument("b", help="candidate trace JSONL (or a directory)")
    cp.add_argument("--json", action="store_true",
                    help="machine-readable comparison")
    cp.add_argument("--fail-on-regress", type=float, default=None,
                    metavar="PCT",
                    help="exit 1 when the candidate regresses past "
                         "PCT%% on a gated metric (it/s drop, HBM-peak "
                         "growth, compile-seconds growth) — the "
                         "mechanical perf gate for benches and CI")
    cp.add_argument("--marks", type=int, default=4,
                    help="iteration marks for the gap-trajectory "
                         "comparison (default 4)")

    pf = sub.add_parser(
        "perf", help="persistent perf ledger: per-case measurement "
                     "history and the historical regression gate "
                     "(median-of-last-N baseline) that catches drift "
                     "accumulating across individually-passing runs")
    pf.add_argument("action", nargs="?", default="history",
                    choices=["history", "gate"],
                    help="history (default): render per-case trends; "
                         "gate: fail on a historical regression")
    pf.add_argument("--ledger", default=None, metavar="PATH",
                    help="ledger JSONL (default: $DPSVM_PERF_LEDGER, "
                         "else dpsvm_tpu_torch/_ledger/"
                         "perf_ledger.jsonl)")
    pf.add_argument("--case", default=None,
                    help="restrict to one case tag (default: all)")
    pf.add_argument("--metric", default="value",
                    help="reading to plot/gate: 'value' (the row's "
                         "headline) or any numeric key of the "
                         "record's metrics dict")
    pf.add_argument("--window", type=int, default=5, metavar="N",
                    help="gate baseline: median of the last N records "
                         "before the newest (default 5)")
    pf.add_argument("--fail-on-regress", type=float, default=10.0,
                    metavar="PCT",
                    help="gate threshold percent (direction-aware "
                         "like `compare`; default 10)")
    pf.add_argument("--last", type=int, default=12,
                    help="history rows rendered per case (default 12)")
    pf.add_argument("--json", action="store_true",
                    help="machine-readable output")

    pr = sub.add_parser(
        "profile", help="render the reconciliation sidecar of a "
                        "`train --profile-dir` capture: phase-"
                        "attributed host wall split next to the run "
                        "trace's phase_counts, plus the device-trace "
                        "artifact inventory and the device time the "
                        "profiler saw")
    pr.add_argument("action", choices=["summarize"],
                    help="summarize: the one reconciliation table")
    pr.add_argument("dir", help="the --profile-dir directory")
    pr.add_argument("--trace", default=None, metavar="PATH",
                    help="run-telemetry trace (or directory) to "
                         "reconcile against: its phase_counts are "
                         "printed next to the profile's phases and "
                         "the match is verified")
    pr.add_argument("--json", action="store_true",
                    help="machine-readable summary")

    wt = sub.add_parser(
        "watch", help="continuous SLO watch: tail a live /metricsz "
                      "endpoint, a --metrics-out snapshot file or an "
                      "in-flight run trace, evaluate the alert rules "
                      "and exit with a distinct code per severity "
                      "(0 = clean, 4 = warn fired, 5 = page fired, "
                      "3 = source stale/unreachable) so cron/CI can "
                      "gate on it")
    src = wt.add_mutually_exclusive_group(required=True)
    src.add_argument("--url", default=None,
                     help="base URL (or full /metricsz URL) of a live "
                          "`serve` / `train --metrics-port` "
                          "process to poll")
    src.add_argument("--metrics-file", default=None, metavar="FILE",
                     help="a `train --metrics-out` snapshot file to "
                          "tail (the seq header detects missed/"
                          "duplicate snapshots)")
    src.add_argument("--trace", default=None, metavar="PATH",
                     help="a run-telemetry trace (or directory — "
                          "newest *.jsonl) to tail; chunk records "
                          "become training watch samples")
    wt.add_argument("--rules", default=None, metavar="FILE",
                    help="alert-rules JSON (default: the built-in "
                         "serving rules for --url/--metrics-file, the "
                         "training rules for --trace)")
    wt.add_argument("--interval", type=float, default=2.0, metavar="S",
                    help="poll interval (default 2 s)")
    wt.add_argument("--for", dest="duration", type=float, default=0.0,
                    metavar="S",
                    help="watch this long then exit (0 = until the "
                         "source ends: trace summary/terminal event, "
                         "or stale timeout)")
    wt.add_argument("--once", action="store_true",
                    help="evaluate one sample and exit (CI gate mode)")
    wt.add_argument("--stale-timeout", type=float, default=60.0,
                    metavar="S",
                    help="exit 3 when the source stops updating for "
                         "this long (default 60 s)")
    wt.add_argument("--bundle-dir", default=None, metavar="DIR",
                    help="dump an incident bundle here when a rule "
                         "fires (the watch-side black box: recent "
                         "samples + alert history)")
    wt.add_argument("--json", action="store_true",
                    help="machine-readable final state instead of the "
                         "live rendering")
    wt.add_argument("-q", "--quiet", action="store_true")

    bd = sub.add_parser(
        "bundle", help="render + validate an incident bundle dumped "
                       "by the flight recorder (`--bundle-dir`): "
                       "incident manifest, embedded-trace report, "
                       "schema/exposition validation; exit 0 valid / "
                       "1 invalid")
    bd.add_argument("dir", help="a bundle directory (incident-*) or a "
                                "parent --bundle-dir (newest bundle "
                                "wins)")
    bd.add_argument("--json", action="store_true",
                    help="machine-readable manifest + verdict")

    sc = sub.add_parser(
        "scale", help="feature scaling (svm-scale analog; LIBSVM-"
                      "compatible .range parameter files)")
    sc.add_argument("src", help="input dataset (CSV or libsvm)")
    sc.add_argument("dst", help="output CSV (scaled)")
    sc.add_argument("-l", "--lower", type=float, default=-1.0)
    sc.add_argument("-u", "--upper", type=float, default=1.0)
    sc.add_argument("-s", "--save-range", default=None, metavar="PATH",
                    help="write fitted scaling params (svm-scale -s)")
    sc.add_argument("-r", "--restore-range", default=None, metavar="PATH",
                    help="apply previously saved params (svm-scale -r; "
                         "use for test files)")

    tn = sub.add_parser(
        "tune", help="measure this device's throughput-critical knobs "
                     "(successive-halving probes through the real "
                     "driver and serving engine, deadline-bounded) and "
                     "persist a per-device tuned profile that train and "
                     "serve consult for knobs left at their defaults")
    tn.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the device to tune (default cuda; the entry "
                         "is keyed by the card's name, or 'cpu')")
    tn.add_argument("-f", "--input", default=None,
                    help="dataset whose rows drive the probes "
                         "(synthetic planted data at --n x --d when "
                         "omitted: probes measure throughput, not model "
                         "quality)")
    tn.add_argument("--n", type=int, default=8192,
                    help="synthetic probe rows (ignored with -f)")
    tn.add_argument("--d", type=int, default=64,
                    help="synthetic probe features (ignored with -f)")
    tn.add_argument("-c", "--cost", type=float, default=10.0,
                    help="probe-problem cost (harder problems sustain "
                         "longer measurement windows)")
    tn.add_argument("-g", "--gamma", type=float, default=None)
    tn.add_argument("--knobs",
                    default="chunk_iters,cache_lines,serve_max_batch",
                    help="comma list of knobs to probe (chunk_iters | "
                         "cache_lines | serve_max_batch)")
    tn.add_argument("--grid", action="append", default=[],
                    metavar="KNOB=V1,V2,...",
                    help="override one knob's candidate grid "
                         "(repeatable); the built-in default value is "
                         "always added so the comparison stays anchored")
    tn.add_argument("--probe-iters", type=int, default=2000, metavar="I",
                    help="iteration budget of the FIRST halving rung "
                         "(each later rung doubles it)")
    tn.add_argument("--rungs", type=int, default=3,
                    help="successive-halving rungs (default 3)")
    tn.add_argument("--deadline-s", type=float, default=300.0,
                    help="wall deadline for the whole tune run: "
                         "finished knobs keep their verdicts, "
                         "unfinished knobs keep their defaults")
    tn.add_argument("--min-win-pct", type=float, default=2.0,
                    help="a candidate must beat the measured default by "
                         "this percent at the final rung or the default "
                         "is kept (default 2)")
    tn.add_argument("--out", default=None, metavar="PATH",
                    help="profile file (default: $DPSVM_TUNED_PROFILE, "
                         "else dpsvm_tpu_torch/_ledger/"
                         "tuned_profile.json)")
    tn.add_argument("--trace-dir", default=None, metavar="DIR",
                    help="probe and A/B trace directory (default: "
                         "traces/tune next to the profile)")
    tn.add_argument("--no-ledger", dest="ledger", action="store_false",
                    default=True, help="skip the perf-ledger appends")
    tn.add_argument("-q", "--quiet", action="store_true")
    _add_serve_parsers(sub)
    return root


def _add_serve_parsers(sub) -> None:
    sv = sub.add_parser(
        "serve", help="online prediction server: micro-batched "
                      "/v1/predict over any saved model (or several), "
                      "one captured CUDA graph a batch bucket, /healthz, "
                      "/metricsz, hot reload, SIGTERM graceful drain")
    sv.add_argument("-m", "--model", action="append", required=True,
                    metavar="[NAME=]PATH",
                    help="model file or multiclass directory to serve "
                         "(repeatable; an unnamed first model is "
                         "registered as 'default')")
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--port", type=int, default=8317,
                    help="listen port (0 = OS-assigned; the bound port "
                         "is printed on the ready line)")
    sv.add_argument("--max-batch", type=int, default=None,
                    help="top rung of the bucket ladder AND the micro-"
                         "batcher's coalescing cap (default: the "
                         "device's tuned profile when one is active, "
                         "else 256)")
    sv.add_argument("--no-tuned", action="store_true",
                    help="ignore the tuned per-device profile for "
                         "serving knobs left at their defaults "
                         "(DPSVM_NO_TUNED=1 is the env equivalent)")
    sv.add_argument("--precision", default="highest",
                    choices=["highest", "high", "default"],
                    help="precision of the decision ladder: 'highest' "
                         "= exact f32 (the default and the bitwise "
                         "decision_function-parity path), 'high' runs "
                         "the f32 program, 'default' = bf16 operands "
                         "with f32 accumulation at a float tolerance")
    sv.add_argument("--max-delay-ms", type=float, default=2.0,
                    help="micro-batching deadline: a batch closes after "
                         "this long even if not full")
    sv.add_argument("--max-queue", type=int, default=4096,
                    help="admission bound in ROWS; a full queue "
                         "fast-rejects with HTTP 429")
    sv.add_argument("--no-b", action="store_true",
                    help="serve intercept-free decisions like "
                         "test --no-b")
    sv.add_argument("--port-file", default=None, metavar="PATH",
                    help="write the bound port here once listening "
                         "(for harnesses that pass --port 0)")
    sv.add_argument("--replicas", type=int, default=1,
                    help="engine replicas per model: a wedged or "
                         "NaN-poisoned replica is ejected (circuit "
                         "breaker) and rebuilt in the background while "
                         "the rest keep serving")
    sv.add_argument("--deadline-ms", type=float, default=30000.0,
                    help="server-wide request deadline budget; a blown "
                         "budget answers 504 + Retry-After. Clients may "
                         "ask for LESS via timeout_ms / X-Deadline-Ms")
    sv.add_argument("--hedge-ms", default="off", metavar="MS|auto|off",
                    help="re-dispatch a still-unanswered request to a "
                         "second replica after this delay ('auto' = "
                         "p99-based); needs --replicas >= 2")
    sv.add_argument("--no-degrade", dest="degrade", action="store_false",
                    default=True,
                    help="disable the overload shed ladder "
                         "(proba->decision, then the sibling model): "
                         "queue-full 429 only")
    sv.add_argument("--degrade-to", action="append", default=[],
                    metavar="NAME=SIBLING",
                    help="tier-2 shed target: under deep overload NAME's "
                         "requests are served by SIBLING (a registered, "
                         "width-compatible model, e.g. an approx twin); "
                         "repeatable")
    sv.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a serving trace (JSONL): manifest, "
                         "eject/rebuild/shed/hedge events, per-request "
                         "span trees for sampled requests, summary at "
                         "drain")
    sv.add_argument("--trace-sample-rate", type=float, default=1.0,
                    metavar="R",
                    help="fraction of requests whose span tree is "
                         "recorded into --trace-out (0..1, "
                         "deterministic stride)")
    sv.add_argument("--watch-rules", default=None, metavar="FILE",
                    help="alert-rules JSON for the serving watchtower "
                         "(default: the built-in multi-window "
                         "availability burn-rate + queue-saturation "
                         "rules)")
    sv.add_argument("--bundle-dir", default=None, metavar="DIR",
                    help="dump a self-contained incident bundle here "
                         "when a watch rule fires")
    sv.add_argument("--no-watch", dest="watch", action="store_false",
                    default=True,
                    help="disable the continuous SLO watchtower")
    sv.add_argument("--tenant-budget", type=int, default=None,
                    metavar="K",
                    help="per-tenant metric label budget: at most K "
                         "tenants get their own series; the long tail "
                         "folds into 'other' (default 32)")
    sv.add_argument("--model-cache-budget", type=int, default=None,
                    metavar="K",
                    help="arm the device model cache: at most K models "
                         "resident at once; the rest are registered "
                         "lazily and hydrate on first request")
    sv.add_argument("--front-end", choices=["threaded", "async"],
                    default="threaded",
                    help="HTTP transport: 'threaded' (thread per "
                         "connection, the default) or 'async' (one "
                         "asyncio loop holds every connection, with the "
                         "weighted-fair per-tenant admission queue)")
    sv.add_argument("--tenant-weight", action="append", default=[],
                    metavar="NAME=W",
                    help="DRR weight for a tenant's fair-queue lane on "
                         "the async front end (repeatable; default 1)")
    sv.add_argument("--max-connections", type=int, default=10000,
                    help="async front end only: open-connection cap; "
                         "beyond it new connections get an immediate "
                         "503 + close")
    sv.add_argument("--hbm-budget-mb", type=float, default=None,
                    metavar="MB",
                    help="per-device budget for a model's packed "
                         "buffers: a model over it is served by a "
                         "ShardedDecider over every visible card (two "
                         "or more), bitwise its one-device reference")
    sv.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the engines run (default cuda)")
    sv.add_argument("-q", "--quiet", action="store_true")

    lg = sub.add_parser(
        "loadgen", help="open/closed-loop load generator against a "
                        "running `serve`; prints ONE JSON row with "
                        "throughput + p50/p95/p99 latency and the "
                        "sequential batch-1 baseline")
    lg.add_argument("--url", default="http://127.0.0.1:8317",
                    help="server base URL")
    lg.add_argument("--model", default="default",
                    help="registered model name to target")
    lg.add_argument("-f", "--input", default=None,
                    help="dataset whose feature rows become request "
                         "payloads (labels ignored); synthetic rows at "
                         "the model's width when omitted")
    lg.add_argument("--mode", choices=["closed", "open"], default="closed",
                    help="closed = each worker fires on completion; "
                         "open = fixed-schedule arrivals at --rps")
    lg.add_argument("--requests", type=int, default=200)
    lg.add_argument("--batch", type=int, default=1,
                    help="rows per request")
    lg.add_argument("--concurrency", type=int, default=8)
    lg.add_argument("--rps", type=float, default=100.0,
                    help="open-loop target arrival rate")
    lg.add_argument("--return", dest="want", default="labels",
                    metavar="K1,K2",
                    help="comma list of outputs to request: labels, "
                         "decision, proba")
    lg.add_argument("--timeout", type=float, default=30.0)
    lg.add_argument("--trace", default=None, metavar="PATH",
                    help="provenance trace pointer carried in the result "
                         "row (the serving side's --trace-out artifact); "
                         "turns on the per-request span breakdown "
                         "(default: $BENCH_TRACE_OUT when set)")
    lg.add_argument("--no-ledger", dest="ledger", action="store_false",
                    default=True,
                    help="skip the perf-ledger append ($DPSVM_PERF_LEDGER"
                         ", else dpsvm_tpu_torch/_ledger/"
                         "perf_ledger.jsonl)")
    lg.add_argument("--no-compare-sequential", dest="compare_sequential",
                    action="store_false", default=True,
                    help="skip the batch-1 single-worker baseline pass")
    lg.add_argument("--chaos", action="store_true",
                    help="chaos-drill report: arm DPSVM_FAULT_SERVE_* on "
                         "the serve process, run this, and the row "
                         "carries availability of accepted requests + "
                         "the /metricsz robustness-counter deltas")
    lg.add_argument("--saturate", action="store_true",
                    help="drive-to-saturation instead: step open-loop RPS "
                         "by --rps-factor until p99 exceeds "
                         "--p99-target-ms and print ONE SLO row")
    lg.add_argument("--p99-target-ms", type=float, default=50.0)
    lg.add_argument("--start-rps", type=float, default=25.0)
    lg.add_argument("--rps-factor", type=float, default=2.0)
    lg.add_argument("--max-steps", type=int, default=8)
    lg.add_argument("--step-requests", type=int, default=100,
                    help="requests per saturation step")
    lg.add_argument("--tenants", type=int, default=0, metavar="N",
                    help="stamp requests with N synthetic tenant labels "
                         "t0..t{N-1}; the row gains per-tenant counts "
                         "and p50/p99")
    lg.add_argument("--hot-tenant-skew", type=float, default=0.0,
                    metavar="S",
                    help="fraction (0..1) of requests sent by the single "
                         "hot tenant t0 (the noisy-neighbour shape)")
    lg.add_argument("--models", type=int, default=0, metavar="N",
                    help="spread requests over the first N models from "
                         "the server's /v1/models list (--model first, "
                         "as the hot model); the row gains per-model "
                         "sub-rows and cold_start_p99_ms")
    lg.add_argument("--model-skew", type=float, default=0.0, metavar="S",
                    help="fraction (0..1) of requests sent to the hot "
                         "model (--model); the rest round-robin the "
                         "remaining N-1")
    lg.add_argument("--connections", type=int, default=0, metavar="N",
                    help="pre-open and HOLD N keep-alive connections for "
                         "the whole run; the first --concurrency carry "
                         "the traffic, the rest sit idle-open")


def _train_conflicts(args: argparse.Namespace):
    """(error message or None, class_weight) from the flags alone, before
    the dataset is parsed: the JAX CLI's rules and messages for the flags
    the port has. Its rows on flags the port does not have (``--pallas``,
    ``--polish``, ``--check-kkt``) drop out."""
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
        if args.trace_out:
            return ("--trace-out records ONE training run; the pairwise "
                    "multiclass subproblems would each overwrite it"), None
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
                 bool(args.checkpoint or args.resume), ""),
                ("--trace-out", bool(args.trace_out),
                 " (it records one run; folds would overwrite it)")):
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
    # A shard directory: a plain approx or cascade train streams it (the
    # data never materializes); every other mode reads it through
    # load_dataset's integrity path under the same budget as files.
    from dpsvm_tpu_torch.data import stream as streamlib
    stream_train = False
    if streamlib.is_shard_dir(args.input):
        restricted = (args.cv or args.multiclass or args.one_class
                      or args.nu_svc or args.nu_svr)
        if args.solver != "exact" and not restricted:
            stream_train = True
        elif args.solver != "exact":
            print("note: this mode materializes the shard directory "
                  "(streaming covers plain --solver approx-* "
                  "training); reads stay integrity-checked and "
                  "budget-guarded", file=sys.stderr)
    if args.live and not stream_train:
        # no silent ignore: live ingest is the streaming train path
        print("error: --live applies to streaming shard-directory "
              "training (--solver approx-* on a converted directory); "
              "this input/mode trains a frozen materialized view",
              file=sys.stderr)
        return 2
    if stream_train:
        x = y = None
    else:
        x, y = load_dataset(args.input, args.num_ex, args.num_att,
            float_labels=(args.svr or args.one_class or args.nu_svr),
            allow_nonfinite=args.allow_nonfinite,
            mem_budget_mb=args.mem_budget_mb,
            on_bad_shard=args.on_bad_shard)
    config = SVMConfig(c=args.cost, gamma=args.gamma, kernel=args.kernel,
                       degree=args.degree, coef0=args.coef0,
                       epsilon=args.epsilon, svr_epsilon=args.svr_epsilon,
                       max_iter=args.max_iter,
                       cache_size=(args.cache_size
                                   if args.cache_size is not None else 0),
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
                       mem_budget_mb=args.mem_budget_mb,
                       on_bad_shard=args.on_bad_shard,
                       live=args.live,
                       profile_dir=args.profile_dir,
                       metrics_port=args.metrics_port,
                       metrics_out=args.metrics_out,
                       trace_out=args.trace_out,
                       watch_rules=args.watch_rules,
                       bundle_dir=args.bundle_dir,
                       chunk_iters=(args.chunk_iters
                                    if args.chunk_iters is not None
                                    else 512),
                       on_divergence=args.on_divergence,
                       health_window=args.health_window,
                       debug_nans=args.debug_nans,
                       verbose=not args.quiet)
    dev = args.device
    # Tuned-profile resolution: explicit value > tuned profile > built-in
    # default (tuning/profile.py; --no-tuned / DPSVM_NO_TUNED=1 opt out;
    # `doctor` reports the active entry). The knob flags default to None
    # so that a flag set TO the default still counts as explicit.
    if not args.no_tuned:
        from dpsvm_tpu_torch.tuning import profile as tuned_profile
        explicit_knobs = {field for field, flag in (
            ("cache_size", args.cache_size),
            ("chunk_iters", args.chunk_iters)) if flag is not None}
        config, tuned_applied = tuned_profile.apply_tuned(
            config, explicit=explicit_knobs,
            device_kind=_device_kind(dev))
        if tuned_applied and not args.quiet:
            print("tuned profile: "
                  + ", ".join(f"{k}={v}" for k, v
                              in sorted(tuned_applied.items()))
                  + " (--no-tuned for built-in defaults)",
                  file=sys.stderr)
    if stream_train:
        return _train_streaming(args, config)
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


def _train_streaming(args, config) -> int:
    """Plain train on a shard directory: the out-of-core approx path, or
    the out-of-core cascade. The data never materializes; the training
    metrics come from a second streamed pass through the same
    integrity-checked reader (a quarantined shard stays out of them as it
    stayed out of the gradient)."""
    import numpy as np

    from dpsvm_tpu_torch.approx.primal import fit_approx_stream
    from dpsvm_tpu_torch.data.stream import ShardedDataset
    from dpsvm_tpu_torch.models.io import save_model
    from dpsvm_tpu_torch.models.svm import decision_function

    if args.probability_cv:
        print("error: --probability-cv refits on held-out folds, "
              "which needs the materialized dataset; use "
              "--probability (streamed decisions) or materialize",
              file=sys.stderr)
        return 2
    ds = ShardedDataset.open(args.input)
    task = "svr" if args.svr else "svc"
    dev = args.device
    if config.solver == "cascade":
        from dpsvm_tpu_torch.solver.cascade import fit_cascade_stream
        model, result = fit_cascade_stream(
            ds, config, allow_nonfinite=args.allow_nonfinite, device=dev)
        n_sv = save_model(model, args.model)
        print(f"Number of SVs: {n_sv}")
        print(f"Cascade: screened {result.n_total} -> {result.n_kept} "
              f"rows ({result.readmit_rounds} polish round(s), "
              f"{result.n_readmitted} re-admitted, "
              f"{result.kkt_violators} KKT violator(s); streamed from "
              f"{ds.n_shards} shard(s)"
              + (f", {len(ds.quarantined)} quarantined"
                 if ds.quarantined else "") + ")")
    else:
        gen0 = ds.generation
        model, result = fit_approx_stream(
            ds, config, task=task, allow_nonfinite=args.allow_nonfinite,
            device=dev)
        save_model(model, args.model)
        print(f"Approx model: {model.model_kind} dim={model.fmap.dim} "
              f"(no SV set; streamed from {ds.n_shards} shard(s)"
              + (f", {len(ds.quarantined)} quarantined"
                 if ds.quarantined else "") + ")")
        if config.live:
            print(f"Live log: generation {gen0} -> {ds.generation} "
                  f"({ds.n} rows admitted)")
    print(f"b: {result.b:.6f}")
    print(f"Training iterations: {result.n_iter}"
          + ("" if result.converged
             else " (max-iter reached, NOT converged)"))
    decs, labs = [], []
    for _k, xk, yk in ds.iter_shards(on_bad_shard=config.on_bad_shard,
                                     allow_nonfinite=args.allow_nonfinite):
        decs.append(np.asarray(decision_function(model, xk, device=dev)))
        labs.append(np.asarray(yk))
    dec = np.concatenate(decs)
    lab = np.concatenate(labs)
    if task == "svc":
        pred = np.where(dec < 0, -1, 1)
        print(f"Training accuracy: "
              f"{float(np.mean(pred == lab.astype(np.int32))):.6f} "
              f"(streamed, {len(lab)} rows)")
    else:
        err = dec - lab.astype(np.float64)
        print(f"Training MSE: {float(np.mean(err ** 2)):.6f}  "
              f"MAE: {float(np.mean(np.abs(err))):.6f} "
              f"(streamed, {len(lab)} rows)")
    print(f"Training time: {result.train_seconds:.3f} s")
    if args.probability and task == "svc":
        from dpsvm_tpu_torch.models.calibration import fit_platt, save_platt
        pa, pb = fit_platt(dec, lab)
        save_platt(args.model, pa, pb)
        print(f"Platt calibration: A={pa:.6f} B={pb:.6f} "
              f"(saved {args.model}.platt.json; fit on streamed "
              "decisions)")
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


def _engine(args, model, include_b: bool = True):
    """``test --batch N``: the serving engine over the model, its ladder
    topped at N rows (full N-row passes and one padded remainder)."""
    from dpsvm_tpu_torch.serving.engine import PredictionEngine
    return PredictionEngine(model, name="cmd-test", max_batch=args.batch,
                            include_b=include_b, device=args.device)


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
    x, y = load_dataset(args.input, allow_nonfinite=args.allow_nonfinite,
                        mem_budget_mb=args.mem_budget_mb)
    if x.shape[1] != d_model:
        print(f"error: dataset has {x.shape[1]} attributes, model has "
              f"{d_model}", file=sys.stderr)
        return 2
    if args.batch:
        decisions = _engine(args, mc, include_b=not args.no_b
                            ).pairwise_list(x)
    else:
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
    if (x.shape[1] < width and not os.path.isdir(args.input)
            and sniff_format(args.input) == "libsvm"):
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
        if args.batch:
            pred = _engine(args, model).predict(x)
        else:
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
    if args.batch:
        pred = _engine(args, model, include_b=not args.no_b).predict(x)
    else:
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

    if args.batch < 0:
        print(f"error: --batch must be >= 0, got {args.batch}",
              file=sys.stderr)
        return 2
    if os.path.isdir(args.model):
        return _test_multiclass(args)
    model = load_model(args.model)
    x, y = load_dataset(args.input, args.num_ex, args.num_att,
                        float_labels=model.task == "svr",
                        allow_nonfinite=args.allow_nonfinite,
                        mem_budget_mb=args.mem_budget_mb)
    if x.shape[1] != model.num_attributes:
        model, x = _reconcile_width(args, model, x)
        if model is None:
            return 2
    if model.task != "svc":
        return _test_task(args, model, x, y)
    t_eval = time.perf_counter()
    if args.batch:
        dec = _engine(args, model, include_b=not args.no_b
                      ).decision_values(x)
    else:
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


def _device_kind(device: str) -> Optional[str]:
    """The tuned-profile key of ``--device`` (the card's name, or
    ``cpu``); None when the card is not there (the command reports that
    itself)."""
    from dpsvm_tpu_torch.tuning import profile as tuned_profile
    if device == "cuda":
        import torch
        if not torch.cuda.is_available():
            return None
    return tuned_profile.current_device_kind(device)


def cmd_tune(args: argparse.Namespace) -> int:
    """Measure and persist this device's tuned profile
    (tuning/tuner.py)."""
    from dpsvm_tpu_torch.config import SVMConfig
    from dpsvm_tpu_torch.tuning import tuner

    knobs = [k for k in args.knobs.split(",") if k]
    unknown = [k for k in knobs if k not in tuner.DEFAULT_GRIDS]
    if unknown:
        print(f"error: unknown knob(s) {unknown}; pick from "
              f"{sorted(tuner.DEFAULT_GRIDS)}", file=sys.stderr)
        return 2
    grids = {}
    for spec in args.grid:
        name, sep, vals = spec.partition("=")
        try:
            if not sep or name not in tuner.DEFAULT_GRIDS:
                raise ValueError(name)
            grids[name] = tuple(int(v) for v in vals.split(",") if v)
        except ValueError:
            print(f"error: --grid needs KNOB=V1,V2,... with a known "
                  f"knob, got {spec!r}", file=sys.stderr)
            return 2
    if args.input:
        from dpsvm_tpu_torch.data.loader import load_dataset
        x, y = load_dataset(args.input, None, None)
    else:
        from dpsvm_tpu_torch.data.synthetic import make_planted
        gamma = args.gamma if args.gamma is not None else 1.0 / args.d
        x, y = make_planted(n=args.n, d=args.d, gamma=gamma, seed=0)
    base = SVMConfig(c=args.cost, gamma=args.gamma, epsilon=1e-5,
                     max_iter=10_000_000)
    log = (lambda s: None) if args.quiet else (
        lambda s: print(s, file=sys.stderr, flush=True))
    _entry, rc = tuner.run_tune(
        x, y, base_config=base, knobs=knobs, grids=grids,
        probe_iters=args.probe_iters, rungs=args.rungs,
        deadline_s=args.deadline_s, min_win_pct=args.min_win_pct,
        profile_out=args.out, trace_dir=args.trace_dir,
        ledger_on=args.ledger, device=args.device, log=log)
    return rc


def cmd_scale(args: argparse.Namespace) -> int:
    from dpsvm_tpu_torch.data.scale import scale_file

    n, d = scale_file(args.src, args.dst, lower=args.lower,
                      upper=args.upper, save_params=args.save_range,
                      restore_params=args.restore_range)
    print(f"Scaled {n} rows x {d} features to {args.dst}")
    if args.save_range:
        print(f"Range file: {args.save_range}")
    return 0


def cmd_convert(args: argparse.Namespace) -> int:
    from dpsvm_tpu_torch.data.convert import (libsvm_to_dense_csv,
                                              mnist_to_odd_even_csv)

    if args.format == "shards":
        from dpsvm_tpu_torch.data.stream import convert_to_shards
        manifest = convert_to_shards(
            args.src, args.dst, rows_per_shard=args.rows_per_shard,
            num_attributes=args.num_att, float_labels=args.float_labels,
            allow_nonfinite=args.allow_nonfinite, resume=args.resume)
        print(f"Wrote {manifest['n']} rows x {manifest['d']} features "
              f"as {len(manifest['shards'])} shard(s) of "
              f"{manifest['rows_per_shard']} rows to {args.dst} "
              "(manifest.json carries per-shard CRC32s + scaling "
              "stats)")
        return 0
    if args.format == "libsvm":
        rows = libsvm_to_dense_csv(args.src, args.dst, args.num_att)
    else:
        rows = mnist_to_odd_even_csv(args.src, args.dst)
    print(f"Wrote {rows} rows to {args.dst}")
    return 0


def cmd_grid(args: argparse.Namespace) -> int:
    """``grid``: train the whole C x gamma grid as batched sweeps, score
    every cell on a seeded holdout, optionally cascade-polish the winner
    and promote it atomically."""
    import json

    import numpy as np

    from dpsvm_tpu_torch.config import SVMConfig
    from dpsvm_tpu_torch.data.loader import load_dataset
    from dpsvm_tpu_torch.fleet.grid import (holdout_split,
                                            sequential_grid_seconds,
                                            train_grid)

    try:
        cs = tuple(float(v) for v in args.cs.split(",") if v.strip())
        gammas = (tuple(float(v) for v in args.gammas.split(",")
                        if v.strip()) if args.gammas else None)
    except ValueError:
        print(f"error: --cs/--gammas must be comma lists of numbers "
              f"(got --cs {args.cs!r} --gammas {args.gammas!r})",
              file=sys.stderr)
        return 2
    if not cs or any(c <= 0 for c in cs):
        print(f"error: --cs needs at least one positive C, got "
              f"{args.cs!r}", file=sys.stderr)
        return 2
    if gammas is not None and any(g <= 0 for g in gammas):
        print(f"error: --gammas must be positive, got {args.gammas!r}",
              file=sys.stderr)
        return 2
    if not (0.0 < args.holdout_frac < 1.0):
        print(f"error: --holdout-frac must be in (0, 1), got "
              f"{args.holdout_frac}", file=sys.stderr)
        return 2
    x, y = load_dataset(args.input, allow_nonfinite=args.allow_nonfinite,
                        mem_budget_mb=args.mem_budget_mb)
    config = SVMConfig(kernel=args.kernel, degree=args.degree,
                       coef0=args.coef0, verbose=not args.quiet,
                       **({"max_iter": args.max_iter}
                          if args.max_iter is not None else {}))
    tr = None
    if args.trace_out:
        from dpsvm_tpu_torch.observability.record import RunTrace
        from dpsvm_tpu_torch.solver.driver import trace_env
        tr = RunTrace(args.trace_out, config=config, n=x.shape[0],
                      d=x.shape[1], gamma=(gammas[0] if gammas
                                           else 1.0 / x.shape[1]),
                      solver="grid", env=trace_env(args.device))
    try:
        grid = train_grid(x, y, cs=cs, gammas=gammas, config=config,
                          holdout_frac=args.holdout_frac, seed=args.seed,
                          polish=args.polish, trace=tr, device=args.device)
    finally:
        if tr is not None:
            tr.close()
    best = grid.best
    row = {
        "metric": "grid_train_seconds",
        "value": round(grid.train_seconds, 4),
        "unit": "s",
        "cs": list(cs),
        "gammas": [c.gamma for c in grid.cells[:len(grid.cells)
                                               // len(cs)]],
        "cells": [{"c": c.c, "gamma": round(c.gamma, 8),
                   "holdout_acc": round(c.holdout_acc, 6),
                   "n_sv": int(c.result.n_sv),
                   "converged": bool(c.result.converged)}
                  for c in grid.cells],
        "winner": {"c": best.c, "gamma": round(best.gamma, 8),
                   "holdout_acc": round(best.holdout_acc, 6),
                   "n_sv": int(best.result.n_sv)},
        "n_train": grid.n_train, "n_holdout": grid.n_holdout,
        "devices": grid.devices, "polished": grid.polished,
        "trace": args.trace_out,
    }

    def _ledger_append(case, value, unit, extra):
        if not args.ledger:
            return
        from dpsvm_tpu_torch.observability import ledger
        ledger.append(case, extra, kind="fleet", value=value, unit=unit,
                      trace=args.trace_out)

    if args.compare_sequential:
        from dpsvm_tpu_torch.models.svm import evaluate
        seq_s, seq_models = sequential_grid_seconds(
            x, y, cs=cs, gammas=gammas, config=config,
            holdout_frac=args.holdout_frac, seed=args.seed,
            device=args.device)
        row["sequential_seconds"] = round(seq_s, 4)
        row["grid_vs_sequential_x"] = (round(seq_s / grid.train_seconds, 3)
                                       if grid.train_seconds > 0 else None)
        # the speedup counts only if the batched cells reached the
        # sequential ones' quality
        _, ho_idx = holdout_split(x.shape[0], args.holdout_frac, args.seed)
        x_ho, y_ho = np.asarray(x)[ho_idx], np.asarray(y)[ho_idx]
        row["seq_acc_gap_max"] = round(max(
            abs(float(evaluate(m, x_ho, y_ho, device=args.device))
                - c.holdout_acc)
            for (_, _, m), c in zip(seq_models, grid.cells)), 6)
        _ledger_append("grid_vs_sequential", row["grid_vs_sequential_x"],
                       "x", {"grid_seconds": row["value"],
                             "sequential_seconds":
                             row["sequential_seconds"],
                             "cells": len(grid.cells),
                             "devices": grid.devices,
                             "seq_acc_gap_max": row["seq_acc_gap_max"],
                             "n": int(x.shape[0]), "d": int(x.shape[1])})
    _ledger_append("grid_train", row["value"], "s", {
        "cells": len(grid.cells), "devices": grid.devices,
        "winner": row["winner"], "polished": grid.polished,
        "n": int(x.shape[0]), "d": int(x.shape[1])})
    if args.out:
        import tempfile

        from dpsvm_tpu_torch.models.io import save_model
        out = os.path.abspath(args.out)
        fd, tmp = tempfile.mkstemp(prefix=f".{os.path.basename(out)}.",
                                   suffix=".grid-cand",
                                   dir=os.path.dirname(out) or ".")
        os.close(fd)
        try:
            save_model(best.model, tmp)
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        row["out"] = out
    if args.promote:
        from dpsvm_tpu_torch.fleet.grid import promote_winner
        from dpsvm_tpu_torch.serving.registry import ModelRegistry
        target = os.path.abspath(args.promote)
        reg = ModelRegistry()
        reg.register("winner", target, lazy=True, warmup=False,
                     max_batch=32, device=args.device)
        try:
            gen = promote_winner(grid, reg, "winner")
        except (OSError, ValueError) as e:
            print(f"error: promote failed: {e}", file=sys.stderr)
            return 1
        row["promoted"] = target
        row["generation"] = gen
    if args.json or args.quiet:
        print(json.dumps(row), flush=True)
    else:
        print(f"grid {len(cs)}x{len(grid.cells) // len(cs)} on "
              f"{grid.devices} device(s): {grid.train_seconds:.2f}s "
              f"({grid.n_train} train / {grid.n_holdout} holdout rows)")
        for c in grid.cells:
            mark = " <-- winner" if c is best else ""
            print(f"  C={c.c:<8g} gamma={c.gamma:<12.6g} "
                  f"holdout_acc={c.holdout_acc:.4f} "
                  f"n_sv={c.result.n_sv}{mark}")
        if "grid_vs_sequential_x" in row:
            print(f"  sequential baseline: {row['sequential_seconds']}s "
                  f"-> {row['grid_vs_sequential_x']}x speedup "
                  f"(max per-cell acc gap {row['seq_acc_gap_max']})")
        if row.get("out"):
            print(f"  saved winner -> {row['out']}")
        if row.get("promoted"):
            print(f"  promoted -> {row['promoted']} "
                  f"(generation {row['generation']})")
    return 0


def cmd_info(args: argparse.Namespace) -> int:
    """Environment diagnostics: what a training run will see, without
    starting one (torch, CUDA, the cards and the power limit, the native
    helper, the kernel builds). Touches no card beyond naming it."""
    import shutil
    import subprocess

    import torch

    import dpsvm_tpu_torch
    from dpsvm_tpu_torch import build
    from dpsvm_tpu_torch.native.build import load_native_lib

    print(f"dpsvm_tpu_torch {dpsvm_tpu_torch.__version__}")
    print(f"torch {torch.__version__} (CUDA {torch.version.cuda})")
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n:
        print(f"backend: cuda ({n} device{'s' if n != 1 else ''})")
        for i in range(n):
            print(f"  cuda:{i} {torch.cuda.get_device_name(i)}")
        smi = shutil.which("nvidia-smi")
        limit = None
        if smi:
            try:
                out = subprocess.run(
                    [smi, "--query-gpu=name,power.limit",
                     "--format=csv,noheader"], capture_output=True,
                    text=True, timeout=max(args.timeout, 1.0))
                limit = out.stdout.strip() if out.returncode == 0 else None
            except (OSError, subprocess.SubprocessError):
                limit = None
        print(f"power limit: {limit or 'unknown (nvidia-smi did not answer)'}")
        print(f"distributed: --shards up to {n} on this host (a card a "
              "rank, NCCL)")
    else:
        print("backend: cpu (no CUDA device; pass --device cpu)")
    lib = load_native_lib()
    print("native helper: "
          + ("loaded (C++ CSV/libsvm parser)" if lib is not None else
             "unavailable (pure-Python fallbacks active)"))
    built = {name: build._target(name).exists() for name in build.SOURCES}
    print(f"kernel builds: {build.BUILD_DIR} ("
          + ", ".join(f"{k} {'built' if v else 'not built'}"
                      for k, v in built.items()) + ")")
    return 0


def _pipe_safe_print(text: str) -> None:
    """print() for the read-only report surfaces, tolerant of a closed
    downstream pipe (`report run.jsonl | head` is the normal
    consumption pattern; a BrokenPipeError traceback there reads as a
    crash). Python re-raises on the shutdown flush too, so stdout is
    redirected to devnull after the pipe breaks."""
    import os

    try:
        print(text)
        sys.stdout.flush()
    except BrokenPipeError:
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())


def cmd_report(args: argparse.Namespace) -> int:
    """Render a run-telemetry trace (either package's). Pure file I/O:
    nothing touches a device, so it works on a machine with no card.
    ``--follow`` tails an in-flight trace instead (exit 0 = run
    finished, 1 = terminal stall/preempt event, 3 = file stopped
    growing)."""
    import json

    from dpsvm_tpu_torch.observability import (follow_trace, load_trace_auto,
                                     render_report, resolve_trace_path,
                                     summarize_trace)

    width = max(int(args.width), 20)
    if args.follow:
        # The trace may not exist yet (watching a run about to start):
        # resolve directories when possible, else follow the raw path.
        # A multi-host trace family cannot be followed live — name one
        # host's file (or report the directory after the run).
        try:
            path = resolve_trace_path(args.trace)
        except FileNotFoundError:
            path = args.trace
        except ValueError as e:
            print(f"error: --follow needs one trace: {e}",
                  file=sys.stderr)
            return 2
        return follow_trace(path, interval=max(args.interval, 0.01),
                            stall_timeout=args.stall_timeout,
                            width=width)
    try:
        # a directory resolves to its newest trace (a multi-host
        # trace_h* family is refused: merging is not ported)
        records = load_trace_auto(args.trace)
    except FileNotFoundError as e:
        print(f"error: no such trace: {e}", file=sys.stderr)
        return 2
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.json:
        _pipe_safe_print(json.dumps(summarize_trace(records)))
    else:
        _pipe_safe_print(render_report(records, width=width))
    return 0


def cmd_compare(args: argparse.Namespace) -> int:
    """Two traces in (either package's), one verdict out. Pure file I/O
    like report. Exit codes: 0 = no gated
    regression (or no gate requested), 1 = regression past
    --fail-on-regress, 2 = unreadable/invalid input."""
    import json

    from dpsvm_tpu_torch.observability import (compare_paths, regressions,
                                     render_compare)

    try:
        cmp, ra, rb = compare_paths(args.a, args.b,
                                    marks=max(int(args.marks), 1))
    except FileNotFoundError as e:
        print(f"error: no such trace: {e}", file=sys.stderr)
        return 2
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    regress = (regressions(cmp, args.fail_on_regress)
               if args.fail_on_regress is not None else [])
    if args.fail_on_regress is not None:
        # Gated verdicts join the perf ledger: pairwise outcomes
        # become history `dpsvm perf gate` can check for accumulated
        # drift the pairwise gate cannot see. Best-effort (a ledger
        # hiccup must not change the compare verdict).
        import os as _os

        from dpsvm_tpu_torch.observability import ledger
        by = {r["metric"]: r for r in cmp["metrics"]}
        ips_b = (by.get("iters_per_sec") or {}).get("b")
        ledger.append(
            _os.path.splitext(_os.path.basename(rb))[0],
            {"passed": not regress, "regressions": regress,
             "threshold_pct": args.fail_on_regress,
             "a": ra, "b": rb, "value": ips_b, "unit": "iter/s"},
            kind="compare", trace=rb)
    if args.json:
        _pipe_safe_print(json.dumps(dict(cmp, a_path=ra, b_path=rb,
                                         regressions=regress)))
    else:
        text = render_compare(cmp, label_a=ra, label_b=rb)
        if args.fail_on_regress is not None:
            if regress:
                text += ("\n\nREGRESSION past "
                         f"{args.fail_on_regress:g}% threshold:")
                text += "".join(f"\n  {r}" for r in regress)
            else:
                text += (f"\n\nno regression past "
                         f"{args.fail_on_regress:g}% threshold")
        _pipe_safe_print(text)
    return 1 if regress else 0


def cmd_perf(args: argparse.Namespace) -> int:
    """Perf-ledger history + historical regression gate. Pure file I/O
    like report/compare. Exit codes: 0 = OK (or gate
    passed), 1 = gate regression, 2 = no/unreadable ledger."""
    import json

    from dpsvm_tpu_torch.observability import ledger

    path = ledger.ledger_path(args.ledger)
    if path is None or not os.path.isfile(path):
        where = path or "(ledger disabled: DPSVM_PERF_LEDGER is empty)"
        print(f"error: no perf ledger at {where} — loadgen, grid and "
              "gated compare runs append to it automatically",
              file=sys.stderr)
        return 2
    try:
        records = ledger.read(path)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.action == "gate":
        try:
            verdicts = ledger.gate(records, window=args.window,
                                   threshold_pct=args.fail_on_regress,
                                   case=args.case, metric=args.metric)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        if args.json:
            _pipe_safe_print(json.dumps({
                "ledger": path, "window": args.window,
                "threshold_pct": args.fail_on_regress,
                "cases": ledger.cases(records),
                "regressions": verdicts}))
        elif verdicts:
            print(f"HISTORICAL REGRESSION past "
                  f"{args.fail_on_regress:g}% (window {args.window}):")
            for v in verdicts:
                print(f"  {v}")
        else:
            n = len([args.case] if args.case
                    else ledger.cases(records))
            print(f"no historical regression past "
                  f"{args.fail_on_regress:g}% across {n} case(s) "
                  f"(median-of-last-{args.window} baseline, {path})")
        return 1 if verdicts else 0
    if args.json:
        out = {"ledger": path, "cases": {}}
        for c in ([args.case] if args.case
                  else ledger.cases(records)):
            out["cases"][c] = ledger.series(records, c,
                                            metric=args.metric)
            for h in out["cases"][c]:
                h.pop("record", None)
        _pipe_safe_print(json.dumps(out))
        return 0
    if args.case and args.case not in ledger.cases(records):
        print(f"error: no case {args.case!r} in {path} "
              f"(cases: {ledger.cases(records)})", file=sys.stderr)
        return 2
    _pipe_safe_print(f"perf ledger: {path} "
                     f"({len(records)} record(s))\n"
                     + ledger.render_history(
                         records, case=args.case, metric=args.metric,
                         last=args.last))
    return 0


def cmd_profile(args: argparse.Namespace) -> int:
    """`profile summarize DIR`: the reconciliation table of a windowed
    --profile-dir capture (observability/profiler.py). Pure file I/O."""
    import json

    from dpsvm_tpu_torch.observability import profiler

    try:
        result = profiler.summarize_profile(args.dir,
                                            trace_path=args.trace)
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    except (ValueError, json.JSONDecodeError) as e:
        print(f"error: unreadable profile summary: {e}",
              file=sys.stderr)
        return 2
    if args.json:
        _pipe_safe_print(json.dumps(result))
        return 0
    text = profiler.render_summary(
        result, trace_phase_counts=result.get("trace_phase_counts"))
    if args.trace is not None and not result.get("phases_match", True):
        text += ("\nWARNING: trace phases missing from the profile's "
                 "annotation vocabulary")
    _pipe_safe_print(text)
    return 0


def cmd_watch(args: argparse.Namespace) -> int:
    """`watch`: continuous SLO evaluation against a live source. Pure
    HTTP/file I/O, so it runs from any machine that can reach the
    source. Exit codes: 0 clean, 4 a warn rule fired, 5 a page rule
    fired (worst severity DURING the watch — a fired-and-cleared burn
    still fails the gate), 3 source stale/unreachable, 2 usage."""
    import json
    import time
    import urllib.error
    import urllib.request

    from dpsvm_tpu_torch.observability import blackbox, slo

    default_kind = "training" if args.trace else "serving"
    try:
        rules = slo.load_rules(args.rules, default=default_kind)
    except (OSError, ValueError) as e:
        print(f"error: bad rules: {e}", file=sys.stderr)
        return 2
    tower = slo.Watchtower(rules)
    follower = slo.SnapshotFollower()
    if args.trace and os.path.isdir(args.trace):
        from dpsvm_tpu_torch.observability.report import resolve_trace_path
        try:
            args.trace = resolve_trace_path(args.trace)
        except (OSError, ValueError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    flight = None
    if args.bundle_dir:
        flight = blackbox.FlightRecorder(blackbox.make_manifest(
            solver=f"watch-{default_kind}",
            config={"source": args.url or args.metrics_file
                    or args.trace}))

    def say(msg: str) -> None:
        if not args.quiet and not args.json:
            print(msg, flush=True)

    def handle(transitions, t_label) -> None:
        for tr in transitions:
            mark = ("FIRING" if tr["state"] == "firing" else "ok")
            say(f"[{t_label}] {mark:>6} {tr['severity']:<4} "
                f"{tr['rule']} ({tr['window']}) {tr['reason']}")
            if flight is not None:
                flight.event("alert", rule=tr["rule"],
                             window=tr["window"],
                             severity=tr["severity"],
                             state=tr["state"], reason=tr["reason"])
                if tr["state"] == "firing":
                    blackbox.dump_bundle(
                        args.bundle_dir, recorder=flight,
                        rule=tr["rule"], severity=tr["severity"],
                        window=tr["window"], reason=tr["reason"],
                        extra={"source": f"watch-{default_kind}"})

    url = None
    if args.url:
        url = args.url.rstrip("/")
        if not url.endswith("/metricsz"):
            url += "/metricsz"

    start = time.monotonic()
    last_progress = start
    trace_pos = 0
    trace_done = None
    stale = False
    # The SOURCE's own watchtower outranks ours: a serving process
    # reports its alert states in /metricsz, and a fresh `watch --url
    # --once` has no sample history of its own — without this merge it
    # would read a mid-incident server as clean.
    server_worst: Optional[str] = None
    server_firing: set = set()
    while True:
        now = time.monotonic()
        got_sample = False
        if url is not None:
            try:
                with urllib.request.urlopen(url, timeout=10) as r:
                    raw = r.read()
                try:
                    obj = json.loads(raw)
                except json.JSONDecodeError:
                    obj = None
                if isinstance(obj, dict) and ("alerts" in obj
                                              or "requests" in obj):
                    # the serving server's JSON blob: counters + its
                    # own alert states
                    sample = slo.sample_from_metricsz_json(obj)
                    firing_now = set()
                    for a in obj.get("alerts") or []:
                        if a.get("state") != "firing":
                            continue
                        sev = a.get("severity", "warn")
                        firing_now.add(a.get("rule"))
                        server_worst = slo.worst_severity(
                            server_worst, sev)
                        if a.get("rule") not in server_firing:
                            ten = (f" [tenant {a['tenant']}]"
                                   if a.get("tenant") else "")
                            say(f"[live] FIRING {sev:<4} "
                                f"{a.get('rule')} "
                                f"({a.get('window')}){ten} — reported "
                                "by the source's own watchtower")
                    for rule in server_firing - firing_now:
                        say(f"[live]     ok      {rule} — cleared at "
                            "the source")
                    server_firing = firing_now
                else:
                    # registry-snapshot shape (the train sidecar):
                    # re-fetch as the text exposition and flatten
                    with urllib.request.urlopen(
                            url + "?format=prometheus",
                            timeout=10) as r:
                        sample = slo.sample_from_prometheus(
                            r.read().decode())
                handle(tower.observe(sample, t=now), "live")
                got_sample = True
            except (urllib.error.URLError, OSError) as e:
                say(f"source unreachable: {e}")
        elif args.metrics_file is not None:
            try:
                with open(args.metrics_file) as fh:
                    text = fh.read()
            except OSError:
                text = None             # not written yet: wait
            if text:
                fresh, problems = follower.note(
                    slo.parse_snapshot_header(text))
                for p in problems:
                    say(f"WARNING: {p}")
                if fresh:
                    handle(tower.observe(
                        slo.sample_from_prometheus(text), t=now),
                        f"seq={follower.last_seq}")
                    got_sample = True
        else:
            try:
                with open(args.trace) as fh:
                    fh.seek(trace_pos)
                    new = fh.read()
                    trace_pos = fh.tell()
            except OSError:
                new = ""
            for line in new.splitlines():
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue            # torn final line of a live run
                got_sample = True
                kind = rec.get("kind")
                if kind == "chunk":
                    t_rec, sample = slo.sample_from_chunk(rec)
                    handle(tower.observe(sample, t=t_rec),
                           f"iter={rec.get('n_iter')}")
                elif (kind == "summary"
                      or (kind == "event"
                          and rec.get("event") in ("stall",
                                                   "preempt"))):
                    trace_done = (rec.get("event")
                                  if kind == "event" else "summary")
        if got_sample:
            last_progress = now
        if trace_done is not None:
            say(f"trace ended ({trace_done})")
            break
        if args.once and got_sample:
            break
        if args.duration and now - start >= args.duration:
            break
        if now - last_progress >= args.stale_timeout:
            stale = True
            break
        time.sleep(max(args.interval, 0.05))

    states = tower.states()
    worst = slo.worst_severity(tower.worst_fired, server_worst)
    code = slo.EXIT_STALE if stale else slo.severity_exit_code(worst)
    if args.json:
        _pipe_safe_print(json.dumps({
            "states": states, "worst_fired": worst,
            "source_reported": sorted(server_firing),
            "stale": stale,
            "snapshots": {"missed": follower.missed,
                          "duplicates": follower.duplicates},
            "exit_code": code}))
    else:
        say("")
        for s in states:
            mark = "FIRING" if s["state"] == "firing" else "ok"
            say(f"{mark:>6} {s['severity']:<4} {s['rule']} "
                f"({s['window']})"
                + (f" [tenant {s['tenant']}]" if s.get("tenant")
                   else "")
                + (f" — {s['reason']}" if s["reason"] else "")
                + (f" [fired {s['fired_count']}x]"
                   if s["fired_count"] else ""))
        for rule in sorted(server_firing):
            say(f"FIRING (source-reported) {rule}")
        if stale:
            print(f"error: source stale for {args.stale_timeout:g}s",
                  file=sys.stderr)
    return code


def cmd_bundle(args: argparse.Namespace) -> int:
    """`bundle DIR`: render + validate one incident bundle
    (observability/blackbox.py). Exit 0 = valid, 1 = invalid, 2 = no
    bundle found."""
    import json

    from dpsvm_tpu_torch.observability import blackbox

    try:
        path = blackbox.resolve_bundle_dir(args.dir)
    except (FileNotFoundError, NotADirectoryError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    problems = blackbox.validate_bundle(path)
    if args.json:
        try:
            incident = blackbox.load_incident(path)
        except (OSError, json.JSONDecodeError):
            incident = None
        _pipe_safe_print(json.dumps({
            "path": path, "valid": not problems,
            "problems": problems, "incident": incident}))
    else:
        try:
            _pipe_safe_print(blackbox.render_bundle(path))
        except (OSError, json.JSONDecodeError) as e:
            print(f"error: unrenderable bundle: {e}", file=sys.stderr)
            return 1
        if problems:
            print("bundle INVALID:", file=sys.stderr)
            for p in problems:
                print(f"  {p}", file=sys.stderr)
        else:
            _pipe_safe_print("bundle OK (trace schema-valid, "
                             "exposition grammar-valid)")
    return 1 if problems else 0


def cmd_serve(args: argparse.Namespace) -> int:
    """Online prediction server. Loads and warms every model, prints one
    ready line, then serves until SIGTERM/SIGINT, which drains:
    everything accepted is answered, then the process exits 0."""
    from dpsvm_tpu_torch.device import resolve_device
    from dpsvm_tpu_torch.serving import ModelRegistry
    from dpsvm_tpu_torch.serving.server import ServingServer

    # Tuned-profile resolution for the serving knobs left at their
    # defaults (tuning/profile.py): explicit flags always win;
    # --no-tuned / DPSVM_NO_TUNED=1 opt out.
    tuned_entry = None
    if not args.no_tuned:
        from dpsvm_tpu_torch.tuning import profile as tuned_profile
        kind = _device_kind(args.device)
        tuned_entry = kind and tuned_profile.active_entry(kind)
    if args.max_batch is None:
        from dpsvm_tpu_torch.tuning.profile import tuned_value
        mb = tuned_value(tuned_entry, "serve_max_batch")
        args.max_batch = int(mb) if mb else 256
        if mb and not args.quiet:
            print(f"tuned profile: max_batch={args.max_batch} "
                  "(--no-tuned for the built-in 256)", file=sys.stderr)
    if args.hedge_ms == "off" and args.replicas >= 2:
        from dpsvm_tpu_torch.tuning.profile import tuned_value
        hm = tuned_value(tuned_entry, "serve_hedge_ms")
        if hm:
            args.hedge_ms = str(float(hm))
            if not args.quiet:
                print(f"tuned profile: hedge_ms={args.hedge_ms} "
                      "(--no-tuned to disable)", file=sys.stderr)
    if args.max_batch < 1 or args.max_queue < 1:
        print("error: --max-batch and --max-queue must be >= 1",
              file=sys.stderr)
        return 2
    if args.replicas < 1:
        print("error: --replicas must be >= 1", file=sys.stderr)
        return 2
    if not (args.deadline_ms > 0):
        print("error: --deadline-ms must be > 0", file=sys.stderr)
        return 2
    if not (0.0 <= args.trace_sample_rate <= 1.0):
        print("error: --trace-sample-rate must be in [0, 1], got "
              f"{args.trace_sample_rate}", file=sys.stderr)
        return 2
    hedge = args.hedge_ms            # "off", "auto" or a delay in ms
    if hedge not in ("off", "auto"):
        try:
            hedge = float(hedge) / 1000.0
        except ValueError:
            print(f"error: --hedge-ms must be a number, 'auto' or "
                  f"'off', got {args.hedge_ms!r}", file=sys.stderr)
            return 2
    siblings = {}
    for spec in args.degrade_to:
        name, sep, sib = spec.partition("=")
        if not sep or not name or not sib:
            print(f"error: --degrade-to needs NAME=SIBLING, got "
                  f"{spec!r}", file=sys.stderr)
            return 2
        siblings[name] = sib
    cache_budget = args.model_cache_budget
    if cache_budget is not None and cache_budget < 1:
        print("error: --model-cache-budget must be >= 1",
              file=sys.stderr)
        return 2
    if args.hbm_budget_mb is not None and not (args.hbm_budget_mb > 0):
        print(f"error: --hbm-budget-mb must be > 0, got "
              f"{args.hbm_budget_mb}", file=sys.stderr)
        return 2
    if args.max_connections < 1:
        print("error: --max-connections must be >= 1", file=sys.stderr)
        return 2
    tenant_weights = {}
    if args.tenant_weight:
        if args.front_end != "async":
            print("error: --tenant-weight needs --front-end async (the "
                  "threaded transport has no fair queue)",
                  file=sys.stderr)
            return 2
        from dpsvm_tpu_torch.serving.fairqueue import parse_tenant_weights
        try:
            tenant_weights = parse_tenant_weights(args.tenant_weight)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    if cache_budget is not None and args.no_b:
        # the cache's shared same-spec program serves include_b=True
        # decisions; mixing the two would silently change semantics
        print("error: --no-b is not supported with --model-cache-budget",
              file=sys.stderr)
        return 2
    dev = resolve_device(args.device)
    extra = ({"hbm_budget_mb": args.hbm_budget_mb}
             if args.hbm_budget_mb else {})
    registry = ModelRegistry()
    for i, spec in enumerate(args.model):
        name, sep, path = spec.partition("=")
        if not sep:
            name, path = ("default" if i == 0
                          else os.path.basename(spec.rstrip("/"))), spec
        if name in registry.names():
            print(f"error: duplicate model name {name!r} (use NAME=PATH "
                  "to disambiguate)", file=sys.stderr)
            return 2
        if not os.path.exists(path):
            print(f"error: no such model: {path}", file=sys.stderr)
            return 2
        if cache_budget is not None:
            # fleet mode: manifest-only registration; the model cache
            # hydrates on first request, within its budget
            registry.register(name, path, lazy=True,
                              max_batch=args.max_batch, include_b=True,
                              precision=args.precision, device=dev,
                              **extra)
            if not args.quiet:
                print(f"registered {name!r} (lazy): {path}",
                      file=sys.stderr)
            continue
        engine = registry.register(name, path, max_batch=args.max_batch,
                                   include_b=not args.no_b,
                                   precision=args.precision, device=dev,
                                   **extra)
        if not args.quiet:
            m = engine.manifest
            print(f"loaded {name!r}: task={m['task']} n_sv={m['n_sv']} "
                  f"(dropped {m['n_sv_dropped']} zero-coef) "
                  f"d={m['num_attributes']} precision={m['precision']} "
                  f"buckets={m['buckets']} "
                  f"warmup_captures={m['warmup_captures']} "
                  f"on {m['device']} ({m['device_name']})"
                  + (" [sharded decisions]" if m.get("sharded") else ""),
                  file=sys.stderr)
    unknown = [s for pair in siblings.items() for s in pair
               if s not in registry.names()]
    if unknown:
        print(f"error: --degrade-to names unregistered model(s) "
              f"{sorted(set(unknown))} (loaded: {registry.names()})",
              file=sys.stderr)
        return 2
    # the process-wide metric registry: /metricsz?format=prometheus is
    # the single scrape surface
    from dpsvm_tpu_torch.observability.metrics import default_registry
    try:
        srv = ServingServer(registry, args.host, args.port,
                            max_batch=args.max_batch,
                            max_delay_ms=args.max_delay_ms,
                            max_queue=args.max_queue,
                            predict_timeout=args.deadline_ms / 1000.0,
                            replicas=args.replicas, hedge=hedge,
                            degrade=args.degrade, siblings=siblings,
                            trace_out=args.trace_out,
                            trace_sample_rate=args.trace_sample_rate,
                            metrics_registry=default_registry(),
                            watch_rules=args.watch_rules,
                            bundle_dir=args.bundle_dir, watch=args.watch,
                            **({"tenant_budget": args.tenant_budget}
                               if args.tenant_budget is not None else {}),
                            model_cache_budget=cache_budget,
                            verbose=not args.quiet, device=dev)
        if args.front_end == "async":
            from dpsvm_tpu_torch.serving.frontdoor import AsyncFrontDoor
            front = AsyncFrontDoor(
                srv, max_connections=args.max_connections,
                tenant_weights=tenant_weights).start()
        else:
            front = srv.start()
    except ValueError as e:                 # width-mismatched sibling
        print(f"error: {e}", file=sys.stderr)
        return 2
    except OSError as e:                    # unreadable rules file
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.port_file:
        with open(args.port_file, "w") as f:
            f.write(str(front.port))
    print(f"serving on http://{args.host}:{front.port} "
          f"({args.front_end} front end; models: "
          f"{', '.join(registry.names())}; device {dev}) — "
          "SIGTERM/Ctrl-C drains", file=sys.stderr, flush=True)
    signum = front.serve_until_signal()
    if not args.quiet:
        m = srv.metrics()
        print(f"drained (signal {signum}): {m['requests']} requests, "
              f"{m['rejected']} rejected, {m['errors']} errors",
              file=sys.stderr)
    return 0


def cmd_loadgen(args: argparse.Namespace) -> int:
    """Load generator: pure HTTP + numpy, touches no device; runs from
    any machine that can reach the server. The row names the device and
    card the target model is served on (its /v1/models manifest)."""
    import json

    import numpy as np

    from dpsvm_tpu_torch.serving.loadgen import (fetch_models, loadgen_row,
                                                 run_saturate,
                                                 synthetic_rows)

    want = tuple(w for w in args.want.split(",") if w)
    if args.models < 0:
        print("error: --models must be >= 0", file=sys.stderr)
        return 2
    if not (0.0 <= args.model_skew <= 1.0):
        print(f"error: --model-skew must be in [0, 1], got "
              f"{args.model_skew}", file=sys.stderr)
        return 2
    if args.connections < 0:
        print(f"error: --connections must be >= 0, got "
              f"{args.connections}", file=sys.stderr)
        return 2
    try:
        all_models = fetch_models(args.url, timeout=args.timeout)
    except (OSError, RuntimeError) as e:
        print(f"error: cannot reach {args.url}: {e}", file=sys.stderr)
        return 2
    if args.model not in all_models:
        print(f"error: server has no model {args.model!r} "
              f"(models: {sorted(all_models)[:20]})", file=sys.stderr)
        return 2
    manifest = all_models[args.model]
    # a lazy (fleet-cache) registration reports no feature width until
    # it hydrates: borrow the width from any resident sibling, else
    # require -f
    width = manifest.get("num_attributes")
    if width is None:
        width = next((m["num_attributes"] for m in all_models.values()
                      if m.get("num_attributes") is not None), None)
    if args.input:
        from dpsvm_tpu_torch.data.loader import load_dataset
        rows, _ = load_dataset(args.input, None, None)
        rows = np.asarray(rows, np.float32)
        if width is not None and rows.shape[1] != width:
            print(f"error: dataset has {rows.shape[1]} attributes, "
                  f"model {args.model!r} expects {width}",
                  file=sys.stderr)
            return 2
    elif width is not None:
        rows = synthetic_rows(width)
    else:
        print(f"error: model {args.model!r} is not resident and no "
              "sibling reports a feature width: pass -f DATASET so the "
              "loadgen knows the request shape", file=sys.stderr)
        return 2
    served_on = next((m for m in [manifest, *all_models.values()]
                      if m.get("device")), {})
    device = {"device": served_on.get("device"),
              "device_name": served_on.get("device_name")}
    backend = (str(device["device"]).split(":")[0]
               if device["device"] else None)
    fleet_names: list = []
    if args.models > 0:
        # hot model first (the skew target), then the rest sorted
        rest = [n for n in sorted(all_models) if n != args.model]
        fleet_names = [args.model] + rest[:args.models - 1]
        if len(fleet_names) < args.models:
            print(f"error: --models {args.models} but the server has "
                  f"only {len(all_models)} models", file=sys.stderr)
            return 2
    trace = args.trace or os.environ.get("BENCH_TRACE_OUT") or None

    def _ledger_append(row):
        if not args.ledger:
            return
        from dpsvm_tpu_torch.observability import ledger
        ledger.append(row.get("metric", "loadgen"), row, kind="loadgen",
                      trace=row.get("trace"), backend=backend)

    if args.saturate:
        row = run_saturate(args.url, rows, model=args.model,
                           p99_target_ms=args.p99_target_ms,
                           start_rps=args.start_rps,
                           rps_factor=args.rps_factor,
                           max_steps=args.max_steps,
                           step_requests=args.step_requests,
                           batch=args.batch,
                           concurrency=args.concurrency, want=want,
                           timeout=args.timeout, trace=trace,
                           connections=args.connections)
        row.update(device)
        print(json.dumps(row), flush=True)
        _ledger_append(row)
        return 0 if row["slo_met"] else 1
    row = loadgen_row(args.url, rows, model=args.model,
                      requests=args.requests, batch=args.batch,
                      concurrency=args.concurrency, mode=args.mode,
                      rps=args.rps, want=want, timeout=args.timeout,
                      chaos=args.chaos,
                      compare_sequential=args.compare_sequential,
                      trace=trace, tenants=args.tenants,
                      hot_tenant_skew=args.hot_tenant_skew,
                      models=fleet_names, model_skew=args.model_skew,
                      connections=args.connections)
    row.update(device)
    print(json.dumps(row), flush=True)
    _ledger_append(row)
    if row.get("cold_start_p99_ms") is not None:
        # the fleet shape also feeds the model_fleet case: cold-start
        # p99, how fast a paged-out model comes back
        _ledger_append({
            "metric": "model_fleet",
            "value": row["cold_start_p99_ms"], "unit": "ms",
            "trace": row.get("trace"), "models": row.get("models"),
            "model_skew": row.get("model_skew"),
            "hot_model": row.get("hot_model"),
            "p99_ms": row.get("p99_ms"), "requests": row.get("requests"),
            "errors": row.get("errors"), **device})
    if row.get("hot_tenant") and row.get("others_p99_ms") is not None:
        # the noisy-neighbour shape also feeds the tenant_isolation
        # case: the cold tenants' p99 while one tenant hogs the queue
        _ledger_append({
            "metric": "tenant_isolation",
            "value": row["others_p99_ms"], "unit": "ms",
            "trace": row.get("trace"), "tenants": row.get("tenants"),
            "hot_tenant_skew": row.get("hot_tenant_skew"),
            "hot_tenant": row.get("hot_tenant"),
            "hot_p99_ms": row.get("hot_p99_ms"),
            "others_p99_ms": row.get("others_p99_ms"),
            "requests": row.get("requests"),
            "errors": row.get("errors"), **device})
    if args.chaos:
        # a chaos drill EXPECTS some failures; the verdict is the
        # availability of accepted requests
        avail = row.get("availability_pct")
        return 0 if (avail is not None and avail >= 99.0) else 1
    return 0 if row["errors"] == 0 else 1


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
            multihost.initialize(device=args.device,
                                 backend=args.dist_backend)
        else:
            multihost.initialize(args.coordinator, args.num_hosts,
                                 args.host_id, device=args.device,
                                 backend=args.dist_backend)
    elif args.shards > 1 and not multihost.is_initialized():
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            multihost.initialize(device=args.device,       # torchrun
                                 backend=args.dist_backend)
        else:
            rcs = multihost.launch_local(args.shards, _train_rank, (argv,),
                                         device=args.device,
                                         backend=args.dist_backend)
            return max(rcs)
    return None


def _run(args) -> int:
    from dpsvm_tpu_torch.data.stream import StreamError
    from dpsvm_tpu_torch.resilience.health import DivergenceError
    from dpsvm_tpu_torch.resilience.preempt import (PREEMPT_EXIT_CODE,
                                                    PreemptedError)
    try:
        if args.command == "train":
            return cmd_train(args)
        if args.command == "convert":
            return cmd_convert(args)
        if args.command == "scale":
            return cmd_scale(args)
        if args.command == "grid":
            return cmd_grid(args)
        if args.command == "serve":
            return cmd_serve(args)
        if args.command == "loadgen":
            return cmd_loadgen(args)
        if args.command == "info":
            return cmd_info(args)
        if args.command == "report":
            return cmd_report(args)
        if args.command == "compare":
            return cmd_compare(args)
        if args.command == "perf":
            return cmd_perf(args)
        if args.command == "profile":
            return cmd_profile(args)
        if args.command == "watch":
            return cmd_watch(args)
        if args.command == "bundle":
            return cmd_bundle(args)
        if args.command == "tune":
            return cmd_tune(args)
        if args.command == "doctor":
            from dpsvm_tpu_torch.resilience.doctor import run_doctor
            return run_doctor(shards=args.shards,
                              checkpoint_path=args.checkpoint,
                              data_path=args.data, timeout_s=args.timeout,
                              serving_url=args.serving_url,
                              coordinator=args.coordinator,
                              hosts_dir=args.hosts_dir,
                              num_hosts=args.num_hosts,
                              heartbeat_max_age_s=args.heartbeat_max_age,
                              device=args.device)
        return cmd_test(args)
    except PreemptedError as e:
        # resumable: the supervisor (or the next run) takes the snapshot
        print(f"preempted: {e}", file=sys.stderr)
        return PREEMPT_EXIT_CODE
    except StreamError as e:
        # shard corruption under on_bad_shard='raise', the bad-fraction
        # abort, a budget refusal: one-line operator errors
        print(f"error: {e}", file=sys.stderr)
        return 2
    except DivergenceError as e:
        print(f"error: {e} (see --on-divergence)", file=sys.stderr)
        return 1
    except FloatingPointError as e:
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
    if args.command == "train" and args.retries > 0:
        # The retry supervisor: every attempt is a child process (so a
        # stall watchdog's exit 124, a SIGKILL or a real preemption is
        # survivable), this command minus the supervisor flags, with the
        # newest intact checkpoint slot injected as --resume.
        from dpsvm_tpu_torch.resilience import supervisor
        child = ([sys.executable, "-m", "dpsvm_tpu_torch.cli"]
                 + supervisor.strip_flags(argv, ("--retries",
                                                 "--retry-backoff")))
        return supervisor.supervise(
            child, retries=args.retries, backoff_s=args.retry_backoff,
            checkpoint_path=args.checkpoint)
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

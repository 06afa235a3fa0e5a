"""Where the streaming cascade's last repair round parts between the JAX
package and the PyTorch port.

Runs ``fit_cascade_stream`` of both packages on the CPU at the default
knobs (C=10, gamma=0.25, eps=1e-3, D=1024, approx_seed 0) over the rows
chip_smoke.py's stream phase uses (the first 20000 of
make_planted(25000, 784, gamma=0.25, seed=0), shards of 4096 rows), and
records every polish round's input (the kept rows, their warm-start
alpha) and output. Then it crosses the first and the last round: each
package's polish from each package's input of that round, with its b and
sum(alpha * y) (the reference's independent clip lets it drift, by an
amount that depends on the trajectory), and for the last round every
outcome held in float64:

- the kept subproblem's KKT gap (b_lo - b_hi over the SMO index sets; a
  converged polish has it at most 2 eps, up to float32 drift);
- the screened-out rows' zero-alpha KKT test y f >= 1 - 2 eps, counted,
  with the violators' y f under every outcome.

One JSON line a round of each run (its kept rows, how many of them the
other run's same round kept too, b and sum(alpha * y)), and one a crossed
outcome.

    PYTHONPATH=. JAX_PLATFORMS=cpu python scripts/cascade_polish_witness.py
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

C, GAMMA, EPS, D_FEAT = 10.0, 0.25, 1e-3, 1024


def _recorder(fn, calls, **extra):
    def wrapped(x, y, alpha, config, *a, **kw):
        res = fn(x, y, alpha, config, *a, **{**extra, **kw})
        calls.append({"x": np.array(x), "y": np.array(y),
                      "alpha_in": np.array(alpha, np.float32),
                      "config": config,
                      "alpha": np.array(res.alpha, np.float32),
                      "b": float(res.b), "n_iter": int(res.n_iter),
                      "converged": bool(res.converged)})
        return res
    return wrapped


def _run(pkg: str, sdir: str) -> list:
    """Every polish round of one package's streaming cascade."""
    calls = []
    if pkg == "jax":
        import dpsvm_tpu.api as api
        from dpsvm_tpu.config import SVMConfig
        from dpsvm_tpu.data import stream as st
        from dpsvm_tpu.solver.cascade import CascadeError, fit_cascade_stream
        kw = {}
    else:
        import dpsvm_tpu_torch.api as api
        from dpsvm_tpu_torch.config import SVMConfig
        from dpsvm_tpu_torch.data import stream as st
        from dpsvm_tpu_torch.solver.cascade import (CascadeError,
                                                    fit_cascade_stream)
        kw = {"device": "cpu"}
    orig = api.warm_start
    api.warm_start = _recorder(orig, calls)
    cfg = SVMConfig(solver="cascade", approx_dim=D_FEAT, c=C, gamma=GAMMA,
                    epsilon=EPS, max_iter=400_000)
    t = time.perf_counter()
    try:
        fit_cascade_stream(st.ShardedDataset.open(sdir), cfg, **kw)
        outcome = "certified"
    except CascadeError as e:
        outcome = f"{type(e).__name__}: {e}"
    finally:
        api.warm_start = orig
    print(json.dumps({"run": pkg, "rounds": len(calls), "outcome": outcome,
                      "seconds": time.perf_counter() - t}), flush=True)
    return calls


def _polish(pkg: str, call: dict, config) -> dict:
    if pkg == "jax":
        from dpsvm_tpu.api import warm_start
        res = warm_start(call["x"], call["y"], call["alpha_in"], config)
    else:
        from dpsvm_tpu_torch.api import warm_start
        res = warm_start(call["x"], call["y"], call["alpha_in"], config,
                         device="cpu")
    return {"alpha": np.array(res.alpha, np.float32), "b": float(res.b),
            "n_iter": int(res.n_iter), "converged": bool(res.converged)}


def _kernel64(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    d2 = ((a * a).sum(1)[:, None] + (b * b).sum(1)[None, :]
          - 2.0 * a @ b.T)
    return np.exp(-GAMMA * np.maximum(d2, 0.0))


def _f64(x_sv, coef, rows, block=2048) -> np.ndarray:
    return np.concatenate([_kernel64(rows[lo:lo + block], x_sv) @ coef
                           for lo in range(0, len(rows), block)])


def _judge(x, y, kept_idx, xk, yk, out: dict) -> dict:
    """float64 KKT gap on the kept rows, violators among the others."""
    alpha = out["alpha"].astype(np.float64)
    yk64 = yk.astype(np.float64)
    sv = alpha > 0
    coef = alpha[sv] * yk64[sv]
    fk = _f64(xk[sv], coef, xk) - yk64
    up = ((yk64 > 0) & (alpha < C)) | ((yk64 < 0) & (alpha > 0))
    low = ((yk64 > 0) & (alpha > 0)) | ((yk64 < 0) & (alpha < C))
    gap = float(fk[low].max() - fk[up].min())
    mask = np.ones(len(y), bool)
    mask[kept_idx] = False
    oidx = np.flatnonzero(mask)
    dec = _f64(xk[sv], coef, x[oidx]) - out["b"]
    yf = dec * y[oidx].astype(np.float64)
    bad = yf < 1.0 - 2.0 * EPS
    return {"n_iter": out["n_iter"], "converged": out["converged"],
            "n_sv": int(sv.sum()), "b": out["b"], "gap64": gap,
            "violators64": int(bad.sum()), "yf": yf, "oidx": oidx,
            "bad_rows": oidx[bad].tolist()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=20000)
    ap.add_argument("--dir", default=None,
                    help="a shard directory of these rows to reuse")
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    import torch
    torch.set_num_threads(4)
    from dpsvm_tpu_torch.data import stream as st
    from dpsvm_tpu_torch.data.synthetic import make_planted, save_csv

    x, y = make_planted(args.rows + 5000, 784, GAMMA, seed=0)
    x, y = x[:args.rows], np.asarray(y[:args.rows])
    with tempfile.TemporaryDirectory() as tmp:
        sdir = args.dir
        if sdir is None or not os.path.exists(
                os.path.join(sdir, st.MANIFEST_NAME)):
            sdir = sdir or os.path.join(tmp, "shards")
            save_csv(os.path.join(tmp, "rows.csv"), x, y)
            st.convert_to_shards(os.path.join(tmp, "rows.csv"), sdir,
                                 rows_per_shard=4096)
        runs = {pkg: _run(pkg, sdir) for pkg in ("jax", "port")}

    row_of = {x[i].tobytes(): i for i in range(len(y))}
    # each round's kept rows as global indices, in the order the polish
    # saw them
    kept = {pkg: [np.array([row_of[r.tobytes()] for r in c["x"]])
                  for c in calls] for pkg, calls in runs.items()}
    for pkg, other in (("jax", "port"), ("port", "jax")):
        for k, idx in enumerate(kept[pkg]):
            common = (len(np.intersect1d(idx, kept[other][k]))
                      if k < len(kept[other]) else None)
            c = runs[pkg][k]
            print(json.dumps({"run": pkg, "round": k + 1,
                              "kept": len(idx), "kept_by_other": common,
                              "n_iter": c["n_iter"],
                              "converged": c["converged"], "b": c["b"],
                              "sum_alpha_y": float(np.dot(
                                  c["alpha"].astype(np.float64),
                                  c["y"].astype(np.float64))),
                              "sum_alpha_y_in": float(np.dot(
                                  c["alpha_in"].astype(np.float64),
                                  c["y"].astype(np.float64)))}),
                  flush=True)

    # the first round (from zero duals) and the last round both runs
    # share, crossed
    last = min(len(runs["jax"]), len(runs["port"])) - 1
    for rnd in (0, last):
        judged = {}
        for state in ("jax", "port"):
            call = runs[state][rnd]
            for pol in ("jax", "port"):
                out = (call if pol == state
                       else _polish(pol, call, runs[pol][rnd]["config"]))
                out["sum_alpha_y"] = float(np.dot(
                    out["alpha"].astype(np.float64),
                    call["y"].astype(np.float64)))
                judged[(state, pol)] = out
                if rnd == last:
                    out.update(_judge(x, y, kept[state][rnd], call["x"],
                                      call["y"], out))
        bad = sorted({i for j in judged.values()
                      for i in j.get("bad_rows", [])})
        for (state, pol), j in judged.items():
            line = {"state": state, "polish": pol, "round": rnd + 1,
                    **{k: j[k] for k in ("n_iter", "converged", "b",
                                         "sum_alpha_y")}}
            if rnd == last:
                pos = {int(i): p for p, i in enumerate(j["oidx"])}
                line.update({k: j[k] for k in ("n_sv", "gap64",
                                               "violators64", "bad_rows")})
                line["yf_of_any_violator"] = {
                    str(i): (float(j["yf"][pos[i]]) if i in pos else "kept")
                    for i in bad}
            print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()

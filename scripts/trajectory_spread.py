"""How far two float32 SMO trajectories of the same problem land apart.

Trains one planted problem (default: the first 4096 rows of
make_planted(5096, 784, gamma=0.25, seed=2), C=10, eps=1e-3 — the problem
chip_smoke.py's convergence phase uses) with the JAX package's XLA path,
its NumPy oracle and the PyTorch port's plain path on the CPU, and prints
n_iter, n_sv, b and sum(alpha * y) of each, one JSON line per solver.

The reference's independent clip lets sum(alpha * y) drift, and the drift
depends on the trajectory: solvers that sum the same dot products in
another order part at a near-tie after a few hundred iterations and then
converge, each to a model whose intercept absorbed a different drift.

    PYTHONPATH=. JAX_PLATFORMS=cpu python scripts/trajectory_spread.py
"""

import argparse
import json
import time

import numpy as np


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=2)
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    import dpsvm_tpu_torch
    from dpsvm_tpu.config import SVMConfig
    from dpsvm_tpu.data.synthetic import make_planted
    from dpsvm_tpu.solver.oracle import smo_reference
    from dpsvm_tpu.solver.smo import train_single_device

    x, y = make_planted(args.n + 1000, 784, 0.25, seed=args.seed)
    x, y = x[:args.n], y[:args.n]
    kw = dict(c=10.0, gamma=0.25, epsilon=1e-3, max_iter=200_000)
    runs = {
        "jax-xla": lambda: train_single_device(x, y, SVMConfig(**kw)),
        "numpy-oracle": lambda: smo_reference(x, y, SVMConfig(**kw)),
        "torch-plain-cpu": lambda: dpsvm_tpu_torch.train(
            x, y, dpsvm_tpu_torch.SVMConfig(**kw), device="cpu"),
    }
    for name, run in runs.items():
        t0 = time.perf_counter()
        r = run()
        print(json.dumps({"solver": name, "n_iter": r.n_iter,
                          "converged": r.converged, "n_sv": r.n_sv,
                          "b": r.b, "sum_alpha_y": float(np.sum(r.alpha * y)),
                          "host_seconds": time.perf_counter() - t0}))


if __name__ == "__main__":
    main()

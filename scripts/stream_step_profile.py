"""A streamed step's time against the number of shard reads in flight.

Writes the first ``--rows`` planted rows (make_planted(rows, 784,
gamma=0.25, seed=0)) as a CSV, converts it to shards of 4096 rows, and
runs ``approx.primal.fit_approx_stream`` (approx-rff, D=1024, C=10) for
``--steps`` steps with ``_ShardReader.PREFETCH`` set to each value given
(1: one read at a time, on one worker thread). One JSON line a value: ms a
step, the host's read and verify seconds a step (summed over the
threads) and the main thread's wait for them. The weights must be the
same bits at every value: the reads run ahead, the sums stay in manifest
order.

    python3 scripts/stream_step_profile.py --prefetch 1,2,4,8
"""

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=61440)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--prefetch", default="1,2,4,8")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()

    import numpy as np

    from dpsvm_tpu_torch import SVMConfig
    from dpsvm_tpu_torch.approx import primal
    from dpsvm_tpu_torch.data import stream as st
    from dpsvm_tpu_torch.data.synthetic import make_planted

    x, y = make_planted(args.rows, 784, 0.25, seed=0)
    cfg = SVMConfig(solver="approx-rff", approx_dim=1024, c=10.0,
                    gamma=0.25, epsilon=1e-9, max_iter=args.steps,
                    chunk_iters=args.steps)
    w0 = None
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "rows.csv")
        line = "%d" + ",%.9g" * x.shape[1] + "\n"
        with open(src, "w") as fh:
            for lab, row in zip(y.tolist(), x.tolist()):
                fh.write(line % (lab, *row))
        sdir = os.path.join(tmp, "shards")
        st.convert_to_shards(src, sdir, rows_per_shard=4096)
        for k in (int(v) for v in args.prefetch.split(",")):
            primal._ShardReader.PREFETCH = k
            t = time.perf_counter()
            m, r = primal.fit_approx_stream(st.ShardedDataset.open(sdir),
                                            cfg, device=args.device)
            run = primal.RUN
            steps = max(run["steps"], 1)
            same = w0 is None or bool(np.array_equal(m.w, w0))
            w0 = m.w if w0 is None else w0
            print(json.dumps({
                "prefetch": k, "shards": run["n_shards"],
                "steps": run["steps"], "seconds": time.perf_counter() - t,
                "ms_per_step": 1e3 * run["step_seconds"] / steps,
                "read_verify_ms_per_step":
                    1e3 * run["read_seconds"] / steps,
                "read_wait_ms_per_step":
                    1e3 * run["read_wait_seconds"] / steps,
                "same_weights": same}), flush=True)


if __name__ == "__main__":
    main()

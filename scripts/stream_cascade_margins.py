"""The streaming cascade's repair rounds against its screening band.

Converts the planted rows chip_smoke.py's cascades train on (the first
20000 of make_planted(25000, 784, gamma=0.25, seed=0), C=10, eps=1e-3,
D=1024; ``--rows`` takes another count of the same generator's rows) to a
shard directory of 4096 rows a shard, and runs
``solver.cascade.fit_cascade_stream`` at each screening margin given, at
the default dual knobs (kernel A in the probe) and, with ``--decomp``,
also at q=4096, cap 128 (kernel B). One JSON line a run: the band, the
rows kept, the rounds and re-admissions, the violators left (or the
``CascadeRepairError`` when the 5 re-admission rounds run out), n_sv, the
held-out accuracy on the 5000 rows after them, and the stage seconds.

    python3 scripts/stream_cascade_margins.py --margins 0.35,0.5,1.0 [--decomp]
    python3 scripts/stream_cascade_margins.py --device cpu --margins 0.35
    python3 scripts/stream_cascade_margins.py --rows 16384,24576 \
        --approx-seeds 0,1 --margins 0.35
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
    ap.add_argument("--margins", default="0.35,0.5,1.0")
    ap.add_argument("--decomp", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--rows", default="20000")
    ap.add_argument("--approx-seeds", default="0")
    args = ap.parse_args()

    from dpsvm_tpu_torch import SVMConfig, evaluate
    from dpsvm_tpu_torch.data import stream as st
    from dpsvm_tpu_torch.data.synthetic import make_planted, save_csv
    from dpsvm_tpu_torch.solver import cascade as cs

    knobs = [("default", {})]
    if args.decomp:
        knobs.append(("decomp", dict(working_set=4096, inner_iters=128)))
    for rows in (int(r) for r in args.rows.split(",")):
        x, y = make_planted(rows + 5000, 784, 0.25, seed=0)
        xtr, ytr, xte, yte = x[:rows], y[:rows], x[rows:], y[rows:]
        with tempfile.TemporaryDirectory() as tmp:
            src = os.path.join(tmp, "rows.csv")
            save_csv(src, xtr, ytr)
            sdir = os.path.join(tmp, "shards")
            st.convert_to_shards(src, sdir, rows_per_shard=4096)
            for seed in (int(v) for v in args.approx_seeds.split(",")):
                for margin in (float(m) for m in args.margins.split(",")):
                    for tag, kw in knobs:
                        out = {"rows": rows, "approx_seed": seed,
                               "margin": margin, "knobs": tag,
                               "device": args.device}
                        cfg = SVMConfig(solver="cascade", approx_dim=1024,
                                        c=10.0, gamma=0.25, epsilon=1e-3,
                                        screen_margin=margin,
                                        approx_seed=seed,
                                        max_iter=600_000, **kw)
                        out.update(_run(cs, st, evaluate, sdir, cfg,
                                        args.device, xte, yte))
                        print(json.dumps(out), flush=True)


def _run(cs, st, evaluate, sdir, cfg, device, xte, yte) -> dict:
    out = {}
    t = time.perf_counter()
    try:
        m, r = cs.fit_cascade_stream(st.ShardedDataset.open(sdir), cfg,
                                     device=device)
        out.update(n_band=r.n_band, n_kept=r.n_kept,
                   rounds=r.readmit_rounds, readmitted=r.n_readmitted,
                   violators=r.kkt_violators, n_sv=m.n_sv,
                   heldout_accuracy=evaluate(m, xte, yte, device=device),
                   stage_seconds=r.stage_seconds)
    except cs.CascadeRepairError as e:
        out["error"] = str(e)
    out["seconds"] = time.perf_counter() - t
    return out


if __name__ == "__main__":
    main()

"""The port's data layer (port of ``dpsvm_tpu/data``): dense CSV and libsvm
loaders with the native C++ fast path (``loader``), synthetic fixtures
(``synthetic``), the reference's converters (``convert``), svm-scale
(``scale``) and the out-of-core shard directories (``stream``).

``python -m dpsvm_tpu_torch.data --selfcheck [--device cpu]`` runs the
streaming story end to end on an embedded sample: convert -> verify ->
materialize; a conversion stopped after two shards resumes to a
byte-identical manifest; a streaming fit with one corrupt shard
(quarantined, its event drained at a poll) and one transient read failure
(retried); a streaming fit cut at a checkpoint resumes bitwise; the
memory-budget refusal names the shard math; the live-append gate: a
torn publish is never read (the watcher holds its view) and is repaired by
the next append, a stale generation is refused, clean publishes are
admitted, and a live fit cut at a checkpoint after an admission resumes
bitwise (``data/live.py``).
"""

from __future__ import annotations

import sys
from typing import List, Optional

from dpsvm_tpu_torch.data.loader import (csv_shape, load_csv, load_dataset,
                                         load_libsvm, sniff_format)
from dpsvm_tpu_torch.data.synthetic import make_blobs, make_xor

__all__ = ["load_csv", "load_libsvm", "load_dataset", "sniff_format",
           "csv_shape", "make_blobs", "make_xor", "selfcheck", "main"]


def selfcheck(tmp_dir: Optional[str] = None, device=None) -> List[str]:
    """Run the streaming data pipeline end to end; return the problems
    found (empty = healthy). ``device`` None means the GPU."""
    import os
    import tempfile

    import numpy as np

    problems: List[str] = []
    ctx = tempfile.TemporaryDirectory() if tmp_dir is None else None
    base = tmp_dir if tmp_dir is not None else ctx.name
    try:
        from dpsvm_tpu_torch.approx.model import decision_function
        from dpsvm_tpu_torch.approx.primal import fit_approx_stream
        from dpsvm_tpu_torch.config import SVMConfig
        from dpsvm_tpu_torch.data import stream as streamlib
        from dpsvm_tpu_torch.data.synthetic import save_csv
        from dpsvm_tpu_torch.resilience import faultinject
        from dpsvm_tpu_torch.solver import driver

        x, y = make_blobs(n=384, d=6, seed=7)
        src = os.path.join(base, "blobs.csv")
        save_csv(src, x, y)

        # 1. convert -> open -> verify -> materialize.
        sdir = os.path.join(base, "shards")
        streamlib.convert_to_shards(src, sdir, rows_per_shard=96)
        ds = streamlib.ShardedDataset.open(sdir)
        if ds.n != len(y) or ds.n_shards != 4:
            problems.append(f"conversion shape: n={ds.n} "
                            f"shards={ds.n_shards} (wanted 384/4)")
        bad = ds.verify()
        if bad:
            problems.append(f"fresh shards failed verify: {bad}")
        xm, ym = ds.materialize()
        if not (np.array_equal(xm, x) and np.array_equal(ym, y)):
            problems.append("materialized rows != source rows")

        # 2. a conversion stopped after 2 shards resumes to a
        # byte-identical manifest.
        kdir = os.path.join(base, "shards_killed")
        partial = streamlib.convert_to_shards(src, kdir, rows_per_shard=96,
                                              _stop_after_shards=2)
        if os.path.exists(os.path.join(kdir, streamlib.MANIFEST_NAME)):
            problems.append("killed conversion left a manifest")
        if partial.get("rows_done") != 192:
            problems.append(f"cursor rows_done {partial.get('rows_done')}"
                            " != 192")
        streamlib.convert_to_shards(src, kdir, rows_per_shard=96)
        with open(os.path.join(sdir, streamlib.MANIFEST_NAME), "rb") as f:
            a = f.read()
        with open(os.path.join(kdir, streamlib.MANIFEST_NAME), "rb") as f:
            b = f.read()
        if a != b:
            problems.append("resumed manifest is not byte-identical")

        # 3. the drill: one corrupt shard (quarantined, its event drained
        # at a poll), one transient read failure (retried).
        cfg = SVMConfig(solver="approx-rff", approx_dim=64, c=10.0,
                        epsilon=5e-3, max_iter=600, chunk_iters=64,
                        on_bad_shard="quarantine", mem_budget_mb=64.0)
        prior = faultinject.current()
        faultinject.install(faultinject.FaultPlan(io_corrupt_shard=2,
                                                  io_read_fail_once=3))
        try:
            model, _ = fit_approx_stream(ds, cfg, device=device)
        finally:
            faultinject.install(prior)
        if 1 not in ds.quarantined:
            problems.append(f"corrupt shard 2 not quarantined "
                            f"({ds.quarantined})")
        quar = [e for e, kw in driver.EVENTS if e == "quarantine"
                and kw.get("shard") == 1]
        if not quar:
            problems.append("no quarantine event drained by the run")
        pred = np.where(decision_function(model, x, device=device) < 0,
                        -1, 1)
        acc = float(np.mean(pred == y))
        if acc < 0.9:
            problems.append(f"stream-trained accuracy {acc:.3f} < 0.9 "
                            "(despite one quarantined shard)")

        # 4. a streaming fit cut at a checkpoint resumes bitwise.
        base_cfg = dict(solver="approx-rff", approx_dim=64, c=10.0,
                        epsilon=1e-6, max_iter=96, chunk_iters=32)
        m_full, _ = fit_approx_stream(streamlib.ShardedDataset.open(sdir),
                                      SVMConfig(**base_cfg), device=device)
        ck = os.path.join(base, "stream_ck.npz")
        fit_approx_stream(streamlib.ShardedDataset.open(sdir),
                          SVMConfig(**dict(base_cfg, max_iter=32),
                                    checkpoint_path=ck,
                                    checkpoint_every=32), device=device)
        m_res, r_res = fit_approx_stream(
            streamlib.ShardedDataset.open(sdir),
            SVMConfig(resume_from=ck, **base_cfg), device=device)
        if not (np.array_equal(m_full.w, m_res.w) and r_res.n_iter == 96):
            problems.append(
                "streaming resume is not bitwise-identical "
                f"(max delta {float(np.max(np.abs(m_full.w - m_res.w)))})")
        if not any(e == "ingest_resume" for e, _ in driver.EVENTS):
            problems.append("the resumed run drained no ingest_resume")

        # 5. the budget guard names the shard math.
        try:
            ds.materialize(mem_budget_mb=0.001)
            problems.append("mem-budget guard admitted an over-budget "
                            "materialization")
        except streamlib.MemBudgetError as e:
            if "rows" not in str(e) or "shards" not in str(e):
                problems.append(f"budget refusal lacks the shard math: "
                                f"{e}")

        # 6. the live-append gate: a torn publish is never read (the
        # watcher holds its view), a stale generation is refused, clean
        # publishes are admitted, and a live fit cut at a checkpoint after
        # an admission resumes bitwise.
        from dpsvm_tpu_torch.data import live as livelib

        ldir = os.path.join(base, "livelog")
        streamlib.convert_to_shards(src, ldir, rows_per_shard=96)
        ds_l = streamlib.ShardedDataset.open(ldir)
        watcher = livelib.ShardLogWatcher(ds_l)
        faultinject.install(faultinject.FaultPlan(live_torn_publish=1))
        try:
            livelib.append_shard(ldir, x[:96], y[:96])
            problems.append("torn publish did not crash the writer")
        except livelib.WriterCrashError:
            pass
        finally:
            faultinject.install(prior)
        if watcher.poll() or ds_l.generation != 0:
            problems.append("watcher advanced on a TORN publish")
        if watcher.torn_observed != 1:
            problems.append(f"torn publish not observed "
                            f"({watcher.torn_observed})")
        livelib.append_shard(ldir, x[:96], y[:96])   # repairs the log
        watcher.poll()
        if ds_l.generation != 1 or ds_l.n != 480:
            problems.append(f"repaired publish not admitted (gen "
                            f"{ds_l.generation}, n {ds_l.n})")
        # the watcher is at generation 1: a replayed generation-1 publish
        # with other content is refused
        faultinject.install(faultinject.FaultPlan(live_stale_generation=1))
        try:
            livelib.append_shard(ldir, x[96:160], y[96:160])
        finally:
            faultinject.install(prior)
        watcher.poll()
        if ds_l.generation != 1 or watcher.stale_observed < 1:
            problems.append(
                f"stale-generation publish not refused (gen "
                f"{ds_l.generation}, stale {watcher.stale_observed})")
        # the next clean publish carries the stale-published shard and the
        # new one, admitted together
        livelib.append_shard(ldir, x[160:200], y[160:200])
        watcher.poll()
        if ds_l.generation != 2 or ds_l.n != 384 + 96 + 64 + 40:
            problems.append(f"clean publishes not admitted (gen "
                            f"{ds_l.generation}, n {ds_l.n})")
        live_cfg = dict(base_cfg, max_iter=64)
        m_live, _ = fit_approx_stream(
            streamlib.ShardedDataset.open(ldir, at_generation=0),
            SVMConfig(**live_cfg), live=True, device=device)
        lck = os.path.join(base, "live_ck.npz")
        fit_approx_stream(
            streamlib.ShardedDataset.open(ldir, at_generation=0),
            SVMConfig(**dict(live_cfg, max_iter=32), checkpoint_path=lck,
                      checkpoint_every=32), live=True, device=device)
        ds_r = streamlib.ShardedDataset.open(ldir, at_generation=0)
        m_lres, _ = fit_approx_stream(
            ds_r, SVMConfig(resume_from=lck, **live_cfg), live=True,
            device=device)
        if not (np.array_equal(m_live.w, m_lres.w)
                and ds_r.generation == 2):
            problems.append(
                "live resume across an admission is not bitwise "
                f"(generation {ds_r.generation}, max delta "
                f"{float(np.max(np.abs(m_live.w - m_lres.w)))})")
    except Exception as e:              # noqa: BLE001 - the gate reports
        import traceback
        traceback.print_exc()
        problems.append(f"selfcheck crashed: {type(e).__name__}: {e}")
    finally:
        if ctx is not None:
            ctx.cleanup()
    return problems


def main(argv: Optional[List[str]] = None) -> int:
    """``python -m dpsvm_tpu_torch.data --selfcheck`` entry point."""
    import argparse

    p = argparse.ArgumentParser(prog="python -m dpsvm_tpu_torch.data")
    p.add_argument("--selfcheck", action="store_true",
                   help="run the streaming-data gate")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the streaming fits run (default: the GPU)")
    args = p.parse_args(argv)
    if not args.selfcheck:
        p.print_help()
        return 2
    problems = selfcheck(device=args.device)
    if problems:
        for q in problems:
            print(f"SELFCHECK FAIL: {q}", file=sys.stderr)
        return 1
    print("data selfcheck OK: convert + verify + byte-identical manifest "
          "resume + stream-train with a quarantined shard and a retried "
          "read + bitwise streaming resume + budget refusal + live "
          "append gate (torn, stale, bitwise live resume)")
    return 0

"""Ledger-driven tuning (port of ``dpsvm_tpu/tuning``): measure the
hand-set knobs on this device, persist the winners per device kind,
resolve them at config time.

* ``tuner``   — ``dpsvm tune``: deterministic, deadline-bounded
                successive-halving probes over a bounded grid a knob,
                each probe a short run through the driver or the serving
                engine (traces, capture accounting and the metrics
                registry come with it), rates without capture and build
                seconds, and an end-to-end ``tuned_vs_default`` A/B run
                gated by ``compare`` and appended to the perf ledger.
* ``profile`` — the persisted profile, one entry a device kind (the
                card's name, or ``cpu``) with its git sha, timestamp,
                probe rows and measured win, and its resolution:
                explicit value > tuned profile > built-in default,
                ``--no-tuned`` / ``DPSVM_NO_TUNED=1`` opt out, an entry
                of another device never applies. ``doctor`` prints the
                active entry.

``python -m dpsvm_tpu_torch.tuning --selfcheck [--device cpu]`` checks
(1) that a real tiny-grid tune run persists a provenance-valid entry
keyed by the device, whose probe rows carry traces and land in the perf
ledger; (2) that resolution picks a planted profile up, that explicit
values and the opt-outs win over it, and that an entry of another device
is never applied; (3) that the comparison rejects a planted
slower-than-default candidate, at the selection rule and through a full
successive-halving round.
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional

__all__ = ["main", "selfcheck"]


def selfcheck(tmp_dir: Optional[str] = None, device=None) -> List[str]:
    """Returns a list of problems (empty = the gate passes)."""
    import json
    import tempfile
    import time

    problems: List[str] = []
    ctx = tempfile.TemporaryDirectory() if tmp_dir is None else None
    base = tmp_dir if tmp_dir is not None else ctx.name
    old_ledger = os.environ.get("DPSVM_PERF_LEDGER")
    old_noenv = os.environ.pop("DPSVM_NO_TUNED", None)
    ledger_path = os.path.join(base, "ledger.jsonl")
    os.environ["DPSVM_PERF_LEDGER"] = ledger_path
    try:
        from dpsvm_tpu_torch.config import SVMConfig
        from dpsvm_tpu_torch.data.synthetic import make_blobs
        from dpsvm_tpu_torch.device import resolve_device
        from dpsvm_tpu_torch.observability import ledger as ledgerlib
        from dpsvm_tpu_torch.tuning import profile as prof
        from dpsvm_tpu_torch.tuning import tuner

        dev = resolve_device(device)
        dk = prof.current_device_kind(dev)
        logged: List[str] = []
        x, y = make_blobs(n=800, d=16, seed=0, separation=0.5)
        base_cfg = SVMConfig(c=10.0, epsilon=1e-5, max_iter=100_000)
        out = os.path.join(base, "tuned_profile.json")

        # (1) a real tiny-grid tune run -> a provenance-valid entry
        entry, rc = tuner.run_tune(
            x, y, base_config=base_cfg, knobs=("chunk_iters",),
            grids={"chunk_iters": (128, 512)}, probe_iters=400,
            rungs=2, deadline_s=180.0, min_win_pct=1.0,
            profile_out=out, trace_dir=os.path.join(base, "traces"),
            device=dev, log=logged.append)
        if rc != 0:
            problems.append(f"tiny tune run exited {rc}")
        saved = prof.load_profiles(out).get(dk)
        if saved is None:
            problems.append(f"profile has no entry for device {dk!r}")
        else:
            bad = prof.validate_entry(saved)
            if bad:
                problems.append(f"persisted entry invalid: {bad}")
            if not saved.get("probes"):
                problems.append("entry carries no probe rows")
            elif not any(p.get("trace") for p in saved["probes"]):
                problems.append("no probe row carries a trace pointer")
        rows = (ledgerlib.read(ledger_path)
                if os.path.exists(ledger_path) else [])
        if not any(r.get("kind") == "tune"
                   and r.get("case") == "tune_probe_chunk_iters"
                   for r in rows):
            problems.append("ledger has no tune_probe_chunk_iters row")

        # (2) resolution picks a planted profile up; precedence and
        # invalidation hold
        planted_path = os.path.join(base, "planted_profile.json")
        prof.save_entry(prof.make_entry(dk, {"chunk_iters": 2048}),
                        planted_path)
        cfg, applied = prof.apply_tuned(SVMConfig(), device_kind=dk,
                                        path=planted_path)
        if applied != {"chunk_iters": 2048} or cfg.chunk_iters != 2048:
            problems.append(f"resolution did not pick up the planted "
                            f"profile (applied={applied})")
        cfg, applied = prof.apply_tuned(SVMConfig(), explicit={
            "chunk_iters"}, device_kind=dk, path=planted_path)
        if applied or cfg.chunk_iters != 512:
            problems.append("explicit CLI knob did not win over the "
                            "profile")
        cfg, applied = prof.apply_tuned(SVMConfig(chunk_iters=64),
                                        device_kind=dk, path=planted_path)
        if applied or cfg.chunk_iters != 64:
            problems.append("non-default config value did not win over "
                            "the profile")
        os.environ["DPSVM_NO_TUNED"] = "1"
        try:
            if prof.active_entry(dk, path=planted_path) is not None:
                problems.append("DPSVM_NO_TUNED=1 did not opt out")
        finally:
            os.environ.pop("DPSVM_NO_TUNED", None)
        other = "cpu" if dk != "cpu" else "NVIDIA H100 80GB HBM3"
        mism_path = os.path.join(base, "mismatch_profile.json")
        prof.save_entry(prof.make_entry(other, {"chunk_iters": 9}),
                        mism_path)
        cfg, applied = prof.apply_tuned(SVMConfig(), device_kind=dk,
                                        path=mism_path)
        if applied:
            problems.append(f"an entry of {other!r} was applied on "
                            f"{dk!r}")
        # provenance or nothing: without git_sha the entry must not apply
        broken = prof.make_entry(dk, {"chunk_iters": 7})
        broken["git_sha"] = ""
        broken_path = os.path.join(base, "broken.json")
        with open(broken_path, "w") as fh:
            json.dump({"schema": prof.PROFILE_SCHEMA,
                       "profiles": {dk: broken}}, fh)
        if prof.active_entry(dk, path=broken_path):
            problems.append("entry without git_sha provenance was "
                            "accepted")
        if prof.provenance_tag(dk, path=planted_path) is None:
            problems.append("provenance_tag returned None for an active "
                            "entry")

        # (3) a planted slower-than-default candidate is rejected, at the
        # rule and through a full halving round
        w, imp = tuner.select_winner(512, {512: 100.0, 2048: 80.0}, 2.0)
        if imp or w != 512:
            problems.append("select_winner accepted a slower-than-"
                            "default candidate")
        planted_rates = {512: 100.0, 128: 60.0, 2048: 90.0}

        def fake_measure(v, budget, rung):
            return ledgerlib.make_record(
                "tune_probe_chunk_iters",
                {"knob": "chunk_iters", "candidate": int(v),
                 "rung": int(rung), "budget_iters": int(budget)},
                kind="tune", value=planted_rates[v], unit="iter/s")

        final, _ = tuner.successive_halving(
            (128, 2048), 512, fake_measure, (100, 200),
            time.monotonic() + 60.0, lambda s: None)
        w, imp = tuner.select_winner(512, final, 2.0)
        if imp or w != 512:
            problems.append("successive halving + comparison accepted a "
                            f"planted slower-than-default grid (winner {w})")
    except Exception as e:                  # noqa: BLE001
        import traceback
        traceback.print_exc()
        problems.append(f"selfcheck crashed: {type(e).__name__}: {e}")
    finally:
        if old_ledger is None:
            os.environ.pop("DPSVM_PERF_LEDGER", None)
        else:
            os.environ["DPSVM_PERF_LEDGER"] = old_ledger
        if old_noenv is not None:
            os.environ["DPSVM_NO_TUNED"] = old_noenv
        if ctx is not None:
            ctx.cleanup()
    return problems


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="python -m dpsvm_tpu_torch.tuning")
    p.add_argument("--selfcheck", action="store_true",
                   help="run the tuning gate (see the module docstring)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to run it (default: the GPU)")
    args = p.parse_args(argv)
    if not args.selfcheck:
        p.print_help()
        return 2
    problems = selfcheck(device=args.device)
    if problems:
        print("tuning selfcheck FAILED:", file=sys.stderr)
        for prob in problems:
            print(f"  - {prob}", file=sys.stderr)
        return 1
    print("tuning selfcheck OK")
    return 0

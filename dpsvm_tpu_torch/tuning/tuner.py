"""``dpsvm tune``: deterministic, deadline-bounded knob measurement (port
of ``dpsvm_tpu/tuning/tuner.py``), the acting half of the measure -> act
loop.

Every throughput-critical knob started as a hand-set constant
(``chunk_iters=512``, ``cache_size=0``, the serving ladder's
``max_batch=256``). The tuner measures them on this machine's device:

* **Probes ride the existing plumbing.** A train probe is a short,
  seeded run through ``api.train`` (the shared host driver) with
  ``trace_out`` armed, so every probe gets its run trace, the capture and
  build accounting and the metrics-registry feed. Its rate leaves out the
  seconds of graph captures and kernel builds (``_trace_compile_seconds``
  says which records those are, and why that differs from the JAX
  package). A serving probe drives a warmed ``PredictionEngine`` ladder
  (one CUDA graph a bucket on the card) with a fixed request-size
  schedule. Every timed window ends on a host read: ``api.train``
  returns after its last stats read, ``decision_values`` returns numpy.
* **Successive halving over a bounded grid.** Each knob gets a small
  value grid and a geometric budget ladder: every rung measures the
  survivors at double the previous budget and keeps the faster half. The
  built-in default always survives to the final rung, and a winner must
  beat the measured default by ``min_win_pct`` on the same budget, so a
  planted slower-than-default candidate cannot win.
* **Deadline-bounded.** The whole run carries one wall deadline; when it
  expires, finished knobs keep their verdicts and unfinished knobs keep
  their defaults, and the run says so.
* **The win is proved end to end, then persisted.** After the per-knob
  grids, one A/B run (built-in defaults against the tuned knob set, same
  data, same iteration budget, a trace each) measures the combined
  effect; the speedup is a ``tuned_vs_default`` perf-ledger row (kind
  ``tune``) gated by ``compare``'s regression verdicts. A combined set
  the A/B run does not confirm is not persisted.

There is no quiet fallback: a probe that fails fails the tune run, and on
the card every probe runs on the card.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

#: bounded default grids (the default value of each knob is always
#: forced into its grid, so the comparison is always anchored).
DEFAULT_GRIDS: Dict[str, Tuple[int, ...]] = {
    "chunk_iters": (128, 256, 512, 1024, 2048, 4096),
    "cache_lines": (0, 64, 256, 1024),
    "serve_max_batch": (64, 128, 256, 512),
}

#: built-in defaults the winners must beat (SVMConfig field defaults for
#: the train knobs; the serve parser's constant for the ladder top).
KNOB_DEFAULTS = {"chunk_iters": 512, "cache_lines": 0,
                 "serve_max_batch": 256}

TRAIN_KNOB_FIELDS = {"chunk_iters": "chunk_iters",
                     "cache_lines": "cache_size"}

#: deterministic request-size schedule of the serving probe: fixed
#: absolute sizes (independent of the candidate rung) from single rows
#: to multi-pass requests, so every candidate serves the same work.
SERVE_SIZES = (1, 3, 8, 17, 40, 64, 96, 160, 256, 384, 512, 700)

#: trace ``compile`` programs that run no iteration: the chunk graphs'
#: captures (``solver/smo.capture``) by name; the serving ladder's
#: captures and the ``nvcc`` builds (``build.py``) by prefix.
SETUP_PROGRAMS = ("smo-chunk", "ovo-chunk", "primal-chunk",
                  "dist-smo-chunk")
SETUP_PREFIXES = ("build:", "serve-bucket/")


class DeadlineExpired(Exception):
    """Control flow: the tune deadline ran out mid-knob."""


def _remaining(deadline_ts: float) -> float:
    return deadline_ts - time.monotonic()


def _registry_facts() -> dict:
    """Single-series ``dpsvm_train_*`` gauge readings from the process
    metrics registry (the training driver feeds it). A missing instrument
    reads as absent, never as a probe failure."""
    out = {}
    try:
        from dpsvm_tpu_torch.observability.metrics import default_registry
        snap = default_registry().snapshot()
        for name in ("dpsvm_train_iterations",
                     "dpsvm_train_iters_per_sec",
                     "dpsvm_train_gap"):
            fam = snap.get(name) or {}
            series = fam.get("series") or []
            if len(series) == 1 and "value" in series[0]:
                out[name] = series[0]["value"]
    except Exception:
        pass
    return out


def is_setup_program(program: str) -> bool:
    """Whether a trace ``compile`` record holds no solver work: an
    ``nvcc`` build (``build:<lib>``) or a graph capture."""
    return (program in SETUP_PROGRAMS
            or program.startswith(SETUP_PREFIXES))


def _trace_compile_seconds(trace_path: Optional[str]) -> float:
    """Seconds of a probe's trace that hold no solver work (0.0 when
    untraced or unreadable: the correction degrades to the raw time).

    In the JAX package every ``compile`` record is XLA compilation, all of
    it meant to be subtracted (its reader import names ``record``, which
    has no ``read_trace``, so it subtracts nothing). In the port a record
    is one of two kinds.
    Builds (``build:*``) and graph captures (``smo-chunk``, ``ovo-chunk``,
    ``primal-chunk``, ``dist-smo-chunk``, ``serve-bucket/...``) run no
    iteration, and they are subtracted. A runner's observed first call
    (``fused-chunk``: the enqueue of ``chunk_iters`` kernel-A launches on
    the card, a whole plain chunk on the CPU; ``decomp-chunk/q=...``: a
    whole round) is real work whose iterations the probe counts, so it is
    not: subtracting it would credit large chunks with free iterations."""
    if not trace_path or not os.path.exists(trace_path):
        return 0.0
    try:
        from dpsvm_tpu_torch.observability.schema import read_trace
        records = read_trace(trace_path)
    except Exception:
        return 0.0
    return float(sum(r.get("seconds") or 0.0 for r in records
                     if r.get("kind") == "compile"
                     and is_setup_program(str(r.get("program", "")))))


def probe_train(x, y, base_config, knob: str, value: int,
                budget_iters: int, rung: int,
                trace_dir: Optional[str] = None, device=None) -> dict:
    """One train probe: a short seeded run through the shared host driver
    at ``knob=value``, returning a ledger-shaped probe row with the
    corrected rate. The rate divides the iterations by the host loop's
    seconds (``train_seconds``), or by the wall less capture and build
    seconds where that is shorter: a graph is captured before the loop
    starts, a first build inside it."""
    from dpsvm_tpu_torch.api import train
    from dpsvm_tpu_torch.observability import ledger

    field = TRAIN_KNOB_FIELDS[knob]
    trace_out = None
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        trace_out = os.path.join(
            trace_dir, f"probe_{knob}_{value}_r{rung}.jsonl")
    cfg = dataclasses.replace(
        base_config, **{field: int(value)}, max_iter=int(budget_iters),
        trace_out=trace_out, verbose=False)
    t0 = time.perf_counter()
    r = train(x, y, cfg, device=device)
    wall = time.perf_counter() - t0
    compile_s = _trace_compile_seconds(trace_out)
    eff = max(min(r.train_seconds, wall - compile_s), 1e-9)
    rate = r.n_iter / eff
    metrics = {
        "knob": knob, "candidate": int(value), "rung": int(rung),
        "budget_iters": int(budget_iters), "n_iter": int(r.n_iter),
        "seconds": round(r.train_seconds, 4),
        "compile_seconds": round(compile_s, 4),
        "rate": round(rate, 2), "converged": bool(r.converged),
        "registry": _registry_facts(),
    }
    return ledger.make_record(f"tune_probe_{knob}", metrics,
                              kind="tune", value=round(rate, 2),
                              unit="iter/s", direction="higher",
                              trace=trace_out)


def probe_serve(model, max_batch: int, rung: int, repeats: int,
                rows, device=None) -> dict:
    """One serving probe: a warmed ``PredictionEngine`` at the candidate
    top rung, timed over the fixed request-size schedule (``repeats`` full
    passes). The ladder's captures happen at construction, outside the
    timed window."""
    from dpsvm_tpu_torch.observability import ledger
    from dpsvm_tpu_torch.serving.engine import PredictionEngine

    eng = PredictionEngine(model, name="tune-probe",
                           max_batch=int(max_batch), device=device)
    total_rows = 0
    t0 = time.perf_counter()
    for _ in range(int(repeats)):
        for m in SERVE_SIZES:
            eng.decision_values(rows[:m])
            total_rows += m
    dt = max(time.perf_counter() - t0, 1e-9)
    rate = total_rows / dt
    metrics = {
        "knob": "serve_max_batch", "candidate": int(max_batch),
        "rung": int(rung), "repeats": int(repeats),
        "rows": int(total_rows), "seconds": round(dt, 4),
        "rate": round(rate, 1),
        "warmup_compiles": int(eng.warmup_captures),
        "buckets": list(eng.buckets),
    }
    return ledger.make_record("tune_probe_serve_max_batch", metrics,
                              kind="tune", value=round(rate, 1),
                              unit="rows/s", direction="higher")


def select_winner(default_value: int, rates: Dict[int, float],
                  min_win_pct: float) -> Tuple[int, bool]:
    """The fastest candidate wins only when it beats the measured default
    by ``min_win_pct`` percent on the same budget; otherwise the default
    stands. A candidate slower than the default is never selected."""
    if default_value not in rates:
        raise ValueError(
            f"default {default_value} was not measured at the final "
            f"rung (measured: {sorted(rates)}) — the comparison is "
            "unanchored")
    base = rates[default_value]
    best = max(rates, key=lambda v: rates[v])
    if best == default_value:
        return default_value, False
    if rates[best] < base * (1.0 + float(min_win_pct) / 100.0):
        return default_value, False
    return int(best), True


def successive_halving(values: Sequence[int], default_value: int,
                       measure: Callable[[int, int, int], dict],
                       budgets: Sequence[int], deadline_ts: float,
                       log: Callable[[str], None]
                       ) -> Tuple[Dict[int, float], List[dict]]:
    """Halving rounds over ``values``: every rung measures the survivors
    at ``budgets[rung]`` and keeps the faster half; the default always
    survives, so the final comparison stays anchored. Raises
    DeadlineExpired when the wall budget runs out (the caller keeps the
    default for this knob)."""
    alive = list(dict.fromkeys(list(values) + [default_value]))
    probes: List[dict] = []
    rung_rates: Dict[int, float] = {}
    for rung, budget in enumerate(budgets):
        rung_rates = {}
        for v in list(alive):
            if _remaining(deadline_ts) <= 0:
                raise DeadlineExpired(
                    f"deadline expired at rung {rung} "
                    f"({len(probes)} probe(s) done)")
            row = measure(v, int(budget), rung)
            probes.append(row)
            rung_rates[v] = float(row["value"])
        alive.sort(key=lambda v: -rung_rates[v])
        if rung < len(budgets) - 1:
            keep = max(2, math.ceil(len(alive) / 2))
            cut = alive[keep:]
            alive = alive[:keep]
            if default_value not in alive:
                alive.append(default_value)
            cut = [v for v in cut if v not in alive]
            if cut:
                log(f"  rung {rung}: kept {alive}, cut {cut}")
    # Only the final rung's readings anchor the verdict: every surviving
    # value (the default included) was measured at the same budget.
    return dict(rung_rates), probes


def run_tune(x, y, *, base_config=None, knobs: Sequence[str] = (),
             grids: Optional[Dict[str, Sequence[int]]] = None,
             probe_iters: int = 2000, rungs: int = 3,
             deadline_s: float = 300.0, min_win_pct: float = 2.0,
             profile_out: Optional[str] = None,
             trace_dir: Optional[str] = None, ledger_on: bool = True,
             device=None,
             log: Callable[[str], None] = print) -> Tuple[dict, int]:
    """The full tune run (see the module docstring) on ``device`` (None:
    the card; a missing card raises). The entry is keyed by that device's
    kind. Returns ``(profile_entry, exit_code)``: 0 = a profile was
    persisted (tuned or default-confirming), 1 = the deadline expired
    before any knob finished."""
    import json

    import numpy as np

    from dpsvm_tpu_torch.api import fit, train
    from dpsvm_tpu_torch.config import SVMConfig
    from dpsvm_tpu_torch.device import resolve_device
    from dpsvm_tpu_torch.observability import ledger
    from dpsvm_tpu_torch.tuning import profile as prof

    dev = resolve_device(device)
    base_config = base_config or SVMConfig()
    knobs = list(knobs) or list(DEFAULT_GRIDS)
    grids = {**DEFAULT_GRIDS, **(grids or {})}
    deadline_ts = time.monotonic() + float(deadline_s)
    dk = prof.current_device_kind(dev)
    if trace_dir is None:
        # beside the resolved profile file
        out_hint = prof.profile_path(profile_out)
        if out_hint:
            trace_dir = os.path.join(
                os.path.dirname(os.path.abspath(out_hint)) or ".",
                "traces", "tune")
    budgets = [int(probe_iters) * (2 ** r) for r in range(max(1, rungs))]
    log(f"tune: device {dk!r}, knobs {knobs}, rung budgets {budgets}, "
        f"deadline {deadline_s:g}s")

    def _ledger(row):
        if not ledger_on:
            return
        try:
            path = ledger.ledger_path()
            if path is None:
                return
            os.makedirs(os.path.dirname(os.path.abspath(path)) or ".",
                        exist_ok=True)
            with open(path, "a") as fh:
                fh.write(json.dumps(row) + "\n")
        except OSError:
            pass

    # Warmup: the kernel builds, the library loads and the first launches
    # of the default path are paid before any timed probe.
    train(x, y, dataclasses.replace(base_config, max_iter=64,
                                    verbose=False), device=dev)

    tuned: Dict[str, int] = {}
    all_probes: List[dict] = []
    finished = 0
    cfg = base_config
    for knob in [k for k in knobs if k in TRAIN_KNOB_FIELDS]:
        default_v = KNOB_DEFAULTS[knob]
        log(f"tune: {knob} over {sorted(set(grids[knob]))} "
            f"(default {default_v})")

        def measure(v, budget, rung, _knob=knob, _cfg=cfg):
            row = probe_train(x, y, _cfg, _knob, v, budget, rung,
                              trace_dir=trace_dir, device=dev)
            log(f"  {_knob}={v} rung {rung}: "
                f"{row['metrics']['rate']:,.0f} it/s "
                f"({row['metrics']['n_iter']} iters, "
                f"{row['metrics']['seconds']:.3f}s wall, "
                f"{row['metrics']['compile_seconds']:.3f}s compile)")
            _ledger(row)
            return row

        try:
            final, probes = successive_halving(
                grids[knob], default_v, measure, budgets, deadline_ts, log)
        except DeadlineExpired as e:
            log(f"tune: {knob}: {e} — keeping the default")
            continue
        all_probes.extend(probes)
        winner, improved = select_winner(default_v, final, min_win_pct)
        finished += 1
        if improved:
            gain = (final[winner] / final[default_v] - 1.0) * 100.0
            log(f"tune: {knob}: {winner} beats default {default_v} "
                f"by {gain:.1f}% -> tuned")
            tuned[knob] = winner
            cfg = dataclasses.replace(
                cfg, **{TRAIN_KNOB_FIELDS[knob]: winner})
        else:
            log(f"tune: {knob}: default {default_v} stands "
                f"(best candidate within {min_win_pct:g}%)")

    if "serve_max_batch" in knobs and _remaining(deadline_ts) > 0:
        log(f"tune: serve_max_batch over "
            f"{sorted(set(grids['serve_max_batch']))} (default "
            f"{KNOB_DEFAULTS['serve_max_batch']})")
        n_model = min(len(y), 2000)
        model, _ = fit(x[:n_model], y[:n_model],
                       dataclasses.replace(cfg, max_iter=20_000,
                                           trace_out=None, verbose=False),
                       device=dev)
        rng = np.random.default_rng(0)
        rows = np.asarray(
            rng.standard_normal((max(SERVE_SIZES), x.shape[1])),
            np.float32)

        def measure_serve(v, budget, rung):
            # the budget is in iterations: repeats of the schedule scale
            # with it so that rungs stay comparable
            repeats = max(1, budget // int(probe_iters))
            row = probe_serve(model, v, rung, repeats, rows, device=dev)
            log(f"  serve_max_batch={v} rung {rung}: "
                f"{row['metrics']['rate']:,.0f} rows/s")
            _ledger(row)
            return row

        try:
            final, probes = successive_halving(
                grids["serve_max_batch"],
                KNOB_DEFAULTS["serve_max_batch"], measure_serve,
                budgets, deadline_ts, log)
            all_probes.extend(probes)
            winner, improved = select_winner(
                KNOB_DEFAULTS["serve_max_batch"], final, min_win_pct)
            finished += 1
            if improved:
                tuned["serve_max_batch"] = winner
                log(f"tune: serve_max_batch: {winner} -> tuned")
            else:
                log("tune: serve_max_batch: default stands")
        except DeadlineExpired as e:
            log(f"tune: serve_max_batch: {e} — keeping the default")

    if finished == 0:
        log("tune: deadline expired before any knob finished — "
            "nothing to persist")
        return {}, 1

    # End-to-end A/B: defaults against the tuned train-knob set, a trace
    # each: the row that proves (or refuses to claim) the win.
    win = None
    train_tuned = {k: v for k, v in tuned.items()
                   if k in TRAIN_KNOB_FIELDS}
    if train_tuned and _remaining(deadline_ts) > 0:
        ab_iters = budgets[-1] * 2
        tdir = trace_dir or "."
        os.makedirs(tdir, exist_ok=True)
        t_def = os.path.join(tdir, "tuned_vs_default_default.jsonl")
        t_tun = os.path.join(tdir, "tuned_vs_default_tuned.jsonl")
        cfg_d = dataclasses.replace(base_config, max_iter=ab_iters,
                                    trace_out=t_def, verbose=False)
        cfg_t = dataclasses.replace(
            base_config,
            **{TRAIN_KNOB_FIELDS[k]: v for k, v in train_tuned.items()},
            max_iter=ab_iters, trace_out=t_tun, verbose=False)
        t0 = time.perf_counter()
        r_d = train(x, y, cfg_d, device=dev)
        s_d = time.perf_counter() - t0
        t0 = time.perf_counter()
        r_t = train(x, y, cfg_t, device=dev)
        s_t = time.perf_counter() - t0
        rate_d = r_d.n_iter / max(s_d, 1e-9)
        rate_t = r_t.n_iter / max(s_t, 1e-9)
        speedup = rate_t / max(rate_d, 1e-9)
        verdicts: List[str] = []
        try:
            from dpsvm_tpu_torch.observability.compare import (
                compare_paths, regressions)
            cmp, _ra, _rb = compare_paths(t_def, t_tun)
            verdicts = regressions(cmp, pct=5.0)
        except Exception as e:                  # noqa: BLE001
            verdicts = [f"compare failed: {e}"]
        compare_ok = not verdicts
        log(f"tune: tuned_vs_default: {rate_d:,.0f} -> {rate_t:,.0f} "
            f"it/s ({speedup:.3f}x) over {ab_iters} iters; compare gate "
            f"{'OK' if compare_ok else 'FAILED: ' + '; '.join(verdicts)}")
        win = {"case": "tuned_vs_default", "speedup": round(speedup, 4),
               "default_rate": round(rate_d, 1),
               "tuned_rate": round(rate_t, 1),
               "budget_iters": int(ab_iters),
               "trace_default": t_def, "trace_tuned": t_tun,
               "compare_ok": bool(compare_ok),
               "compare_regressions": verdicts}
        ab_row = ledger.make_record(
            "tuned_vs_default", {**win, "knobs": dict(train_tuned)},
            kind="tune", value=round(speedup, 4), unit="x",
            direction="higher", trace=t_tun)
        _ledger(ab_row)
        all_probes.append(ab_row)
        if speedup < 1.0:
            # probe wins that do not survive composition are noise, not
            # tuning facts: persist a default-confirming entry instead
            log("tune: A/B shows no end-to-end win — persisting a "
                "default-confirming entry instead")
            for k in train_tuned:
                tuned.pop(k, None)
            win["rejected"] = True

    entry = prof.make_entry(dk, tuned, probes=all_probes, win=win)
    out_path = prof.save_entry(entry, profile_out)
    log(f"tune: profile entry for {dk!r} written to {out_path} "
        f"(knobs: {tuned or 'none — defaults confirmed'})")
    return entry, 0

"""Load generator for the serving stack (port of
``dpsvm_tpu/serving/loadgen.py``): open/closed-loop HTTP traffic against
a running ``serve``, reported as one JSON row.

Closed loop (default): N workers, each firing its next request the
moment the previous answer lands — throughput is latency-bound, the
classic saturation probe, and the shape that exercises server-side
micro-batching (concurrent in-flight requests coalesce).

Open loop: requests depart on a fixed schedule (``rps``) regardless of
completions — the arrival process real traffic has; latency here
includes any queueing the server builds up, so it surfaces overload
honestly (no coordinated omission: a worker that falls behind schedule
records its lateness inside the measured latency).

``compare_sequential`` re-runs the same request count single-worker
with one row per request — the no-batching baseline. The headline row
then carries both numbers and their ratio, so "coalesced batching
beats batch-1 sequential submission" is a printed fact, not a claim.

Stdlib HTTP (``http.client`` with keep-alive) + numpy percentiles; no
torch — the loadgen runs from any machine that can reach the server.
"""

from __future__ import annotations

import http.client
import json
import socket
import threading
import time
from typing import List, Optional, Sequence, Tuple
from urllib.parse import urlsplit

import numpy as np


def synthetic_rows(d: int, n: int = 512, seed: int = 0) -> np.ndarray:
    """Feature rows for a model of width d when no dataset is given.
    Inference cost depends only on shapes, so random rows measure the
    same thing real ones would."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, d)).astype(np.float32)


def fetch_models(url: str, timeout: float = 10.0) -> dict:
    """GET /v1/models and return the full name -> manifest map (lazy
    fleet entries report ``resident: false`` and light registration
    facts only — the fleet drill picks its target names from here)."""
    host, port = _host_port(url)
    conn = _Conn(host, port, timeout=timeout)
    try:
        conn.request("GET", "/v1/models")
        resp = conn.getresponse()
        body = json.loads(resp.read() or b"{}")
    finally:
        conn.close()
    if resp.status != 200:
        raise RuntimeError(f"GET /v1/models -> {resp.status}: {body}")
    return body.get("models", {})


def fetch_manifest(url: str, model: str = "default",
                   timeout: float = 10.0) -> dict:
    """GET /v1/models and return the named model's manifest (the
    loadgen needs the feature width to synthesize rows)."""
    models = fetch_models(url, timeout=timeout)
    if model not in models:
        raise RuntimeError(f"server has no model {model!r} "
                           f"(models: {sorted(models)})")
    return models[model]


def _host_port(url: str) -> Tuple[str, int]:
    parts = urlsplit(url if "//" in url else f"http://{url}")
    return parts.hostname or "127.0.0.1", parts.port or 80


class _Conn(http.client.HTTPConnection):
    """Keep-alive connection with Nagle off: headers and body are
    separate writes, and the 40 ms delayed-ACK stall would otherwise
    dominate every latency percentile this tool exists to measure."""

    def connect(self):
        super().connect()
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)


def tenant_of(i: int, tenants: int, skew: float) -> Optional[str]:
    """Deterministic tenant assignment for request index ``i`` (the
    multi-tenant traffic mix ``dpsvm loadgen --tenants`` sends).

    With ``skew`` S in (0, 1], tenant ``t0`` is the planted hot tenant
    and receives fraction S of the requests via the same cumulative-
    quota stride the span sampler uses (observability/spans
    .should_sample — evenly interleaved, no RNG, replayable); the
    remainder round-robins over ``t1..t{N-1}``. skew=0 round-robins
    over all N. ``tenants=0`` disables the mix (None: no ``tenant``
    field — the server falls back to per-model attribution)."""
    if tenants < 1:
        return None
    if tenants == 1:
        return "t0"
    s = min(max(float(skew), 0.0), 1.0)
    if s > 0.0 and int((i + 1) * s) > int(i * s):
        return "t0"
    cold = tenants - 1 if s > 0.0 else tenants
    first = 1 if s > 0.0 else 0
    return f"t{first + i % cold}"


def model_of(i: int, n_models: int, skew: float) -> int:
    """Deterministic model-list index for request index ``i`` (the
    model-fleet traffic mix ``dpsvm loadgen --models`` sends).

    Same cumulative-quota stride as ``tenant_of``: with ``skew`` S in
    (0, 1] the FIRST model in the list is the planted hot model and
    receives fraction S of the requests, evenly interleaved; the rest
    round-robins over the remainder. skew=0 round-robins over all N.
    Round-robin over a fleet larger than the server's model-cache
    budget is the cache-thrash worst case; the skewed mix is the
    realistic one the cache exists for."""
    if n_models <= 1:
        return 0
    s = min(max(float(skew), 0.0), 1.0)
    if s > 0.0 and int((i + 1) * s) > int(i * s):
        return 0
    cold = n_models - 1 if s > 0.0 else n_models
    first = 1 if s > 0.0 else 0
    return first + i % cold


def run_loadgen(url: str, rows: np.ndarray, *, model: str = "default",
                requests: int = 200, batch: int = 1,
                concurrency: int = 8, mode: str = "closed",
                rps: float = 100.0, want: Sequence[str] = ("labels",),
                timeout: float = 30.0, spans: bool = False,
                tenants: int = 0,
                hot_tenant_skew: float = 0.0,
                models: Sequence[str] = (),
                model_skew: float = 0.0,
                connections: int = 0) -> dict:
    """Fire ``requests`` requests of ``batch`` rows each; return the
    result row (throughput + latency percentiles + error count).

    ``spans=True`` asks the server for its per-request span breakdown
    (the ``X-Trace-Spans`` header — forced server-side sampling, so it
    works with or without a serving --trace-out) and aggregates the
    stage percentiles into the row: ``queue_wait_p99_ms`` /
    ``compute_p99_ms`` + the full ``span_p99_ms`` table, so a
    saturate-knee row says WHICH stage hit the knee instead of just
    that p99 did (docs/OBSERVABILITY.md "Spans").

    ``tenants=N`` spreads the requests over N tenant labels (body
    ``tenant`` field; ``tenant_of`` above), ``hot_tenant_skew=S``
    concentrates fraction S on the planted hot tenant ``t0`` — the
    tenant-isolation drill. The row then carries per-tenant request/
    latency sub-rows plus ``hot_p99_ms`` / ``others_p99_ms``, so "one
    noisy tenant did not ruin its neighbours' p99" is a printed fact
    (docs/OBSERVABILITY.md "Per-tenant attribution").

    ``models=[names]`` spreads the requests over a model fleet instead
    of one model (``model_of`` above; ``model_skew`` plants the first
    name as the hot model). The row then carries per-model request/
    latency sub-rows plus ``cold_start_p99_ms`` — p99 over each
    model's FIRST-request latency, the number the HBM model cache
    exists to bound (a fault that hydrates from disk shows up here;
    a resident hit does not). All models must share the primary
    model's feature width (the fleet drill is a same-spec fleet).

    ``connections=N`` pre-opens N keep-alive sockets before the clock
    starts and HOLDS them all for the whole run: the first
    ``concurrency`` of them carry the traffic, the rest sit idle-open.
    That is the front-door drill's shape — thousands of mostly-idle
    connections with a modest request rate — which costs an event-loop
    server one registered socket each and a thread-per-connection
    server one stack each. The row gains ``open_connections`` (how
    many actually opened)."""
    if mode not in ("closed", "open"):
        raise ValueError(f"mode must be 'closed' or 'open', got {mode!r}")
    if requests < 1 or batch < 1 or concurrency < 1:
        raise ValueError("requests, batch and concurrency must be >= 1")
    if tenants < 0:
        raise ValueError(f"tenants must be >= 0, got {tenants}")
    if connections < 0:
        raise ValueError(f"connections must be >= 0, got {connections}")
    rows = np.asarray(rows, np.float32)
    host, port = _host_port(url)
    # Pre-serialize every request body: the generator must measure the
    # server, not its own json.dumps.
    n_rows = rows.shape[0]
    models = list(models)
    bodies: List[bytes] = []
    tenant_by_idx: List[Optional[str]] = []
    model_by_idx: List[str] = []
    for i in range(requests):
        take = [(i * batch + j) % n_rows for j in range(batch)]
        mdl = (models[model_of(i, len(models), model_skew)]
               if models else model)
        model_by_idx.append(mdl)
        body = {"model": mdl, "return": list(want),
                "instances": rows[take].tolist()}
        ten = tenant_of(i, tenants, hot_tenant_skew)
        tenant_by_idx.append(ten)
        if ten is not None:
            body["tenant"] = ten
        bodies.append(json.dumps(body).encode())

    held: List[_Conn] = []
    if connections:
        # open the whole fleet up front, outside the measured wall
        # clock; stop quietly at the server's cap (the row reports the
        # achieved count, and a cap-refused connect is the server
        # behaving, not a loadgen failure)
        for _ in range(int(connections)):
            c = _Conn(host, port, timeout=timeout)
            try:
                c.connect()
            except OSError:
                c.close()
                break
            held.append(c)

    next_idx = [0]
    idx_lock = threading.Lock()
    lat_ms: List[float] = []
    statuses: List[int] = []
    stage_ms: dict = {}            # stage name -> [ms, ...] (spans=True)
    by_tenant: dict = {}           # tenant -> {"ms": [...], "errors": n}
    by_model: dict = {}            # model -> {"lat": [(i, ms)], "errors": n}
    out_lock = threading.Lock()
    t_start = [0.0]
    headers = {"Content-Type": "application/json"}
    if spans:
        headers["X-Trace-Spans"] = "1"

    def worker(wid: int) -> None:
        conn = (held[wid] if wid < len(held)
                else _Conn(host, port, timeout=timeout))
        try:
            while True:
                with idx_lock:
                    i = next_idx[0]
                    if i >= requests:
                        return
                    next_idx[0] += 1
                if mode == "open":
                    # fixed departure schedule; lateness is NOT slept
                    # away (that would be coordinated omission)
                    due = t_start[0] + i / rps
                    delay = due - time.perf_counter()
                    if delay > 0:
                        time.sleep(delay)
                    t0 = due if due > t_start[0] else time.perf_counter()
                else:
                    t0 = time.perf_counter()
                breakdown = None
                try:
                    conn.request("POST", "/v1/predict", body=bodies[i],
                                 headers=headers)
                    resp = conn.getresponse()
                    data = resp.read()
                    status = resp.status
                    if spans and status == 200:
                        try:
                            breakdown = json.loads(data).get("spans")
                        except (json.JSONDecodeError, AttributeError):
                            breakdown = None
                except (http.client.HTTPException, OSError):
                    status = -1
                    conn.close()
                    conn = _Conn(host, port, timeout=timeout)
                ms = (time.perf_counter() - t0) * 1000.0
                with out_lock:
                    lat_ms.append(ms)
                    statuses.append(status)
                    ten = tenant_by_idx[i]
                    if ten is not None:
                        acc = by_tenant.setdefault(
                            ten, {"ms": [], "errors": 0})
                        acc["ms"].append(ms)
                        if status != 200:
                            acc["errors"] += 1
                    if models:
                        macc = by_model.setdefault(
                            model_by_idx[i], {"lat": [], "errors": 0})
                        macc["lat"].append((i, ms))
                        if status != 200:
                            macc["errors"] += 1
                    if isinstance(breakdown, dict):
                        for k, v in breakdown.items():
                            if isinstance(v, (int, float)):
                                stage_ms.setdefault(k, []).append(
                                    float(v))
        finally:
            conn.close()

    threads = [threading.Thread(target=worker, args=(w,), daemon=True)
               for w in range(concurrency)]
    t_start[0] = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t_start[0]
    for c in held:          # idle holders release only after the run
        try:
            c.close()
        except Exception:
            pass

    lat = np.asarray(lat_ms, np.float64)
    ok = sum(1 for s in statuses if s == 200)
    errors = len(statuses) - ok
    p50, p95, p99 = (np.percentile(lat, [50.0, 95.0, 99.0])
                     if lat.size else (float("nan"),) * 3)
    counts: dict = {}
    for s in statuses:
        counts[str(s)] = counts.get(str(s), 0) + 1
    # availability over ACCEPTED requests: a 429 is the server saying
    # "not now" — explicit backpressure, not a failure; everything else
    # non-200 (504s, 5xx, connection drops) counts against it.
    accepted = len(statuses) - counts.get("429", 0)
    span_row: dict = {}
    if spans and stage_ms:
        # server-side stage percentiles — WHERE the latency lives
        # ("compute" = the device_dispatch stage: pool dispatch through
        # the engine pass; docs/OBSERVABILITY.md "Spans")
        table = {}
        for k, vals in sorted(stage_ms.items()):
            if k in ("total_ms", "unattributed_ms"):
                continue
            p50s, p99s = np.percentile(np.asarray(vals, np.float64),
                                       [50.0, 99.0])
            table[k] = {"p50_ms": round(float(p50s), 3),
                        "p99_ms": round(float(p99s), 3)}
        span_row = {
            "span_requests": len(stage_ms.get("total_ms", ())),
            "span_p99_ms": table,
            "queue_wait_p99_ms": table.get(
                "queue_wait", {}).get("p99_ms"),
            "compute_p99_ms": table.get(
                "device_dispatch", {}).get("p99_ms"),
        }
    tenant_row: dict = {}
    if tenants >= 1:
        per_tenant = {}
        others: List[float] = []
        for ten, acc in sorted(by_tenant.items()):
            tl = np.asarray(acc["ms"], np.float64)
            tp50, tp99 = (np.percentile(tl, [50.0, 99.0])
                          if tl.size else (float("nan"),) * 2)
            per_tenant[ten] = {
                "requests": int(tl.size),
                "errors": int(acc["errors"]),
                "p50_ms": round(float(tp50), 3),
                "p99_ms": round(float(tp99), 3)}
            if ten != "t0":
                others.extend(acc["ms"])
        tenant_row = {
            "tenants": int(tenants),
            "hot_tenant_skew": round(float(hot_tenant_skew), 4),
            "tenant_rows": per_tenant,
        }
        if hot_tenant_skew > 0.0 and tenants > 1:
            hot = per_tenant.get("t0") or {}
            op99 = (np.percentile(np.asarray(others, np.float64),
                                  99.0)
                    if others else float("nan"))
            tenant_row["hot_tenant"] = "t0"
            tenant_row["hot_p99_ms"] = hot.get("p99_ms")
            tenant_row["others_p99_ms"] = round(float(op99), 3)
    model_row: dict = {}
    if models:
        per_model = {}
        firsts: List[float] = []
        for name, macc in sorted(by_model.items()):
            pairs = sorted(macc["lat"])        # by request index
            ml = np.asarray([ms for _, ms in pairs], np.float64)
            mp50, mp99 = (np.percentile(ml, [50.0, 99.0])
                          if ml.size else (float("nan"),) * 2)
            # latency of the model's FIRST request (lowest request
            # index — deterministic even though workers race): the
            # cold-start sample, a cache fault if the model was not
            # resident when the run began
            first_ms = pairs[0][1] if pairs else float("nan")
            firsts.append(first_ms)
            per_model[name] = {
                "requests": int(ml.size),
                "errors": int(macc["errors"]),
                "p50_ms": round(float(mp50), 3),
                "p99_ms": round(float(mp99), 3),
                "first_ms": round(float(first_ms), 3)}
        cold_p99 = (np.percentile(np.asarray(firsts, np.float64), 99.0)
                    if firsts else float("nan"))
        model_row = {
            "models": len(models),
            "model_skew": round(float(model_skew), 4),
            "model_rows": per_model,
            "cold_start_p99_ms": round(float(cold_p99), 3),
        }
        if model_skew > 0.0 and len(models) > 1:
            model_row["hot_model"] = models[0]
    return {
        "mode": mode,
        "requests": requests,
        "batch": batch,
        "concurrency": concurrency,
        "wall_s": round(wall, 4),
        "throughput_rps": round(ok / wall, 2) if wall > 0 else 0.0,
        "examples_per_sec": round(ok * batch / wall, 2) if wall > 0
        else 0.0,
        "p50_ms": round(float(p50), 3),
        "p95_ms": round(float(p95), 3),
        "p99_ms": round(float(p99), 3),
        "errors": errors,
        "status_counts": {k: counts[k] for k in sorted(counts)},
        "accepted": accepted,
        "availability_pct": (round(100.0 * ok / accepted, 3)
                             if accepted else None),
        **({"target_rps": rps} if mode == "open" else {}),
        **({"open_connections": len(held)} if connections else {}),
        **span_row,
        **tenant_row,
        **model_row,
    }


def fetch_metrics(url: str, timeout: float = 10.0) -> dict:
    """GET /metricsz — the chaos report reads the server-side
    robustness counters (ejections, rebuilds, hedges, sheds) before
    and after the run."""
    host, port = _host_port(url)
    conn = _Conn(host, port, timeout=timeout)
    try:
        conn.request("GET", "/metricsz")
        resp = conn.getresponse()
        body = json.loads(resp.read() or b"{}")
    finally:
        conn.close()
    if resp.status != 200:
        raise RuntimeError(f"GET /metricsz -> {resp.status}: {body}")
    return body


#: robustness counters the chaos row deltas out of /metricsz
CHAOS_COUNTERS = ("ejections", "rebuilds", "hedges_fired", "hedges_won",
                  "redispatches", "deadline_504", "shed_proba",
                  "shed_sibling", "expired", "rejected")


def run_saturate(url: str, rows: np.ndarray, *,
                 model: str = "default", p99_target_ms: float = 50.0,
                 start_rps: float = 25.0, rps_factor: float = 2.0,
                 max_steps: int = 8, step_requests: int = 100,
                 batch: int = 1, concurrency: int = 16,
                 want: Sequence[str] = ("labels",),
                 timeout: float = 30.0,
                 trace: Optional[str] = None,
                 connections: int = 0) -> dict:
    """Drive-to-saturation: step open-loop RPS by ``rps_factor`` until
    p99 exceeds the target (or errors appear), and report ONE SLO row —
    the max sustained throughput at p99 < target, with availability.
    The open loop is the honest probe here: a closed loop slows its own
    arrivals under overload and never finds the knee.

    ``trace`` is the provenance pointer the row carries (the serving
    process's ``--trace-out`` artifact or an archived copy) — the same
    field burst-runner rows carry, so an SLO row is ledger- and
    ``compare``-traceable like a training row. A set ``trace`` also
    turns on the per-request span breakdown (``spans``), so each RPS
    step says WHICH stage (queue wait vs device compute) hit the
    knee."""
    steps = []
    best = None
    rps = float(start_rps)
    spans = trace is not None
    achieved_conns = None
    for _ in range(int(max_steps)):
        r = run_loadgen(url, rows, model=model, requests=step_requests,
                        batch=batch, concurrency=concurrency,
                        mode="open", rps=rps, want=want,
                        timeout=timeout, spans=spans,
                        connections=connections)
        if connections:
            achieved_conns = r.get("open_connections")
        met = (r["errors"] == 0
               and np.isfinite(r["p99_ms"])
               and r["p99_ms"] <= p99_target_ms)
        steps.append({"rps": rps, "p99_ms": r["p99_ms"],
                      "throughput_rps": r["throughput_rps"],
                      "availability_pct": r["availability_pct"],
                      "errors": r["errors"], "slo_met": met,
                      **({"queue_wait_p99_ms": r.get("queue_wait_p99_ms"),
                          "compute_p99_ms": r.get("compute_p99_ms")}
                         if spans else {})})
        if not met:
            break
        best = (rps, r)
        rps *= float(rps_factor)
    row = {
        "metric": "serving_slo_max_rps",
        "unit": "req/s",
        "p99_target_ms": float(p99_target_ms),
        "steps": steps,
        "trace": trace,
        **({"open_connections": achieved_conns} if connections else {}),
    }
    if best is None:
        row.update(value=0.0, slo_met=False, availability_pct=None)
    else:
        srps, r = best
        row.update(value=r["throughput_rps"], slo_met=True,
                   sustained_rps=srps, p99_ms=r["p99_ms"],
                   availability_pct=r["availability_pct"])
        if spans:
            row.update(queue_wait_p99_ms=r.get("queue_wait_p99_ms"),
                       compute_p99_ms=r.get("compute_p99_ms"),
                       span_p99_ms=r.get("span_p99_ms"))
    return row


def loadgen_row(url: str, rows: np.ndarray, *, model: str = "default",
                requests: int = 200, batch: int = 1,
                concurrency: int = 8, mode: str = "closed",
                rps: float = 100.0, want: Sequence[str] = ("labels",),
                timeout: float = 30.0, chaos: bool = False,
                compare_sequential: bool = True,
                trace: Optional[str] = None, tenants: int = 0,
                hot_tenant_skew: float = 0.0,
                models: Sequence[str] = (),
                model_skew: float = 0.0,
                connections: int = 0) -> dict:
    """The one-line result row ``dpsvm loadgen`` prints: the main
    measurement, plus (by default) the batch-1 single-worker sequential
    baseline and the coalescing speedup over it.

    ``chaos=True`` is the chaos-drill report: the fault itself is
    armed server-side (``DPSVM_FAULT_SERVE_*`` env on the serve
    process — it fires mid-run, at the configured request count) and
    the row additionally carries the availability of accepted requests
    plus the delta of the server's robustness counters (ejections,
    rebuilds, hedges, sheds) across the run, read from /metricsz.

    A set ``trace`` turns on the per-request span breakdown: every
    request carries ``X-Trace-Spans`` (the serving side records its
    span tree into --trace-out AND returns the stage milliseconds),
    and the row gains ``queue_wait_p99_ms`` / ``compute_p99_ms`` +
    the full ``span_p99_ms`` table."""
    before = fetch_metrics(url, timeout=timeout) if chaos else None
    main = run_loadgen(url, rows, model=model, requests=requests,
                       batch=batch, concurrency=concurrency, mode=mode,
                       rps=rps, want=want, timeout=timeout,
                       spans=trace is not None, tenants=tenants,
                       hot_tenant_skew=hot_tenant_skew,
                       models=models, model_skew=model_skew,
                       connections=connections)
    row = {
        "metric": "serving_examples_per_sec",
        "value": main["examples_per_sec"],
        "unit": "ex/s",
        # provenance pointer (burst-runner row parity): the serving
        # trace this measurement ran against, when one was archived
        "trace": trace,
        **main,
    }
    if chaos:
        after = fetch_metrics(url, timeout=timeout)
        row["chaos"] = {
            k: int(after.get(k, 0)) - int(before.get(k, 0))
            for k in CHAOS_COUNTERS}
        row["chaos"]["stray_compiles"] = int(
            after.get("stray_compiles", 0))
        row["replica_states"] = [
            r.get("state")
            for m in after.get("models", {}).values()
            for r in m.get("pool", {}).get("replicas", [])]
    if compare_sequential:
        seq = run_loadgen(url, rows, model=model, requests=requests,
                          batch=1, concurrency=1, mode="closed",
                          want=want, timeout=timeout)
        row["seq1_examples_per_sec"] = seq["examples_per_sec"]
        row["seq1_p50_ms"] = seq["p50_ms"]
        row["seq1_errors"] = seq["errors"]
        row["coalesce_speedup"] = (
            round(main["examples_per_sec"] / seq["examples_per_sec"], 3)
            if seq["examples_per_sec"] > 0 else None)
    return row

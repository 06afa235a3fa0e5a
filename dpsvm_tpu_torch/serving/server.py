"""Online prediction HTTP server: stdlib ``ThreadingHTTPServer`` (port of
``dpsvm_tpu/serving/server.py``).

Endpoints:

* ``POST /v1/predict``  — ``{"model": name?, "instances": [[...], ...],
  "return": ["labels","decision","proba"]?}``. Instances ride the
  model's MicroBatcher (coalesced onto the engine's bucket ladder);
  the response carries the requested outputs plus per-request timing.
* ``GET /healthz``      — liveness + model list; 503 while draining
  (load balancers stop routing before the listener closes).
* ``GET /metricsz``     — request/error/reject counters, per-model
  batch-row and bucket histograms, queue depths, p50/p95/p99 request
  latency over a sliding window, plus the per-tenant cost ledger
  (``tenants``) and per-model request/latency view (``per_model``).
  Requests carry a tenant label (``X-Tenant`` header / ``tenant``
  body field, defaulting to the model name) and every response bills
  it — docs/OBSERVABILITY.md "Per-tenant attribution".
* ``GET /v1/models``    — registry manifests (shape, SV counts,
  compaction, warmup-capture receipt, device, generation).
* ``POST /v1/reload``   — ``{"model": name}``: explicit hot reload via
  the registry (old engine serves until the new one is warm).

Overload: a full batcher queue fast-rejects with HTTP 429 (+
``Retry-After``) instead of queueing unboundedly — clients learn to
back off while p99 stays bounded. Before that cliff there is a slope
(docs/SERVING.md "Resilience"): as queue fill crosses the shed
thresholds the server first drops ``proba`` to ``decision``
(``serving/budget.DegradeController`` tier 1), then sheds whole
requests to a registered cheaper sibling model (tier 2, e.g. the
``approx/`` twin), marking degraded responses with a ``degraded``
field.

Resilience: requests carry a deadline budget (``timeout_ms`` in the
body or ``X-Deadline-Ms`` header, capped by ``--deadline-ms``) that
bounds queue wait AND device dispatch; a blown budget is **504** +
``Retry-After`` (never a 400 — the client did nothing wrong). With
``replicas > 1`` each model serves from a ``serving/pool.ReplicaPool``
— wedged/NaN-poisoned replicas are ejected and rebuilt in the
background while the rest keep answering, and hedged re-dispatch
(``--hedge-ms``) converts tail stalls into second chances. /metricsz
carries the robustness counters (504s, ejections, rebuilds, hedges,
shed tiers, expired tickets) and the rolling score-distribution
window the drift detector (``serving/lifecycle.py``) reads.

Observability: with ``--trace-out`` + ``--trace-sample-rate`` each
sampled request threads a span tree through the stack (admission ->
queue wait -> batch formation -> device dispatch -> respond, with
replica-compute and hedge markers below the dispatch) and the tree is
emitted into the serving trace as schema ``span`` records at
request completion — the per-request "where did the time go" that
aggregate /metricsz percentiles cannot answer
(docs/OBSERVABILITY.md "Spans"; observability/spans.py).

Shutdown reuses the deferred-signal pattern of ``resilience/preempt``:
``serve_until_signal`` traps SIGTERM/SIGINT, and on delivery performs a
graceful drain — stop admitting (503 + batchers closed), finish every
queued batch, complete in-flight HTTP exchanges (handler threads are
non-daemon and joined), then close the listener. A preempted serving
pod answers everything it accepted.

Threading model: one handler thread per connection (stdlib), all
device work funneled through one MicroBatcher worker per model and the
model's replica pool (one worker thread, and on the card one CUDA
stream, a replica) — the HTTP layer never touches the device. The
server's own device use is the fleet model cache (``device``, None
meaning the GPU); registered engines carry the device they were built
for.
"""

from __future__ import annotations

import json
import math
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple

import numpy as np

from dpsvm_tpu_torch.observability import blackbox, slo
from dpsvm_tpu_torch.observability.metrics import (DEFAULT_LATENCY_BUCKETS_MS,
                                             DEFAULT_TENANT_BUDGET,
                                             PROMETHEUS_CONTENT_TYPE,
                                             TENANT_OTHER,
                                             MetricsRegistry,
                                             TenantLabelBudget,
                                             incidents_counter,
                                             sanitize_tenant,
                                             wants_prometheus)
from dpsvm_tpu_torch.observability.spans import RequestSpans, should_sample
from dpsvm_tpu_torch.serving.batcher import (KNOWN_OUTPUTS, BatcherClosedError,
                                       MicroBatcher, QueueFullError)
from dpsvm_tpu_torch.serving.budget import (TIER_NONE, TIER_SHED_PROBA,
                                      TIER_SHED_SIBLING, Budget,
                                      DeadlineExceededError,
                                      DegradeController)
from dpsvm_tpu_torch.serving.pool import PoolUnavailableError, ReplicaPool
from dpsvm_tpu_torch.serving.registry import ModelRegistry

#: request bodies above this are rejected (413) before parsing.
MAX_BODY_BYTES = 64 * 1024 * 1024

#: response-class counters that also bill the request's tenant
#: (docs/OBSERVABILITY.md "Per-tenant attribution"); the shed counters
#: stay fleet-wide — a shed decision belongs to queue pressure, not to
#: the request that happened to trip it.
_TENANT_COUNT_KEYS = ("requests", "errors", "rejected", "deadline_504")


def _new_tenant_acc() -> Dict[str, float]:
    """One tenant's host-side cost ledger row (exact values for the
    JSON /metricsz; the Prometheus families mirror these)."""
    return {"requests": 0.0, "errors": 0.0, "rejected": 0.0,
            "deadline_504": 0.0, "rows": 0.0, "wall_ms": 0.0,
            "queue_wait_ms": 0.0, "compute_ms": 0.0}


def _jsonable(v):
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    return v


class _Server(ThreadingHTTPServer):
    # In-flight exchanges must complete during drain: track handler
    # threads and join them on server_close (the stdlib default daemon
    # threads would be abandoned mid-response).
    daemon_threads = False
    block_on_close = True
    owner: "ServingServer"


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "dpsvm-serve"
    # Headers and body go out as separate writes; with Nagle on, the
    # second write stalls behind the client's delayed ACK (~40 ms) —
    # measured p50 went 44 ms -> ~4 ms with it off on both ends.
    disable_nagle_algorithm = True

    # -- plumbing -----------------------------------------------------

    def log_message(self, fmt, *args):       # quiet by default; errors
        if self.server.owner.verbose:        # and metrics tell the story
            super().log_message(fmt, *args)

    def _send(self, code: int, payload: dict,
              headers: Tuple[Tuple[str, str], ...] = ()) -> None:
        # Span back-stop: whatever path produced this response, the
        # request's span tree (when one is open) is finished with THIS
        # status — every 4xx/5xx branch gets attribution without each
        # one hand-closing the tree. The success path finishes earlier
        # (with budget/model extras); finish is once-only, so this is
        # then a no-op.
        rs = getattr(self, "_rs", None)
        if rs is not None and not rs.finished:
            self.server.owner.finish_request_spans(rs, status=code)
        body = json.dumps(payload, default=_jsonable).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in headers:
            self.send_header(k, v)
        self.end_headers()
        try:
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            pass                             # client went away; fine

    def _send_text(self, code: int, text: str,
                   content_type: str = "text/plain") -> None:
        body = text.encode()
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        try:
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            pass

    def _body(self) -> Optional[dict]:
        n = int(self.headers.get("Content-Length") or 0)
        if n > MAX_BODY_BYTES:
            self._send(413, {"error": f"body over {MAX_BODY_BYTES} bytes"})
            return None
        raw = self.rfile.read(n) if n else b"{}"
        try:
            body = json.loads(raw or b"{}")
        except json.JSONDecodeError as e:
            self._send(400, {"error": f"bad JSON body: {e}"})
            return None
        if not isinstance(body, dict):
            self._send(400, {"error": "body must be a JSON object"})
            return None
        return body

    # -- routes -------------------------------------------------------

    def do_GET(self) -> None:                # noqa: N802 (stdlib API)
        owner = self.server.owner
        if self.path == "/healthz":
            if owner.draining:
                self._send(503, {"status": "draining",
                                 "models": owner.registry.names()})
            else:
                self._send(200, {"status": "ok",
                                 "models": owner.registry.names(),
                                 "uptime_s": round(owner.uptime, 3)})
        elif self.path.startswith("/metricsz"):
            # ?format=prometheus = the text exposition of the unified
            # metric registry (observability/metrics.py) — what a
            # scraper consumes; the bare endpoint keeps the JSON blob.
            if wants_prometheus(self.path):
                self._send_text(200, owner.metrics_text(),
                                PROMETHEUS_CONTENT_TYPE)
            else:
                self._send(200, owner.metrics())
        elif self.path == "/v1/models":
            self._send(200, {"models": owner.model_manifests()})
        else:
            self._send(404, {"error": f"no route {self.path}"})

    def do_POST(self) -> None:               # noqa: N802 (stdlib API)
        owner = self.server.owner
        if self.path == "/v1/predict":
            self._predict(owner)
        elif self.path == "/v1/reload":
            self._reload(owner)
        else:
            self._send(404, {"error": f"no route {self.path}"})

    def _reload(self, owner: "ServingServer") -> None:
        body = self._body()
        if body is None:
            return
        name = body.get("model", "default")
        try:
            engine = owner.registry.reload(name)
        except KeyError as e:
            self._send(404, {"error": str(e)})
            return
        except (ValueError, OSError) as e:
            self._send(400, {"error": f"reload failed (old model still "
                                      f"serving): {e}"})
            return
        owner.refresh_pool(name)        # replicas pick the new gen up
        man = dict(engine.manifest)
        man["generation"] = owner.registry.manifests()[name]["generation"]
        self._send(200, {"reloaded": name, "manifest": man})

    def _predict(self, owner: "ServingServer") -> None:
        t0 = time.perf_counter()
        if owner.draining:
            owner.count("errors")
            self._send(503, {"error": "draining"})
            return
        # Request-scoped span tree (docs/OBSERVABILITY.md "Spans"):
        # opened for sampled requests (--trace-sample-rate against an
        # open serving trace) and for any request that asks via the
        # X-Trace-Spans header (the loadgen breakdown path — forced,
        # so a client probing "where did MY time go" never loses the
        # sampling lottery). None = this request records nothing.
        want_spans_back = (str(self.headers.get("X-Trace-Spans", ""))
                           .lower() in ("1", "true", "yes"))
        rs = owner.start_request_spans(force=want_spans_back)
        self._rs = rs
        body = self._body()
        if body is None:
            owner.count("errors")
            return
        name = body.get("model", "default")
        # Tenant identity, fixed at admission (docs/OBSERVABILITY.md
        # "Per-tenant attribution"): X-Tenant header beats the body's
        # `tenant` field beats the model name. Hostile values are
        # sanitized and the label budget may resolve a long-tail
        # tenant to the `other` aggregate; the span tree carries the
        # resolved label downstream, so no pipeline signature changes
        # and no extra device transfers.
        tenant = owner.admit_tenant(self.headers.get("X-Tenant"),
                                    body.get("tenant"), name)
        if rs is not None:
            rs.tenant = tenant
            rs.model = name
        want = tuple(body.get("return") or ("labels", "decision"))
        inst = body.get("instances")
        # Fleet routing (docs/SERVING.md "Model fleet"): a non-resident
        # registration behind an armed model cache serves through the
        # cache's synchronous cold path — no pool, no batcher; the
        # cache decides transient vs hydrate and does its own width/
        # calibration validation (ValueError -> 400 below).
        engine = None
        try:
            cold = owner.serves_cold(name)
            if not cold:
                engine = owner.registry.engine(name)
        except KeyError as e:
            owner.count("errors", tenant=tenant)
            self._send(404, {"error": str(e)})
            return
        if inst is None:
            owner.count("errors", tenant=tenant)
            self._send(400, {"error": "missing 'instances'"})
            return
        try:
            x = np.asarray(inst, dtype=np.float32)
        except (ValueError, TypeError) as e:
            owner.count("errors", tenant=tenant)
            self._send(400, {"error": f"instances not numeric: {e}"})
            return
        if not np.all(np.isfinite(x)):
            owner.count("errors", tenant=tenant)
            self._send(400, {"error": "instances contain non-finite "
                                      "values"})
            return
        # Validate HERE, before the batcher: a bad request rejected at
        # admission can never poison the coalesced batch it would have
        # ridden in (the worker publishes one error to every ticket of
        # a failed batch).
        if x.ndim == 1:
            x = x[None, :]
        if x.ndim != 2 or x.shape[0] == 0 or (
                engine is not None
                and x.shape[1] != engine.num_attributes):
            d = engine.num_attributes if engine is not None else "d"
            owner.count("errors", tenant=tenant)
            self._send(400, {"error": f"instances must be a non-empty "
                                      f"(m, {d}) matrix, got shape "
                                      f"{list(x.shape)}"})
            return
        if x.shape[0] > self.server.owner.max_queue:
            owner.count("errors", tenant=tenant)
            self._send(413, {"error": f"{x.shape[0]} rows in one "
                                      f"request exceeds the queue bound "
                                      f"({owner.max_queue}); split the "
                                      "batch (or use `dpsvm test "
                                      "--batch` for offline eval)"})
            return
        bad = [w for w in want if w not in KNOWN_OUTPUTS]
        if bad:
            owner.count("errors", tenant=tenant)
            self._send(400, {"error": f"unknown outputs {bad}; pick "
                                      f"from {list(KNOWN_OUTPUTS)}"})
            return
        # Deadline budget: fixed at admission, bounds queue wait AND
        # device dispatch. A blown budget is 504 (see below).
        try:
            budget = owner.budget_for(
                body.get("timeout_ms",
                         self.headers.get("X-Deadline-Ms")),
                tenant=tenant)
        except ValueError as e:
            owner.count("errors", tenant=tenant)
            self._send(400, {"error": str(e)})
            return
        if cold:
            # Synchronous cold dispatch through the model cache: no
            # degrade ladder (there is no queue to protect), no
            # batcher. The measured wall below IS the cold-start
            # latency the fleet drill reports the p99 of.
            try:
                ride = tuple(dict.fromkeys(want + ("decision",)))
                res = owner.model_cache.infer(name, x, want=ride)
            except KeyError as e:
                owner.count("errors", tenant=tenant)
                self._send(404, {"error": str(e)})
                return
            except ValueError as e:
                owner.count("errors", tenant=tenant)
                self._send(400, {"error": str(e)})
                return
            eff_name, eff_want, degraded = name, want, None
            self._respond_predict(owner, t0, rs, budget, tenant, name,
                                  eff_name, eff_want, degraded, x, res,
                                  want_spans_back)
            return
        # Degradation ladder: shed the optional expensive output, then
        # shed the whole request to the registered sibling, BEFORE the
        # queue-full 429 cliff.
        eff_name, eff_want, degraded = owner.degrade(name, want)
        if eff_name != name:
            try:
                engine = owner.registry.engine(eff_name)
            except KeyError:
                eff_name, degraded = name, None    # sibling vanished
        if "proba" in eff_want and not engine.calibrated:
            owner.count("errors")
            self._send(400, {"error": f"model {eff_name!r} has no "
                                      "probability calibration"})
            return
        try:
            # Always ride "decision" along: the engine derives every
            # output from the one decision pass anyway, and the server
            # feeds the values to the drift detector's score window.
            ride = tuple(dict.fromkeys(eff_want + ("decision",)))
            # admission is auto-closed by queue_wait's start inside
            # submit — one timestamp per stage transition, so no time
            # can fall between an explicit end and the next start
            ticket = owner.batcher(eff_name).submit(
                x, ride, deadline=budget.deadline, spans=rs)
            res = ticket.wait(budget.remaining())
        except QueueFullError as e:
            owner.count("rejected", tenant=tenant)
            self._send(429, {"error": str(e)},
                       headers=(("Retry-After", "1"),))
            return
        except BatcherClosedError:
            owner.count("errors", tenant=tenant)
            self._send(503, {"error": "draining"})
            return
        except (DeadlineExceededError, TimeoutError) as e:
            # the satellite bugfix: a timeout is the SERVER's miss —
            # 504 + Retry-After, never the 400 family
            owner.count("deadline_504", tenant=tenant)
            self._send(504, {"error": str(e)},
                       headers=(("Retry-After", "1"),))
            return
        except PoolUnavailableError as e:
            owner.count("errors", tenant=tenant)
            self._send(503, {"error": str(e)},
                       headers=(("Retry-After", "1"),))
            return
        except ValueError as e:
            # bad width / unknown output / uncalibrated proba
            owner.count("errors", tenant=tenant)
            self._send(400, {"error": str(e)})
            return
        self._respond_predict(owner, t0, rs, budget, tenant, name,
                              eff_name, eff_want, degraded, x, res,
                              want_spans_back)

    def _respond_predict(self, owner: "ServingServer", t0, rs, budget,
                         tenant, name, eff_name, eff_want, degraded,
                         x, res, want_spans_back) -> None:
        """The shared 200 tail of both predict paths (batched and
        fleet-cold): score-window feed, span close, latency + tenant
        accounting, counted response."""
        if rs is not None:
            # respond opens IMMEDIATELY on wake (before the score-
            # window feed) — auto-closing the dispatch stage, so the
            # post-compute bookkeeping is attributed, not residual
            rs.start("respond")
        owner.observe_scores(res.get("decision"))
        out = {k: _jsonable(v) for k, v in res.items() if k in eff_want}
        if degraded:
            out["degraded"] = degraded
        # Close the span tree BEFORE measuring ms so the root span and
        # the /metricsz latency observation describe the same wall
        # (the residual left to `respond` is the JSON encode + send).
        breakdown = owner.finish_request_spans(
            rs, status=200, budget=budget, model=eff_name,
            rows=int(x.shape[0]))
        if breakdown is not None and want_spans_back:
            out["spans"] = breakdown
        ms = (time.perf_counter() - t0) * 1000.0
        owner.observe_latency(ms)
        # tenant/model accounting BEFORE the counted response, so the
        # watch sample the count triggers sees this request's lanes
        owner.account_request(tenant, name, rows=int(x.shape[0]),
                              ms=ms, breakdown=breakdown)
        owner.count("requests", tenant=tenant)
        out.update(model=name, n=int(x.shape[0]), ms=round(ms, 3))
        self._send(200, out)


class ServingServer:
    """Registry + per-model replica pools + batchers + the HTTP front
    end (module docstring for the resilience pieces)."""

    def __init__(self, registry: ModelRegistry, host: str = "127.0.0.1",
                 port: int = 0, *, max_batch: int = 256,
                 max_delay_ms: float = 2.0, max_queue: int = 4096,
                 predict_timeout: float = 60.0, replicas: int = 1,
                 hedge="off", degrade: bool = True,
                 shed_proba_fill: float = 0.5,
                 shed_sibling_fill: float = 0.8,
                 siblings: Optional[Dict[str, str]] = None,
                 score_window: int = 4096,
                 trace_out: Optional[str] = None,
                 trace_sample_rate: float = 1.0,
                 metrics_registry: Optional[MetricsRegistry] = None,
                 watch_rules=None, bundle_dir: Optional[str] = None,
                 watch: bool = True,
                 tenant_budget: int = DEFAULT_TENANT_BUDGET,
                 model_cache_budget: Optional[int] = None,
                 verbose: bool = False, device=None):
        self.registry = registry
        self.host = host
        self.requested_port = int(port)
        self.max_batch = int(max_batch)
        self.max_delay_ms = float(max_delay_ms)
        self.max_queue = int(max_queue)
        self.predict_timeout = float(predict_timeout)
        self.replicas = int(replicas)
        self.hedge = hedge
        self.verbose = verbose
        self.draining = False
        self._batchers: Dict[str, MicroBatcher] = {}
        self._pools: Dict[str, ReplicaPool] = {}
        self._siblings: Dict[str, str] = {}
        self.degrader = DegradeController(
            enabled=degrade, shed_proba_fill=shed_proba_fill,
            shed_sibling_fill=shed_sibling_fill)
        self._lock = threading.Lock()
        self._pool_create_lock = threading.Lock()
        self._lat_ms: deque = deque(maxlen=8192)
        self._scores: deque = deque(maxlen=int(score_window))
        # The hand-rolled request counters now live in the unified
        # metric registry (observability/metrics.py): the JSON
        # /metricsz keys read the same series the Prometheus
        # exposition renders, so the two surfaces cannot drift. The
        # CLI passes the process-wide default_registry() (one surface
        # per process — training and serving alike); library/test
        # instances default to a private registry so per-instance
        # counter assertions stay exact.
        self.mreg = (metrics_registry if metrics_registry is not None
                     else MetricsRegistry())
        self._counters = {
            key: self.mreg.counter(f"dpsvm_serving_{key}_total", help_)
            .labels()
            for key, help_ in (
                ("requests", "requests answered 200"),
                ("errors", "client/server errors (4xx/5xx except "
                           "429/504)"),
                ("rejected", "fast-rejected on a full queue (429)"),
                ("deadline_504", "deadline budget blown (504)"),
                ("shed_proba", "tier-1 shed: proba dropped to "
                               "decision"),
                ("shed_sibling", "tier-2 shed: served by the sibling "
                                 "model"))}
        self._h_latency = self.mreg.histogram(
            "dpsvm_serving_request_latency_ms",
            "request wall latency (admission to response)",
            buckets=DEFAULT_LATENCY_BUCKETS_MS).labels()
        # Per-stage latency from the sampled span trees: the scrapeable
        # twin of the trace's span records (one histogram series per
        # stage name — queue_wait / device_dispatch / ...). Registered
        # lazily on the first sampled request: a histogram FAMILY with
        # zero series renders a sample-less TYPE line the exposition
        # grammar rejects.
        self._h_span = None
        self._c_spans = self.mreg.counter(
            "dpsvm_serving_spans_sampled_total",
            "requests that recorded a span tree").labels()
        # Per-tenant cost attribution (docs/OBSERVABILITY.md
        # "Per-tenant attribution"): an exact host-side ledger for the
        # JSON /metricsz plus bounded-cardinality Prometheus families
        # — at most ``tenant_budget`` live tenant label values, the
        # long tail aggregated under ``other`` and LRU-evicted series
        # removed from the exposition. Everything here is arithmetic
        # on numbers the request path already produced: zero extra
        # device->host transfers.
        self.tenant_budget = TenantLabelBudget(
            int(tenant_budget), on_evict=self._evict_tenant)
        self._tenants: Dict[str, Dict[str, float]] = {}
        self._per_model: Dict[str, dict] = {}
        self._c_tenant = {
            key: self.mreg.counter(f"dpsvm_tenant_{key}_total", help_,
                                   labels=("tenant",))
            for key, help_ in (
                ("requests", "requests answered 200, per tenant"),
                ("errors", "error responses, per tenant"),
                ("rejected", "queue-full 429s, per tenant"),
                ("deadline_504", "deadline budget blown (504), per "
                                 "tenant"),
                ("rows", "rows predicted, per tenant"),
                ("queue_wait_ms", "queue-wait milliseconds from "
                                  "sampled span trees, per tenant"),
                ("compute_ms", "device-dispatch milliseconds from "
                               "sampled span trees, per tenant"))}
        # lazy, like _h_span: a histogram family with zero series
        # renders a sample-less TYPE line the grammar rejects
        self._h_tenant = None
        self._g_queue = self.mreg.gauge(
            "dpsvm_serving_queue_depth",
            "micro-batcher queue depth in rows", labels=("model",))
        self._g_healthy = self.mreg.gauge(
            "dpsvm_serving_replicas_healthy",
            "replicas with a closed circuit", labels=("model",))
        # Model-fleet cache (dpsvm_tpu/fleet, docs/SERVING.md "Model
        # fleet"): when armed, NON-resident registrations (lazy ones,
        # and anything the cache pages out) are served by the budgeted
        # ModelCache instead of a dedicated pool/batcher — the cold
        # path is synchronous by design, its latency IS the cold-start
        # story. Resident eager engines keep the classic batched path
        # untouched. The fault/eviction counters exist unconditionally
        # so the model-cache-thrash rule always has its lane (zero on
        # a cache-less server).
        self._c_model_faults = self.mreg.counter(
            "dpsvm_fleet_model_faults_total",
            "cold-model hydrations into the fleet cache").labels()
        self._c_model_evictions = self.mreg.counter(
            "dpsvm_fleet_model_evictions_total",
            "resident models paged out of the fleet cache").labels()
        self.model_cache = None
        if model_cache_budget is not None:
            from dpsvm_tpu_torch.fleet.modelcache import ModelCache
            self.model_cache = ModelCache(
                registry, budget=int(model_cache_budget),
                max_batch=self.max_batch,
                on_event=self._fleet_event, device=device)
        self._g_uptime = self.mreg.gauge("dpsvm_serving_uptime_seconds",
                                         "seconds since server start")
        self._g_draining = self.mreg.gauge("dpsvm_serving_draining",
                                           "1 while draining")
        self._g_expired = self.mreg.gauge(
            "dpsvm_serving_expired_tickets",
            "tickets dropped at batch formation (deadline passed)")
        self.mreg.add_collector(self._collect_gauges)
        # Continuous watch (observability/slo.py, docs/OBSERVABILITY.md
        # "Watch & alerts"): every server evaluates the serving SLO
        # rules against its OWN counters on every counted response —
        # no scraper in the loop — and feeds a bounded flight recorder
        # (observability/blackbox.py) from the event/span paths it
        # already runs. A rule firing emits `alert` into the events
        # ring + serving trace, bumps dpsvm_incidents_total, and (with
        # ``bundle_dir``) dumps a self-contained incident bundle.
        self.bundle_dir = bundle_dir
        self.watch: Optional[slo.Watchtower] = None
        if watch:
            self.watch = slo.Watchtower(
                slo.load_rules(watch_rules, default="serving"))
        self._c_incidents = incidents_counter(self.mreg)
        self._g_alert = None
        if self.watch is not None:
            self._g_alert = self.mreg.gauge(
                "dpsvm_alert_firing",
                "1 while the named alert rule is firing",
                labels=("rule", "severity"))
            for r in self.watch.ruleset:
                self._g_alert.labels(rule=r.name,
                                     severity=r.severity).set(0)
        self._flight = blackbox.FlightRecorder(blackbox.make_manifest(
            solver="serving",
            config={"models": list(registry.names()),
                    "replicas": int(replicas)}))
        self._events: deque = deque(maxlen=512)
        self._trace = None
        self._trace_out = trace_out
        if not (0.0 <= float(trace_sample_rate) <= 1.0):
            raise ValueError(f"trace_sample_rate must be in [0, 1], "
                             f"got {trace_sample_rate}")
        self.trace_sample_rate = float(trace_sample_rate)
        self._admitted = 0       # sampling stride counter
        self._trace_seq = 0      # request trace_id allocator
        self._t0 = time.monotonic()
        self._httpd: Optional[_Server] = None
        self._thread: Optional[threading.Thread] = None
        # The async front door (serving/frontdoor.AsyncFrontDoor)
        # attaches itself here when it wraps this core with
        # ``start(listen=False)``; /metricsz and the doctor probe read
        # its stats through this handle. None = classic threaded
        # listener.
        self.front_door = None
        for name, sib in (siblings or {}).items():
            self.set_sibling(name, sib)

    # -- metrics ------------------------------------------------------

    @property
    def uptime(self) -> float:
        return time.monotonic() - self._t0

    def count(self, key: str, tenant: Optional[str] = None) -> None:
        self._counters[key].inc()
        if tenant is not None and key in _TENANT_COUNT_KEYS:
            with self._lock:
                acc = self._tenants.setdefault(tenant,
                                               _new_tenant_acc())
                acc[key] += 1.0
            # re-resolve labels() every increment: an LRU eviction may
            # have removed this tenant's series, and a stale child
            # handle would update an orphan (metrics._Metric.remove)
            self._c_tenant[key].labels(tenant=tenant).inc()
        # every counted terminal response is one watch sample: the
        # rules see the burn as it happens, not at the next scrape
        self._watch_note()

    # -- model-fleet cache --------------------------------------------

    def _fleet_event(self, event: str, **extra) -> None:
        """The model cache's event sink: count the fault/evict, ride
        the event into the ring + serving trace, and note a watch
        sample so the model-cache-thrash rule sees the fault rate as
        it happens, not at the next counted response."""
        if event == "model_fault":
            self._c_model_faults.inc()
        elif event == "model_evict":
            self._c_model_evictions.inc()
        self.emit_event(event, **extra)
        self._watch_note()

    def serves_cold(self, name: str) -> bool:
        """Whether ``name`` routes through the model cache's cold path
        right now: the cache is armed and the registry holds no
        hydrated engine for the name. Raises KeyError for an unknown
        name (the 404)."""
        if self.model_cache is None:
            # unknown names surface as the engine lookup's KeyError
            return False
        return not self._registry_resident(name)

    def _registry_resident(self, name: str) -> bool:
        """Residency per the registry; duck-typed test registries
        without a residency surface are all-eager by construction."""
        fn = getattr(self.registry, "resident", None)
        return True if fn is None else bool(fn(name))

    def model_manifests(self) -> Dict[str, dict]:
        """``/v1/models``: the registry's manifests with the fleet
        cache's residency overlaid — a cache-managed model is
        ``resident`` iff its buffers are packed right now, regardless
        of the (never-hydrated) registry entry."""
        out = self.registry.manifests()
        if self.model_cache is not None:
            for name, man in out.items():
                if not man.get("resident"):
                    man["resident"] = bool(
                        self.model_cache.is_resident(name))
        return out

    # -- per-tenant attribution ---------------------------------------

    def admit_tenant(self, header_val, body_val,
                     model_name: str) -> str:
        """Resolve one request's tenant label at admission:
        ``X-Tenant`` header, else the body's ``tenant`` field, else
        the model name (single-tenant deployments get per-model
        attribution for free). Hostile values are sanitized
        (metrics.sanitize_tenant) and the label budget may resolve a
        long-tail tenant to ``other``."""
        raw = sanitize_tenant(header_val)
        if raw is None:
            raw = sanitize_tenant(body_val)
        if raw is None:
            raw = sanitize_tenant(model_name) or "default"
        return self.tenant_budget.resolve(raw)

    def account_request(self, tenant: str, model: str, *, rows: int,
                        ms: float, breakdown: Optional[dict] = None
                        ) -> None:
        """Bill one answered request: rows + wall to the tenant and
        the model; queue-wait and device-compute ms when the request
        recorded a span tree (the sampled-spans caveat the docs pin —
        stage lanes cover the sampled fraction, wall covers all)."""
        qw = comp = 0.0
        if breakdown:
            qw = float(breakdown.get("queue_wait") or 0.0)
            comp = float(breakdown.get("device_dispatch") or 0.0)
        with self._lock:
            acc = self._tenants.setdefault(tenant, _new_tenant_acc())
            acc["rows"] += rows
            acc["wall_ms"] += ms
            acc["queue_wait_ms"] += qw
            acc["compute_ms"] += comp
            pm = self._per_model.setdefault(
                model, {"requests": 0, "lat": deque(maxlen=2048)})
            pm["requests"] += 1
            pm["lat"].append(ms)
        self._c_tenant["rows"].labels(tenant=tenant).inc(rows)
        if qw:
            self._c_tenant["queue_wait_ms"].labels(
                tenant=tenant).inc(qw)
        if comp:
            self._c_tenant["compute_ms"].labels(
                tenant=tenant).inc(comp)
        if self._h_tenant is None:
            self._h_tenant = self.mreg.histogram(
                "dpsvm_tenant_request_latency_ms",
                "request wall latency per tenant",
                labels=("tenant",),
                buckets=DEFAULT_LATENCY_BUCKETS_MS)
        self._h_tenant.labels(tenant=tenant).observe(ms)

    def _evict_tenant(self, tenant: str) -> None:
        """TenantLabelBudget eviction callback: the evicted tenant's
        ledger row folds into ``other`` (totals survive — the tail is
        aggregated, never dropped) and its Prometheus series leave the
        exposition so live cardinality stays within budget. The
        per-tenant histogram series is removed without folding
        (bucketed observations cannot be re-attributed)."""
        with self._lock:
            acc = self._tenants.pop(tenant, None)
            if acc is not None:
                other = self._tenants.setdefault(TENANT_OTHER,
                                                 _new_tenant_acc())
                for k, v in acc.items():
                    other[k] = other.get(k, 0.0) + v
        for fam in self._c_tenant.values():
            fam.remove(tenant=tenant)
        if self._h_tenant is not None:
            self._h_tenant.remove(tenant=tenant)
        if acc is not None:
            for key in ("requests", "errors", "rejected",
                        "deadline_504", "rows", "queue_wait_ms",
                        "compute_ms"):
                v = acc.get(key, 0.0)
                if v:
                    self._c_tenant[key].labels(
                        tenant=TENANT_OTHER).inc(v)

    # -- continuous watch ---------------------------------------------

    def watch_sample(self) -> Dict[str, float]:
        """The canonical sample the serving rules evaluate
        (observability/slo.py's documented vocabulary) — all host-side
        counter reads."""
        sample = {key: float(c.value)
                  for key, c in self._counters.items()}
        with self._lock:
            batchers = dict(self._batchers)
            tenants = {t: dict(a) for t, a in self._tenants.items()}
        depth = sum(b.queue_depth for b in batchers.values())
        sample["queue_depth"] = float(depth)
        sample["queue_fill"] = (depth / self.max_queue
                                if self.max_queue else 0.0)
        # fleet-cache lanes — always present (0.0 without a cache) so
        # the model-cache-thrash rate rule has a continuous series
        sample["model_faults"] = float(self._c_model_faults.value)
        sample["model_evictions"] = float(
            self._c_model_evictions.value)
        # per-tenant lanes — the vocabulary slo.py's per_tenant rule
        # templates expand over (tenant:<name>:<metric>)
        for ten, acc in tenants.items():
            for k in ("requests", "deadline_504", "queue_wait_ms",
                      "compute_ms"):
                sample[f"tenant:{ten}:{k}"] = float(acc.get(k, 0.0))
        return sample

    def _watch_note(self) -> None:
        if self.watch is None:
            return
        try:
            transitions = self.watch.observe(self.watch_sample())
        except Exception:
            return                  # watching must never kill serving
        for tr in transitions:
            self._on_alert(tr)

    def _on_alert(self, tr: dict) -> None:
        """One rule transition: events ring + serving trace + metrics,
        and on a firing, the incident bundle."""
        firing = tr["state"] == "firing"
        # a per-tenant rule's transition names its tenant — ride it on
        # the event/incident records so a bundle can name the culprit
        ten = {"tenant": tr["tenant"]} if tr.get("tenant") else {}
        if self._g_alert is not None:
            self._g_alert.labels(rule=tr["rule"],
                                 severity=tr["severity"]).set(
                                     1 if firing else 0)
        self.emit_event("alert", rule=tr["rule"], window=tr["window"],
                        severity=tr["severity"], state=tr["state"],
                        reason=tr["reason"], **ten)
        if not firing:
            return
        self._c_incidents.inc()
        self._flight.snapshot_metrics(self.mreg)
        if self.bundle_dir:
            extra = {"source": "serving",
                     "counters": {k: int(c.value) for k, c
                                  in self._counters.items()}}
            extra.update(ten)
            path = blackbox.dump_bundle(
                self.bundle_dir, recorder=self._flight,
                rule=tr["rule"], severity=tr["severity"],
                window=tr["window"], reason=tr["reason"],
                registry=self.mreg, extra=extra)
            if path:
                self.emit_event("incident", rule=tr["rule"],
                                window=tr["window"],
                                severity=tr["severity"], bundle=path,
                                **ten)

    def observe_latency(self, ms: float) -> None:
        self._h_latency.observe(ms)      # the Prometheus histogram
        with self._lock:
            self._lat_ms.append(ms)      # exact percentiles for JSON

    def _collect_gauges(self) -> None:
        """Pre-scrape hook (mreg collector): gauges derived from live
        state, refreshed at render/snapshot time."""
        self._g_uptime.set(self.uptime)
        self._g_draining.set(1 if self.draining else 0)
        with self._lock:
            batchers = dict(self._batchers)
            pools = dict(self._pools)
        expired = 0
        for name, b in batchers.items():
            self._g_queue.labels(model=name).set(b.queue_depth)
            expired += b.stats().get("expired", 0)
        self._g_expired.set(expired)
        for name, p in pools.items():
            self._g_healthy.labels(model=name).set(p.n_healthy)

    def metrics_text(self) -> str:
        """`/metricsz?format=prometheus`: the registry's text
        exposition (collectors run first, so derived gauges are
        fresh)."""
        return self.mreg.render_prometheus()

    def observe_scores(self, decision) -> None:
        """Feed decision values into the rolling score-distribution
        window — what the drift detector (serving/lifecycle.py) and
        /metricsz's ``score_window`` read. Multiclass (m, P) pairwise
        matrices are flattened: drift in ANY pair's scores counts."""
        if decision is None:
            return
        vals = np.asarray(decision, np.float64).ravel()
        with self._lock:
            self._scores.extend(float(v) for v in vals)

    def score_window(self) -> np.ndarray:
        with self._lock:
            return np.asarray(self._scores, np.float64)

    # -- resilience policy --------------------------------------------

    def budget_for(self, raw, tenant: Optional[str] = None) -> Budget:
        """The request's deadline budget: ``timeout_ms`` (body) /
        ``X-Deadline-Ms`` (header), capped by the server-wide
        ``predict_timeout``. Invalid values are a 400 (ValueError).
        ``tenant`` rides the budget across threads so deadline
        accounting downstream bills the right tenant."""
        if raw is None:
            return Budget(self.predict_timeout, tenant=tenant)
        try:
            ms = float(raw)
        except (TypeError, ValueError):
            raise ValueError(f"timeout_ms must be a number, got {raw!r}")
        if not (math.isfinite(ms) and ms > 0):
            raise ValueError(f"timeout_ms must be finite and > 0, "
                             f"got {raw!r}")
        return Budget(min(ms / 1000.0, self.predict_timeout),
                      tenant=tenant)

    def set_sibling(self, name: str, sibling: str) -> None:
        """Register ``sibling`` as the tier-2 degradation target for
        ``name`` (typically the approx twin of an exact model). Both
        must be registered and agree on feature width."""
        e, s = self.registry.engine(name), self.registry.engine(sibling)
        if e.num_attributes != s.num_attributes:
            raise ValueError(
                f"sibling {sibling!r} has {s.num_attributes} "
                f"attributes, {name!r} expects {e.num_attributes}")
        with self._lock:
            self._siblings[name] = sibling

    def sibling(self, name: str) -> Optional[str]:
        with self._lock:
            return self._siblings.get(name)

    def degrade(self, name: str, want: tuple
                ) -> "tuple[str, tuple, Optional[str]]":
        """Apply the shed ladder for one request: returns
        (effective model, effective want, degraded marker or None)."""
        tier = self.degrader.tier_for(
            self.batcher(name).queue_depth, self.max_queue)
        if self.degrader.note(tier) and tier != TIER_NONE:
            self.emit_event("shed", model=name, tier=tier)
        if tier == TIER_NONE:
            return name, want, None
        degraded = None
        if tier >= TIER_SHED_PROBA and "proba" in want:
            want = tuple(w for w in want if w != "proba") or ("decision",)
            degraded = "shed_proba"
            self.count("shed_proba")
        if tier >= TIER_SHED_SIBLING:
            sib = self.sibling(name)
            if sib is not None:
                self.count("shed_sibling")
                return sib, want, f"sibling:{sib}"
        return name, want, degraded

    # -- request-scoped spans -----------------------------------------

    def start_request_spans(self, force: bool = False
                            ) -> Optional[RequestSpans]:
        """Open a span tree for an admitted request, or None.

        Sampled requests (deterministic stride at
        ``trace_sample_rate`` — observability/spans.should_sample) are
        recorded only while a serving trace is open (the records need
        somewhere to land); ``force`` (the X-Trace-Spans header)
        records regardless, so the loadgen breakdown works against a
        server with no --trace-out. The unsampled fast path is one
        counter increment."""
        with self._lock:
            i = self._admitted
            self._admitted += 1
            take = force or (self._trace is not None
                             and should_sample(i, self.trace_sample_rate))
            if not take:
                return None
            self._trace_seq += 1
            tid = f"req-{self._trace_seq}"
        # admission opens WITH the root (same timestamp): parse +
        # validate is stage 1 of every request
        return RequestSpans(tid, first_stage="admission")

    def finish_request_spans(self, rs: Optional[RequestSpans],
                             status: Optional[int] = None,
                             budget=None, **extra) -> Optional[dict]:
        """Close a request's span tree: end the root (with the HTTP
        status + deadline accounting), feed the per-stage histograms,
        emit the records into the serving trace when one is open, and
        return the stage breakdown (ms). Once-only (None / already
        finished = no-op), and never raises into the serving path."""
        if rs is None or rs.finished:
            return None
        ex = dict(extra)
        if status is not None:
            ex["status"] = int(status)
        if budget is not None:
            try:
                ex.update(budget.describe())
            except Exception:
                pass
        try:
            rs.finish(**ex)
            bd = rs.breakdown()
            self._c_spans.inc()
            if self._h_span is None:
                self._h_span = self.mreg.histogram(
                    "dpsvm_serving_span_ms",
                    "per-stage request latency from sampled span "
                    "trees",
                    labels=("span",),
                    buckets=DEFAULT_LATENCY_BUCKETS_MS)
            for stage, ms in bd.items():
                if stage != "total_ms":
                    self._h_span.labels(span=stage).observe(ms)
            with self._lock:
                tr = self._trace
            if tr is not None:
                rs.emit_into(tr)
            try:
                rs.emit_into(self._flight)   # the black-box copy
            except Exception:
                pass
            return bd
        except Exception:
            return None                # attribution never kills serving

    # -- events + serving trace ---------------------------------------

    def emit_event(self, event: str, **extra) -> None:
        """Robustness event sink: in-memory ring (for /metricsz and
        tests) + the serving trace when one is open + the black-box
        flight recorder (so a bundle dumped later carries the recent
        eject/rebuild/shed/alert history)."""
        with self._lock:
            self._events.append({"event": event, "t": round(
                self.uptime, 3), **extra})
            tr = self._trace
        if tr is not None:
            try:
                tr.event(event, **extra)
            except Exception:
                pass                   # tracing must not kill serving
        try:
            self._flight.event(event, **extra)
        except Exception:
            pass

    def metrics(self) -> dict:
        counters = {k: int(c.value) for k, c in self._counters.items()}
        with self._lock:
            lat = np.asarray(self._lat_ms, np.float64)
            scores = np.asarray(self._scores, np.float64)
            batchers = dict(self._batchers)
            pools = dict(self._pools)
            events = list(self._events)
            tenants_acc = {t: dict(a)
                           for t, a in self._tenants.items()}
            per_model_acc = {
                m: {"requests": d["requests"],
                    "lat": np.asarray(d["lat"], np.float64)}
                for m, d in self._per_model.items()}
        out = dict(counters)
        out["uptime_s"] = round(self.uptime, 3)
        out["draining"] = self.draining
        out["spans_sampled"] = int(self._c_spans.value)
        # continuous-watch state: the same rule states the Prometheus
        # exposition carries as dpsvm_alert_firing series
        out["alerts"] = (self.watch.states()
                         if self.watch is not None else [])
        out["incidents_total"] = int(self._c_incidents.value)
        if lat.size:
            p50, p95, p99 = np.percentile(lat, [50.0, 95.0, 99.0])
            out["latency_ms"] = {"count": int(lat.size),
                                 "p50": round(float(p50), 3),
                                 "p95": round(float(p95), 3),
                                 "p99": round(float(p99), 3)}
        else:
            out["latency_ms"] = {"count": 0, "p50": None, "p95": None,
                                 "p99": None}
        # the rolling score-distribution window the drift detector
        # reads (summary over HTTP; LifecycleLoop reads score_window())
        if scores.size:
            q5, q50, q95 = np.percentile(scores, [5.0, 50.0, 95.0])
            out["score_window"] = {
                "count": int(scores.size),
                "mean": round(float(np.mean(scores)), 6),
                "std": round(float(np.std(scores)), 6),
                "p5": round(float(q5), 6), "p50": round(float(q50), 6),
                "p95": round(float(q95), 6)}
        else:
            out["score_window"] = {"count": 0, "mean": None,
                                   "std": None, "p5": None, "p50": None,
                                   "p95": None}
        out["degrade"] = self.degrader.stats()
        # pool-level robustness counters, totalled and per model
        totals = {"ejections": 0, "rebuilds": 0, "hedges_fired": 0,
                  "hedges_won": 0, "redispatches": 0, "timeouts": 0,
                  "stray_compiles": 0}
        out["expired"] = 0
        models = {}
        for name, b in batchers.items():
            st = b.stats()
            out["expired"] += st.get("expired", 0)
            try:
                st["bucket_histogram"] = {
                    str(k): v for k, v in sorted(
                        self.registry.engine(name).bucket_counts().items())
                    if v}
            except KeyError:
                pass
            pool = pools.get(name)
            if pool is not None:
                pm = pool.metrics()
                st["pool"] = pm
                for k in totals:
                    totals[k] += pm.get(k, 0)
            models[name] = st
        out.update(totals)
        out["models"] = models
        # per-model request/latency view: registry models that have
        # not served yet still appear, zeroed — a dashboard can tile
        # the fleet without learning the model list elsewhere
        per_model = {}
        for name in self.registry.names():
            d = per_model_acc.get(name)
            lat_m = (d["lat"] if d is not None
                     else np.asarray([], np.float64))
            if lat_m.size:
                p50, p95, p99 = np.percentile(lat_m,
                                              [50.0, 95.0, 99.0])
                lat_out = {"count": int(lat_m.size),
                           "p50": round(float(p50), 3),
                           "p95": round(float(p95), 3),
                           "p99": round(float(p99), 3)}
            else:
                lat_out = {"count": 0, "p50": None, "p95": None,
                           "p99": None}
            st = models.get(name) or {}
            per_model[name] = {
                "requests": int(d["requests"]) if d is not None else 0,
                "latency_ms": lat_out,
                "queue_depth_rows": int(st.get("queue_depth_rows",
                                               0))}
        out["per_model"] = per_model
        # per-tenant cost ledger + label-budget health — the JSON twin
        # of the dpsvm_tenant_* Prometheus families (and the source
        # slo.sample_from_metricsz_json flattens into tenant: lanes)
        tb = self.tenant_budget.stats()
        out["tenants"] = {
            "budget": tb["budget"], "live": tb["live"],
            "evictions": tb["evictions"], "overflow": tb["overflow"],
            "per_tenant": {
                ten: {"requests": int(a["requests"]),
                      "errors": int(a["errors"]),
                      "rejected": int(a["rejected"]),
                      "deadline_504": int(a["deadline_504"]),
                      "rows": int(a["rows"]),
                      "wall_ms": round(a["wall_ms"], 3),
                      "queue_wait_ms": round(a["queue_wait_ms"], 3),
                      "compute_ms": round(a["compute_ms"], 3)}
                for ten, a in sorted(tenants_acc.items())}}
        # fleet model-cache block (docs/SERVING.md "Model fleet") —
        # the JSON twin of dpsvm_fleet_model_*_total, and the source
        # slo.sample_from_metricsz_json + the doctor probe read
        if self.model_cache is not None:
            out["model_cache"] = self.model_cache.stats()
        # front-door block (docs/SERVING.md "Front door"): which
        # transport answers connections, how many are open, and the
        # per-tenant fair-queue lane depths — the source the doctor
        # probe reads. The threaded listener has no connection cap or
        # admission queue, so its block is just the kind marker.
        fd = self.front_door
        out["front_door"] = (fd.stats() if fd is not None
                             else {"kind": "threaded"})
        out["events"] = events[-64:]
        return out

    # -- pools + batchers ---------------------------------------------

    def pool(self, name: str) -> ReplicaPool:
        """The model's replica pool (created on first use; ``start()``
        pre-creates one per registered model so the replica builds are
        paid at boot, not on the first request). The first replica
        shares the registry's already-warm engine; later replicas —
        and every post-ejection rebuild — are fresh engines built from
        the CURRENT registry source."""
        with self._lock:
            p = self._pools.get(name)
        if p is not None:
            return p
        with self._pool_create_lock:   # serialize expensive builds
            with self._lock:
                p = self._pools.get(name)
            if p is not None:
                return p
            shared = {"used": False}

            def build(i, _name=name):
                if not shared["used"]:
                    shared["used"] = True
                    return self.registry.engine(_name)
                return self.registry.build(_name)

            p = ReplicaPool(build, self.replicas, name=name,
                            deadline_s=self.predict_timeout,
                            hedge=self.hedge, watch_compiles=True,
                            on_event=self.emit_event,
                            metrics=self.mreg)
            with self._lock:
                self._pools[name] = p
            return p

    def refresh_pool(self, name: str) -> None:
        """Rolling-rebuild the model's replicas from the current
        registry generation — the pool side of a hot reload/promote."""
        with self._lock:
            p = self._pools.get(name)
        if p is not None:
            p.refresh()

    def batcher(self, name: str) -> MicroBatcher:
        with self._lock:
            b = self._batchers.get(name)
            if b is None:
                # All device work routes through the replica pool; the
                # pool resolves engines per dispatch, so a hot reload
                # (pool refresh) swaps under a live batcher. `spans`
                # rides through so the pool can hang replica_compute /
                # hedge spans under each request's dispatch stage.
                def infer_fn(x, want, deadline=None, spans=(),
                             _name=name):
                    return self.pool(_name).infer(x, want,
                                                  deadline=deadline,
                                                  spans=spans)
                b = MicroBatcher(infer_fn, max_batch=self.max_batch,
                                 max_delay_ms=self.max_delay_ms,
                                 max_queue=self.max_queue)
                self._batchers[name] = b
            return b

    # -- lifecycle ----------------------------------------------------

    @property
    def port(self) -> int:
        if self._httpd is None:
            raise RuntimeError("server not started")
        return int(self._httpd.server_address[1])

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self, listen: bool = True) -> "ServingServer":
        """Open the trace, arm the emergency bundle, pre-build pools —
        and (by default) start the threaded HTTP listener.
        ``listen=False`` does everything EXCEPT the listener: the async
        front door (serving/frontdoor.py) wraps a core started this
        way and brings its own event-loop transport, so the two front
        ends share one request core instead of forking it."""
        if self._trace_out:
            from dpsvm_tpu_torch.observability.record import open_serving_trace
            self._trace = open_serving_trace(
                self._trace_out,
                models={n: {"replicas": self.replicas}
                        for n in self.registry.names()},
                sample_rate=self.trace_sample_rate)
        if self.bundle_dir:
            # hard exits (watchdog stall, crash handlers) still land a
            # bundle: record.flush_open_traces -> blackbox emergency
            blackbox.arm_emergency(self._flight, self.bundle_dir,
                                   self.mreg)
        for name in self.registry.names():
            # replica builds paid at boot — but only for HYDRATED
            # entries: pre-creating a pool for a lazy registration
            # would defeat the whole point of the seconds-not-minutes
            # fleet boot (a lazy model's pool builds on first request,
            # or never, if the model cache serves it cold)
            if self._registry_resident(name):
                self.pool(name)
        if not listen:
            return self
        self._httpd = _Server((self.host, self.requested_port), _Handler)
        self._httpd.owner = self
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="dpsvm-serve-http",
                                        kwargs={"poll_interval": 0.1},
                                        daemon=True)
        self._thread.start()
        return self

    def drain(self, timeout: float = 30.0) -> None:
        """Graceful shutdown: refuse new work, answer everything
        already accepted, then close the listener."""
        self.draining = True
        blackbox.disarm_emergency(self._flight)
        with self._lock:
            batchers = list(self._batchers.values())
        for b in batchers:                  # finish every queued batch
            b.close(drain=True, timeout=timeout)
        with self._lock:
            pools = list(self._pools.values())
        for p in pools:
            p.close()
        if self._httpd is not None:
            self._httpd.shutdown()          # stop the accept loop
            self._httpd.server_close()      # join handler threads
        if self._thread is not None:
            self._thread.join(timeout)
        with self._lock:
            tr, self._trace = self._trace, None
        counters = {k: int(c.value) for k, c in self._counters.items()}
        if tr is not None:
            from dpsvm_tpu_torch.observability.record import close_serving_trace
            close_serving_trace(tr, requests=counters["requests"],
                                errors=counters["errors"],
                                seconds=self.uptime,
                                rejected=counters["rejected"],
                                deadline_504=counters["deadline_504"],
                                spans_sampled=int(self._c_spans.value))

    def serve_until_signal(self) -> int:
        """Run until SIGTERM/SIGINT, then drain. Returns the signal
        number (0 if drained for another reason). Reuses the deferred-
        signal trap from ``resilience/preempt``: the handler only sets
        a flag; the drain runs here, on the main thread, at a moment of
        our choosing — never inside a signal frame."""
        from dpsvm_tpu_torch.resilience import preempt

        signum = 0
        with preempt.trap():
            while True:
                pending = preempt.pending()
                if pending is not None:
                    signum = pending
                    break
                time.sleep(0.05)
        self.drain()
        return signum

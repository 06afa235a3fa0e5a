"""Async serving front door: event-loop admission over the batched core
(port of ``dpsvm_tpu/serving/frontdoor.py``).

The threaded front end (``serving/server.py``) spends one OS thread
per open connection — fine at hundreds of clients, a wall at thousands
(10k idle keep-alive connections would mean 10k stacks before the
device sees a single row). This module replaces only the TRANSPORT:
one asyncio event loop holds every connection, parses and validates on
the loop, and feeds the same ``ServingServer`` core — registry,
MicroBatcher, ReplicaPool, degrade ladder, tenant accounting, watch
rules, spans — through ``start(listen=False)``. The two front ends
share one request core, so responses are bitwise-identical between
them (the serving selfcheck's front-door gate pins this).

Between the loop and the batcher sits the **weighted-fair admission
queue** (``serving/fairqueue.py``): requests are validated, billed to
their resolved tenant label, and parked in that tenant's lane; a
dispatcher task drains lanes in deficit-round-robin order into the
MicroBatcher, keeping only a bounded number of rows in flight
(~2 batches) so the batcher's FIFO stays shallow and the DRR order —
not arrival order — decides who runs. One hot tenant saturating its
lane backs up ITS OWN requests (429 on lane overflow) while other
tenants' requests keep jumping to the device; the
``tenant-fair-share`` watchtower rule, which fires under skewed load
on the threaded path, stays quiet here (the win detector the burst
drill measures).

Span attribution grows one stage: ``admission`` (parse + validate) ->
``fair_queue`` (DRR wait in the tenant lane) -> ``queue_wait`` (the
batcher FIFO, short by construction) -> ``batch_form`` ->
``device_dispatch`` -> ``respond`` (docs/OBSERVABILITY.md "Spans").

The waiting is free: a parked request is a future on the loop, not a
blocked thread. The batcher's ticket ``on_done`` callback trampolines
completion back to the loop (``call_soon_threadsafe``), so the only
threads in the process stay the batcher workers and the pool — the
HTTP layer never blocks one.

Shutdown mirrors the threaded drain (``resilience/preempt`` deferred
trap): on SIGTERM, healthz turns 503 and the listener closes, every
request already admitted — parked in a lane, riding a batch, or
writing its response — is answered, THEN the core drains (batchers,
pools, trace) and the loop stops. Exit code 0; the subprocess test
pins it like the threaded one.
"""

from __future__ import annotations

import asyncio
import json
import socket
import threading
import time
from http.client import responses as _HTTP_REASONS
from typing import Dict, Optional

import numpy as np

from dpsvm_tpu_torch.observability.metrics import (PROMETHEUS_CONTENT_TYPE,
                                             wants_prometheus)
from dpsvm_tpu_torch.serving.batcher import (KNOWN_OUTPUTS, BatcherClosedError,
                                       QueueFullError)
from dpsvm_tpu_torch.serving.budget import DeadlineExceededError
from dpsvm_tpu_torch.serving.fairqueue import (DEFAULT_QUANTUM_ROWS, FairQueue,
                                         LaneFullError)
from dpsvm_tpu_torch.serving.pool import PoolUnavailableError
from dpsvm_tpu_torch.serving.server import MAX_BODY_BYTES, _jsonable

#: default open-connection cap (--max-connections): beyond it new
#: connections get an immediate 503 + close instead of an accept-queue
#: stall nobody can see.
DEFAULT_MAX_CONNECTIONS = 10000


class _Pending:
    """One admitted request parked in a fair-queue lane: everything
    the dispatcher needs to submit it, plus the loop future its
    coroutine awaits."""

    __slots__ = ("x", "ride", "deadline", "rs", "eff_name", "rows",
                 "future", "cancelled", "ticket")

    def __init__(self, x, ride, deadline, rs, eff_name, rows, future):
        self.x = x
        self.ride = ride
        self.deadline = deadline
        self.rs = rs
        self.eff_name = eff_name
        self.rows = rows
        self.future = future
        self.cancelled = False
        self.ticket = None


class AsyncFrontDoor:
    """Event-loop HTTP transport over a ``ServingServer`` core
    (module docstring).

    The core must NOT be started by the caller — ``start()`` runs it
    with ``listen=False`` (trace, emergency bundle, pool pre-builds)
    and brings the asyncio listener in its place. ``tenant_weights``
    maps tenant label -> DRR weight (``--tenant-weight NAME=W``,
    default 1; the ``other`` long-tail bucket shares one lane by
    construction of the tenant label budget)."""

    def __init__(self, core, *, host: Optional[str] = None,
                 port: Optional[int] = None,
                 max_connections: int = DEFAULT_MAX_CONNECTIONS,
                 tenant_weights: Optional[Dict[str, float]] = None,
                 lane_capacity: Optional[int] = None,
                 quantum: int = DEFAULT_QUANTUM_ROWS,
                 inflight_rows: Optional[int] = None):
        if max_connections < 1:
            raise ValueError(f"max_connections must be >= 1, got "
                             f"{max_connections}")
        self.core = core
        self.host = host if host is not None else core.host
        self.requested_port = (int(port) if port is not None
                               else core.requested_port)
        self.max_connections = int(max_connections)
        self._weights = dict(tenant_weights or {})
        self._fq = FairQueue(
            weights=self._weights,
            lane_capacity=(int(lane_capacity) if lane_capacity
                           else core.max_queue),
            quantum=quantum)
        # rows allowed past the fair queue at once: enough to keep the
        # batcher worker forming full buckets (~2 batches), small
        # enough that DRR order — not the batcher FIFO — decides
        # service order under backlog
        self._inflight_limit = (int(inflight_rows) if inflight_rows
                                else max(2 * core.max_batch, 1))
        self._inflight_rows = 0
        self._active_requests = 0
        self._conns: set = set()
        self._accepted = 0
        self._rejected_conns = 0
        self._closing = False
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._dispatcher: Optional[asyncio.Task] = None
        self._wake: Optional[asyncio.Event] = None
        self._g_open = None
        self._g_lane = None

    # -- lifecycle ----------------------------------------------------

    def start(self) -> "AsyncFrontDoor":
        self.core.start(listen=False)
        self.core.front_door = self
        mreg = self.core.mreg
        self._g_open = mreg.gauge(
            "dpsvm_frontdoor_open_connections",
            "open HTTP connections on the async front door")
        self._g_lane = mreg.gauge(
            "dpsvm_frontdoor_queue_lane_rows",
            "rows waiting in the per-tenant fair-queue lane",
            labels=("tenant",))
        mreg.add_collector(self._collect_gauges)
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self._loop.run_forever,
                                        name="dpsvm-frontdoor",
                                        daemon=True)
        self._thread.start()
        fut = asyncio.run_coroutine_threadsafe(self._start_async(),
                                               self._loop)
        fut.result(timeout=30)
        return self

    async def _start_async(self) -> None:
        self._wake = asyncio.Event()
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.requested_port)
        self._dispatcher = asyncio.get_running_loop().create_task(
            self._dispatch_loop())

    @property
    def port(self) -> int:
        if self._server is None:
            raise RuntimeError("front door not started")
        return int(self._server.sockets[0].getsockname()[1])

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def drain(self, timeout: float = 30.0) -> None:
        """SIGTERM semantics, front-door ordering: stop accepting,
        answer EVERYTHING already admitted (lanes empty, no rows in
        flight, no response mid-write), then drain the core (batchers
        with drain=True find empty queues, pools, trace) and stop the
        loop. The fair queue drains BEFORE the core's batchers close —
        the reverse order would 503 requests this process already
        accepted."""
        self.core.draining = True
        if self._loop is not None:
            try:
                asyncio.run_coroutine_threadsafe(
                    self._drain_async(timeout),
                    self._loop).result(timeout + 10)
            except Exception:
                pass            # bounded: the core drain still runs
        self.core.drain(timeout)
        self._stop_loop()

    async def _drain_async(self, timeout: float) -> None:
        self._closing = True
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        deadline = time.perf_counter() + timeout
        while ((len(self._fq) or self._inflight_rows
                or self._active_requests)
               and time.perf_counter() < deadline):
            if self._wake is not None:
                self._wake.set()
            await asyncio.sleep(0.01)
        if self._dispatcher is not None:
            self._dispatcher.cancel()

    def _stop_loop(self) -> None:
        loop, self._loop = self._loop, None
        if loop is None:
            return

        def _close():
            for w in list(self._conns):
                try:
                    w.close()
                except Exception:
                    pass
            loop.stop()

        loop.call_soon_threadsafe(_close)
        if self._thread is not None:
            self._thread.join(10)
        try:
            loop.close()
        except Exception:
            pass

    def serve_until_signal(self) -> int:
        """Run until SIGTERM/SIGINT, then drain (the threaded server's
        contract, same deferred-signal trap — the handler only sets a
        flag, the drain runs here on the main thread)."""
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

    # -- facts --------------------------------------------------------

    def _collect_gauges(self) -> None:
        if self._g_open is not None:
            self._g_open.set(len(self._conns))
        if self._g_lane is not None:
            for tenant, rows in self._fq.depths().items():
                self._g_lane.labels(tenant=tenant).set(rows)

    def stats(self) -> dict:
        """The ``front_door`` block of /metricsz (and the doctor
        probe's source)."""
        return {
            "kind": "async",
            "open_connections": len(self._conns),
            "max_connections": self.max_connections,
            "connections_accepted": int(self._accepted),
            "connections_rejected": int(self._rejected_conns),
            "inflight_rows": int(self._inflight_rows),
            "inflight_limit_rows": int(self._inflight_limit),
            "tenant_weights": dict(self._weights),
            "fair_queue": self._fq.stats(),
        }

    # -- dispatcher (fair queue -> batcher) ---------------------------

    async def _dispatch_loop(self) -> None:
        while True:
            await self._wake.wait()
            self._wake.clear()
            while self._inflight_rows < self._inflight_limit:
                got = self._fq.pop()
                if got is None:
                    break
                _lane, item, _rows = got
                if item.cancelled:
                    continue        # waiter already gave up (504)
                self._submit(item)

    def _submit(self, item: _Pending) -> None:
        loop = asyncio.get_running_loop()

        def on_done(ticket, _item=item):
            # worker thread -> loop: resolve the parked future. Must
            # be cheap and never raise (batcher._notify swallows, but
            # a dead loop at shutdown shouldn't even get that far).
            try:
                loop.call_soon_threadsafe(self._ticket_done, _item,
                                          ticket)
            except RuntimeError:
                pass                # loop closed mid-drain

        try:
            item.ticket = self.core.batcher(item.eff_name).submit(
                item.x, item.ride, deadline=item.deadline,
                spans=item.rs, on_done=on_done)
        except Exception as e:      # QueueFull/Closed/ValueError -> the
            if not item.future.done():      # waiter maps it to HTTP
                item.future.set_exception(e)
            else:
                item.future.exception()     # consumed; no loop warning
            return
        self._inflight_rows += item.rows

    def _ticket_done(self, item: _Pending, ticket) -> None:
        self._inflight_rows -= item.rows
        if self._wake is not None:
            self._wake.set()
        if not item.future.done():
            item.future.set_result(ticket)

    # -- connection handling ------------------------------------------

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        sock = writer.get_extra_info("socket")
        if sock is not None:
            try:                    # same rationale as the threaded
                sock.setsockopt(socket.IPPROTO_TCP,  # front end: the
                                socket.TCP_NODELAY, 1)  # delayed-ACK
            except OSError:                             # stall
                pass
        if self._closing or len(self._conns) >= self.max_connections:
            self._rejected_conns += 1
            try:
                await self._respond(
                    writer, 503,
                    {"error": f"connection limit "
                              f"({self.max_connections}) reached"},
                    keep=False)
            except Exception:
                pass
            writer.close()
            return
        self._conns.add(writer)
        self._accepted += 1
        try:
            while True:
                keep = await self._one_request(reader, writer)
                if not keep:
                    break
        except (ConnectionResetError, BrokenPipeError,
                asyncio.IncompleteReadError):
            pass
        finally:
            self._conns.discard(writer)
            try:
                writer.close()
            except Exception:
                pass

    async def _one_request(self, reader, writer) -> bool:
        """Parse + answer one HTTP/1.1 exchange; returns keep-alive."""
        try:
            line = await reader.readline()
        except (ValueError, ConnectionError):
            return False
        if not line or not line.strip():
            return False            # EOF / client closed keep-alive
        try:
            method, path, _version = line.decode("latin-1").split()
        except ValueError:
            await self._respond(writer, 400,
                                {"error": "malformed request line"},
                                keep=False)
            return False
        headers: Dict[str, str] = {}
        while True:
            h = await reader.readline()
            if not h or h in (b"\r\n", b"\n"):
                break
            k, sep, v = h.decode("latin-1").partition(":")
            if sep:
                headers[k.strip().lower()] = v.strip()
        try:
            n = int(headers.get("content-length") or 0)
        except ValueError:
            await self._respond(writer, 400,
                                {"error": "malformed Content-Length"},
                                keep=False)
            return False
        if n > MAX_BODY_BYTES:
            await self._respond(
                writer, 413,
                {"error": f"body over {MAX_BODY_BYTES} bytes"},
                keep=False)
            return False
        raw = (await reader.readexactly(n)) if n else b"{}"
        keep = headers.get("connection", "").lower() != "close"
        self._active_requests += 1
        try:
            await self._route(writer, method, path, headers, raw, keep)
        except (ConnectionResetError, BrokenPipeError):
            return False
        except Exception as e:      # a handler bug answers 500, never
            try:                    # kills the connection loop silently
                await self._respond(writer, 500,
                                    {"error": f"internal: "
                                              f"{type(e).__name__}: "
                                              f"{e}"},
                                    keep=False)
            except Exception:
                pass
            return False
        finally:
            self._active_requests -= 1
        return keep

    async def _respond(self, writer, code: int, payload,
                       keep: bool = True, content_type: str =
                       "application/json",
                       extra_headers=()) -> None:
        if isinstance(payload, (bytes, str)):
            body = (payload.encode()
                    if isinstance(payload, str) else payload)
        else:
            body = json.dumps(payload, default=_jsonable).encode()
        reason = _HTTP_REASONS.get(code, "")
        head = [f"HTTP/1.1 {code} {reason}",
                "Server: dpsvm-serve-async",
                f"Content-Type: {content_type}",
                f"Content-Length: {len(body)}"]
        for k, v in extra_headers:
            head.append(f"{k}: {v}")
        if not keep:
            head.append("Connection: close")
        writer.write(("\r\n".join(head) + "\r\n\r\n").encode("latin-1")
                     + body)
        await writer.drain()

    async def _route(self, writer, method: str, path: str, headers,
                     raw: bytes, keep: bool) -> None:
        core = self.core
        if method == "GET" and path == "/healthz":
            if core.draining:
                await self._respond(writer, 503,
                                    {"status": "draining",
                                     "models": core.registry.names()},
                                    keep)
            else:
                await self._respond(
                    writer, 200,
                    {"status": "ok", "models": core.registry.names(),
                     "uptime_s": round(core.uptime, 3)}, keep)
        elif method == "GET" and path.startswith("/metricsz"):
            if wants_prometheus(path):
                await self._respond(writer, 200, core.metrics_text(),
                                    keep,
                                    content_type=PROMETHEUS_CONTENT_TYPE)
            else:
                await self._respond(writer, 200, core.metrics(), keep)
        elif method == "GET" and path == "/v1/models":
            await self._respond(writer, 200,
                                {"models": core.model_manifests()},
                                keep)
        elif method == "POST" and path == "/v1/predict":
            await self._predict(writer, headers, raw, keep)
        elif method == "POST" and path == "/v1/reload":
            await self._reload(writer, raw, keep)
        else:
            await self._respond(writer, 404,
                                {"error": f"no route {path}"}, keep)

    async def _reload(self, writer, raw: bytes, keep: bool) -> None:
        core = self.core
        try:
            body = json.loads(raw or b"{}")
        except json.JSONDecodeError as e:
            await self._respond(writer, 400,
                                {"error": f"bad JSON body: {e}"}, keep)
            return
        name = (body.get("model", "default")
                if isinstance(body, dict) else "default")
        try:
            # engine build = device packing + warmup: off the loop
            engine = await asyncio.to_thread(core.registry.reload, name)
        except KeyError as e:
            await self._respond(writer, 404, {"error": str(e)}, keep)
            return
        except (ValueError, OSError) as e:
            await self._respond(
                writer, 400,
                {"error": f"reload failed (old model still serving): "
                          f"{e}"}, keep)
            return
        core.refresh_pool(name)
        man = dict(engine.manifest)
        man["generation"] = core.registry.manifests()[name]["generation"]
        await self._respond(writer, 200,
                            {"reloaded": name, "manifest": man}, keep)

    # -- the predict path ---------------------------------------------

    async def _predict(self, writer, headers, raw: bytes,
                       keep: bool) -> None:
        """Mirror of the threaded ``_Handler._predict`` — same
        validation order, same status mapping, same accounting — with
        the direct batcher submit replaced by fair-queue admission +
        the parked-future wait. Kept in lockstep on purpose: the
        selfcheck's front-door gate asserts bitwise-equal responses
        between the two transports."""
        core = self.core
        t0 = time.perf_counter()
        rs = None

        async def send(code, payload, extra_headers=()):
            # span back-stop, as in the threaded _send: whatever path
            # produced this response finishes the tree with its status
            if rs is not None and not rs.finished:
                core.finish_request_spans(rs, status=code)
            await self._respond(writer, code, payload, keep,
                                extra_headers=extra_headers)

        if core.draining:
            core.count("errors")
            await send(503, {"error": "draining"})
            return
        want_spans_back = (str(headers.get("x-trace-spans", ""))
                           .lower() in ("1", "true", "yes"))
        rs = core.start_request_spans(force=want_spans_back)
        try:
            body = json.loads(raw or b"{}")
        except json.JSONDecodeError as e:
            core.count("errors")
            await send(400, {"error": f"bad JSON body: {e}"})
            return
        if not isinstance(body, dict):
            core.count("errors")
            await send(400, {"error": "body must be a JSON object"})
            return
        name = body.get("model", "default")
        tenant = core.admit_tenant(headers.get("x-tenant"),
                                   body.get("tenant"), name)
        if rs is not None:
            rs.tenant = tenant
            rs.model = name
        want = tuple(body.get("return") or ("labels", "decision"))
        inst = body.get("instances")
        engine = None
        try:
            cold = core.serves_cold(name)
            if not cold:
                engine = core.registry.engine(name)
        except KeyError as e:
            core.count("errors", tenant=tenant)
            await send(404, {"error": str(e)})
            return
        if inst is None:
            core.count("errors", tenant=tenant)
            await send(400, {"error": "missing 'instances'"})
            return
        try:
            x = np.asarray(inst, dtype=np.float32)
        except (ValueError, TypeError) as e:
            core.count("errors", tenant=tenant)
            await send(400, {"error": f"instances not numeric: {e}"})
            return
        if not np.all(np.isfinite(x)):
            core.count("errors", tenant=tenant)
            await send(400, {"error": "instances contain non-finite "
                                      "values"})
            return
        if x.ndim == 1:
            x = x[None, :]
        if x.ndim != 2 or x.shape[0] == 0 or (
                engine is not None
                and x.shape[1] != engine.num_attributes):
            d = engine.num_attributes if engine is not None else "d"
            core.count("errors", tenant=tenant)
            await send(400, {"error": f"instances must be a non-empty "
                                      f"(m, {d}) matrix, got shape "
                                      f"{list(x.shape)}"})
            return
        if x.shape[0] > core.max_queue:
            core.count("errors", tenant=tenant)
            await send(413, {"error": f"{x.shape[0]} rows in one "
                                      f"request exceeds the queue "
                                      f"bound ({core.max_queue}); "
                                      "split the batch (or use `dpsvm "
                                      "test --batch` for offline "
                                      "eval)"})
            return
        bad = [w for w in want if w not in KNOWN_OUTPUTS]
        if bad:
            core.count("errors", tenant=tenant)
            await send(400, {"error": f"unknown outputs {bad}; pick "
                                      f"from {list(KNOWN_OUTPUTS)}"})
            return
        try:
            budget = core.budget_for(
                body.get("timeout_ms", headers.get("x-deadline-ms")),
                tenant=tenant)
        except ValueError as e:
            core.count("errors", tenant=tenant)
            await send(400, {"error": str(e)})
            return
        if cold:
            # model-cache cold path: synchronous by design, but not on
            # the loop — a cold hydration is exactly the stall that
            # would freeze every other connection
            try:
                ride = tuple(dict.fromkeys(want + ("decision",)))
                res = await asyncio.to_thread(core.model_cache.infer,
                                              name, x, want=ride)
            except KeyError as e:
                core.count("errors", tenant=tenant)
                await send(404, {"error": str(e)})
                return
            except ValueError as e:
                core.count("errors", tenant=tenant)
                await send(400, {"error": str(e)})
                return
            await self._finish_200(writer, send, t0, rs, budget,
                                   tenant, name, name, want, None, x,
                                   res, want_spans_back, keep)
            return
        eff_name, eff_want, degraded = core.degrade(name, want)
        if eff_name != name:
            try:
                engine = core.registry.engine(eff_name)
            except KeyError:
                eff_name, degraded = name, None
        if "proba" in eff_want and not engine.calibrated:
            core.count("errors", tenant=tenant)
            await send(400, {"error": f"model {eff_name!r} has no "
                                      "probability calibration"})
            return
        ride = tuple(dict.fromkeys(eff_want + ("decision",)))
        if rs is not None:
            # the new stage: DRR wait in the tenant lane (auto-closes
            # admission; batcher submit's queue_wait auto-closes this)
            rs.start("fair_queue", tenant=tenant)
        item = _Pending(x, ride, budget.deadline, rs, eff_name,
                        int(x.shape[0]),
                        asyncio.get_running_loop().create_future())
        try:
            self._fq.push(tenant, item, item.rows)
        except LaneFullError as e:
            core.count("rejected", tenant=tenant)
            await send(429, {"error": str(e)},
                       extra_headers=(("Retry-After", "1"),))
            return
        self._wake.set()
        try:
            try:
                ticket = await asyncio.wait_for(item.future,
                                                budget.remaining())
            except asyncio.TimeoutError:
                item.cancelled = True
                if item.ticket is not None:
                    item.ticket.cancelled = True
                raise DeadlineExceededError(
                    "prediction did not complete in time")
            if ticket.error is not None:
                raise ticket.error
            res = ticket.result
        except QueueFullError as e:
            core.count("rejected", tenant=tenant)
            await send(429, {"error": str(e)},
                       extra_headers=(("Retry-After", "1"),))
            return
        except BatcherClosedError:
            core.count("errors", tenant=tenant)
            await send(503, {"error": "draining"})
            return
        except (DeadlineExceededError, TimeoutError) as e:
            core.count("deadline_504", tenant=tenant)
            await send(504, {"error": str(e)},
                       extra_headers=(("Retry-After", "1"),))
            return
        except PoolUnavailableError as e:
            core.count("errors", tenant=tenant)
            await send(503, {"error": str(e)},
                       extra_headers=(("Retry-After", "1"),))
            return
        except ValueError as e:
            core.count("errors", tenant=tenant)
            await send(400, {"error": str(e)})
            return
        await self._finish_200(writer, send, t0, rs, budget, tenant,
                               name, eff_name, eff_want, degraded, x,
                               res, want_spans_back, keep)

    async def _finish_200(self, writer, send, t0, rs, budget, tenant,
                          name, eff_name, eff_want, degraded, x, res,
                          want_spans_back, keep) -> None:
        """The threaded ``_respond_predict`` tail, verbatim semantics:
        score-window feed, span close, latency + tenant accounting,
        counted response."""
        core = self.core
        if rs is not None:
            rs.start("respond")
        core.observe_scores(res.get("decision"))
        out = {k: _jsonable(v) for k, v in res.items()
               if k in eff_want}
        if degraded:
            out["degraded"] = degraded
        breakdown = core.finish_request_spans(
            rs, status=200, budget=budget, model=eff_name,
            rows=int(x.shape[0]))
        if breakdown is not None and want_spans_back:
            out["spans"] = breakdown
        ms = (time.perf_counter() - t0) * 1000.0
        core.observe_latency(ms)
        core.account_request(tenant, name, rows=int(x.shape[0]),
                             ms=ms, breakdown=breakdown)
        core.count("requests", tenant=tenant)
        out.update(model=name, n=int(x.shape[0]), ms=round(ms, 3))
        await self._respond(writer, 200, out, keep)

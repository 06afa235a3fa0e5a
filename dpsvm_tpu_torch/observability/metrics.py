"""Metric registry (the part of ``dpsvm_tpu/observability/metrics.py``
the port's data layer feeds).

``MetricsRegistry`` holds counters, gauges and fixed-bucket histograms,
each with optional label sets, thread-safe; ``default_registry()`` is the
process-wide instance; ``DataMetrics`` is the ``dpsvm_data_*`` instrument
family the streaming shard reader (``data/stream.py``) counts into: shards
read and quarantined, transient-I/O retries, rows delivered and ingest
seconds. Every update is host-side around a file read, so a metered
streaming run makes no device-to-host transfer the unmetered one does not.
``render_prometheus()`` and ``snapshot()`` expose the registry as text and
JSON. ``TenantLabelBudget`` is the bounded-cardinality resolver (second-
touch admission, LRU of activity) that the fleet's model cache
(``fleet/modelcache.py``) applies to model names. The exposition
validator, the training feed, the sidecar server and the file snapshots
(item 13) are not ported. Stdlib only.
"""

from __future__ import annotations

import math
import re
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

#: default latency buckets (milliseconds) for serving histograms —
#: fixed at registration like every Prometheus histogram, spanning
#: loopback/TPU-local latencies to deep-overload tails. The sub-
#: millisecond rungs exist because the old floor (1 ms) was coarser
#: than the thing being measured: a loopback stub answers in ~0.1 ms
#: and a TPU-local decision pass in ~0.5 ms, so every such request
#: piled into one bucket and the histogram could not distinguish a
#: 5x regression below 1 ms (pinned in tests/test_metrics.py).
DEFAULT_LATENCY_BUCKETS_MS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
                              25.0, 50.0, 100.0, 250.0, 500.0, 1000.0,
                              2500.0, 5000.0)


def escape_label_value(v: str) -> str:
    """Prometheus label-value escaping: backslash, double-quote and
    newline (the three characters the text format reserves)."""
    return (str(v).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def escape_help(v: str) -> str:
    """# HELP line escaping: backslash and newline only."""
    return str(v).replace("\\", r"\\").replace("\n", r"\n")


def _fmt_value(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    if float(v).is_integer() and abs(v) < 2 ** 53:
        return str(int(v))
    return repr(float(v))


class _Series:
    """One labeled time series of a metric family."""

    __slots__ = ("labels", "value", "buckets", "sum", "count")

    def __init__(self, labels: Tuple[str, ...],
                 n_buckets: int = 0):
        self.labels = labels
        self.value = 0.0
        # histogram state: per-bucket cumulative-at-render counts are
        # derived; stored counts are per-bucket increments
        self.buckets = [0] * n_buckets if n_buckets else None
        self.sum = 0.0
        self.count = 0


class _Child:
    """Handle to one labeled series: what producers hold and update.
    All mutation goes through the owning registry's lock."""

    __slots__ = ("_metric", "_series")

    def __init__(self, metric: "_Metric", series: _Series):
        self._metric = metric
        self._series = series

    @property
    def value(self) -> float:
        with self._metric._lock:
            return self._series.value

    def inc(self, amount: float = 1.0) -> None:
        if self._metric.kind == "counter" and amount < 0:
            raise ValueError(
                f"counter {self._metric.name} cannot decrease "
                f"(inc({amount}))")
        with self._metric._lock:
            self._series.value += amount

    def dec(self, amount: float = 1.0) -> None:
        if self._metric.kind != "gauge":
            raise ValueError(f"{self._metric.kind} {self._metric.name} "
                             "cannot dec()")
        with self._metric._lock:
            self._series.value -= amount

    def set(self, v: float) -> None:
        if self._metric.kind != "gauge":
            raise ValueError(f"{self._metric.kind} {self._metric.name} "
                             "cannot set()")
        with self._metric._lock:
            self._series.value = float(v)

    def observe(self, v: float) -> None:
        if self._metric.kind != "histogram":
            raise ValueError(f"{self._metric.kind} {self._metric.name} "
                             "cannot observe()")
        v = float(v)
        m = self._metric
        with m._lock:
            s = self._series
            s.sum += v
            s.count += 1
            for i, ub in enumerate(m.buckets):
                if v <= ub:
                    s.buckets[i] += 1
                    break
            else:
                s.buckets[-1] += 1      # the +Inf bucket

    def histogram_state(self) -> Tuple[List[int], float, int]:
        """(per-bucket increments, sum, count) — test/JSON view."""
        with self._metric._lock:
            return (list(self._series.buckets or ()),
                    self._series.sum, self._series.count)


class _Metric:
    """One metric family: a name, a kind, a help line, a label scheme
    and the labeled series producers have created."""

    def __init__(self, name: str, help_: str, kind: str,
                 label_names: Sequence[str], lock: threading.RLock,
                 buckets: Optional[Sequence[float]] = None):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in label_names:
            if not _LABEL_RE.match(ln) or ln.startswith("__"):
                raise ValueError(f"invalid label name {ln!r} "
                                 f"(metric {name})")
        self.name = name
        self.help = str(help_)
        self.kind = kind
        self.label_names = tuple(label_names)
        self._lock = lock
        self._series: Dict[Tuple[str, ...], _Series] = {}
        if kind == "histogram":
            bs = [float(b) for b in (buckets or ())]
            if not bs:
                raise ValueError(f"histogram {name} needs buckets")
            if bs != sorted(bs) or len(set(bs)) != len(bs):
                raise ValueError(f"histogram {name} buckets must be "
                                 f"strictly increasing, got {bs}")
            if not math.isinf(bs[-1]):
                bs.append(float("inf"))
            self.buckets: Tuple[float, ...] = tuple(bs)
        else:
            self.buckets = ()

    def _key(self, values, kv) -> Tuple[str, ...]:
        if values and kv:
            raise ValueError("pass label values positionally OR by "
                             "keyword, not both")
        if kv:
            missing = [k for k in self.label_names if k not in kv]
            extra = [k for k in kv if k not in self.label_names]
            if missing or extra:
                raise ValueError(
                    f"metric {self.name}: labels {self.label_names} "
                    f"(missing {missing}, unexpected {extra})")
            values = tuple(kv[k] for k in self.label_names)
        if len(values) != len(self.label_names):
            raise ValueError(
                f"metric {self.name} takes {len(self.label_names)} "
                f"label value(s) {self.label_names}, got {len(values)}")
        return tuple(str(v) for v in values)

    def labels(self, *values, **kv) -> _Child:
        """The series handle for one label-value combination (created
        on first use). Positional values follow the registration
        order; keyword values may come in any order."""
        key = self._key(values, kv)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = _Series(key, n_buckets=len(self.buckets))
                self._series[key] = s
            return _Child(self, s)

    def remove(self, *values, **kv) -> bool:
        """Drop one labeled series (True when it existed). The escape
        hatch bounded-cardinality surfaces need: a TenantLabelBudget
        eviction removes the evicted tenant's series so the exposition
        can never grow past the label budget. Stale _Child handles to
        a removed series keep working but update an orphan — callers
        must re-resolve through ``labels()`` after an eviction."""
        key = self._key(values, kv)
        with self._lock:
            return self._series.pop(key, None) is not None

    # unlabeled convenience: counter.inc() etc. act on the () series
    def _default(self) -> _Child:
        return self.labels()

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    def set(self, v: float) -> None:
        self._default().set(v)

    def observe(self, v: float) -> None:
        self._default().observe(v)

    @property
    def value(self) -> float:
        return self._default().value

    def series(self) -> List[Tuple[Tuple[str, ...], _Series]]:
        with self._lock:
            return sorted(self._series.items())

    def _label_str(self, key: Tuple[str, ...],
                   extra: Tuple[Tuple[str, str], ...] = ()) -> str:
        pairs = [(n, v) for n, v in zip(self.label_names, key)]
        pairs += list(extra)
        if not pairs:
            return ""
        return ("{" + ",".join(
            f'{n}="{escape_label_value(v)}"' for n, v in pairs) + "}")

    def render(self) -> List[str]:
        out = [f"# HELP {self.name} {escape_help(self.help)}",
               f"# TYPE {self.name} {self.kind}"]
        with self._lock:
            items = sorted(self._series.items())
            if self.kind == "histogram":
                for key, s in items:
                    cum = 0
                    for ub, c in zip(self.buckets, s.buckets):
                        cum += c
                        le = "+Inf" if math.isinf(ub) else _fmt_value(ub)
                        out.append(
                            f"{self.name}_bucket"
                            f"{self._label_str(key, (('le', le),))} "
                            f"{cum}")
                    out.append(f"{self.name}_sum{self._label_str(key)} "
                               f"{_fmt_value(s.sum)}")
                    out.append(f"{self.name}_count{self._label_str(key)} "
                               f"{s.count}")
            else:
                for key, s in items:
                    out.append(f"{self.name}{self._label_str(key)} "
                               f"{_fmt_value(s.value)}")
        return out

    def snapshot(self) -> dict:
        with self._lock:
            if self.kind == "histogram":
                series = [
                    {"labels": dict(zip(self.label_names, key)),
                     "buckets": {("+Inf" if math.isinf(ub)
                                  else _fmt_value(ub)): c
                                 for ub, c in zip(self.buckets,
                                                  s.buckets)},
                     "sum": s.sum, "count": s.count}
                    for key, s in sorted(self._series.items())]
            else:
                series = [
                    {"labels": dict(zip(self.label_names, key)),
                     "value": s.value}
                    for key, s in sorted(self._series.items())]
        return {"kind": self.kind, "help": self.help, "series": series}


class MetricsRegistry:
    """Thread-safe named collection of metric families.

    ``counter``/``gauge``/``histogram`` are get-or-create: registering
    the same name twice returns the existing family (so sequential
    training runs in one process share their instruments), but a kind
    / label-scheme / bucket mismatch raises — two producers silently
    disagreeing about a metric is exactly the drift this registry
    exists to prevent.
    """

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: Dict[str, _Metric] = {}
        self._collectors: List[Callable[[], None]] = []

    def _get_or_create(self, name: str, help_: str, kind: str,
                       labels: Sequence[str],
                       buckets: Optional[Sequence[float]] = None
                       ) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if m.kind != kind or m.label_names != tuple(labels):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{m.kind}{m.label_names}, requested "
                        f"{kind}{tuple(labels)}")
                if kind == "histogram" and buckets is not None:
                    want = [float(b) for b in buckets]
                    if not math.isinf(want[-1] if want else 0.0):
                        want.append(float("inf"))
                    if tuple(want) != m.buckets:
                        raise ValueError(
                            f"histogram {name!r} already registered "
                            f"with buckets {m.buckets}")
                return m
            m = _Metric(name, help_, kind, labels, self._lock,
                        buckets=buckets)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help_: str = "",
                labels: Sequence[str] = ()) -> _Metric:
        return self._get_or_create(name, help_, "counter", labels)

    def gauge(self, name: str, help_: str = "",
              labels: Sequence[str] = ()) -> _Metric:
        return self._get_or_create(name, help_, "gauge", labels)

    def histogram(self, name: str, help_: str = "",
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS_MS
                  ) -> _Metric:
        return self._get_or_create(name, help_, "histogram", labels,
                                   buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def add_collector(self, fn: Callable[[], None]) -> None:
        """Register a pre-scrape hook: called (in order) before every
        render/snapshot so gauges derived from live state (queue
        depths, replica health) are fresh at scrape time. Collector
        exceptions are swallowed — observability must never take the
        producer down."""
        with self._lock:
            self._collectors.append(fn)

    def _collect(self) -> None:
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:
            try:
                fn()
            except Exception:
                pass

    def render_prometheus(self) -> str:
        """The text exposition a Prometheus/OpenMetrics scraper reads
        (content type ``text/plain; version=0.0.4``)."""
        self._collect()
        with self._lock:
            metrics = [self._metrics[k] for k in sorted(self._metrics)]
        lines: List[str] = []
        for m in metrics:
            lines.extend(m.render())
        return "\n".join(lines) + ("\n" if lines else "")

    def snapshot(self) -> dict:
        """JSON twin of the exposition, for ad-hoc consumers."""
        self._collect()
        with self._lock:
            metrics = dict(self._metrics)
        return {name: metrics[name].snapshot()
                for name in sorted(metrics)}


_DEFAULT: Optional[MetricsRegistry] = None
_DEFAULT_LOCK = threading.Lock()


def default_registry() -> MetricsRegistry:
    """The process-wide registry both halves feed: the training driver
    always updates it; ``dpsvm serve`` hands it to the ServingServer.
    (Library/test ServingServer instances default to a private registry
    so per-instance counter assertions stay exact.)"""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = MetricsRegistry()
        return _DEFAULT


class DataMetrics:
    """The ``dpsvm_data_*`` instrument family the streaming data layer
    feeds (docs/DATA.md): shards read/quarantined, transient-I/O
    retries, rows delivered, and wall seconds spent in ingest. Every
    update happens on the host around a file read — a metered
    streaming run performs ZERO additional device->host transfers
    (its packed-stats poll count is pinned equal to an in-memory run's)."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        reg = registry if registry is not None else default_registry()
        self.registry = reg
        self._c_read = reg.counter("dpsvm_data_shards_read_total",
                                   "shard reads that passed CRC + "
                                   "finiteness checks")
        self._c_rows = reg.counter("dpsvm_data_rows_read_total",
                                   "dataset rows delivered by shard "
                                   "reads")
        self._c_quar = reg.counter("dpsvm_data_shards_quarantined_total",
                                   "shards quarantined by the "
                                   "on_bad_shard=quarantine policy")
        self._c_retry = reg.counter("dpsvm_data_io_retries_total",
                                    "transient shard-read failures "
                                    "recovered by retry-with-backoff")
        self._c_secs = reg.counter("dpsvm_data_ingest_seconds_total",
                                   "wall seconds spent reading + "
                                   "verifying shards")

    def on_read(self, rows: int = 0) -> None:
        self._c_read.inc()
        if rows:
            self._c_rows.inc(int(rows))

    def on_quarantine(self) -> None:
        self._c_quar.inc()

    def on_retry(self) -> None:
        self._c_retry.inc()

    def on_ingest_seconds(self, seconds: float) -> None:
        if seconds > 0:
            self._c_secs.inc(float(seconds))


# ---------------------------------------------------------------------
# bounded-cardinality tenant labels
# ---------------------------------------------------------------------

#: the overflow bucket every out-of-budget tenant lands in: a fixed label
#: value, so total series stay <= budget + 1 a family.
TENANT_OTHER = "other"

#: default top-K active tenants that get their own label value
DEFAULT_TENANT_BUDGET = 32


class TenantLabelBudget:
    """Bounded-cardinality tenant -> label-value resolver.

    Prometheus dies by label cardinality: a fleet with an unbounded
    tenant label is one curious client away from a series explosion.
    This resolver admits at most ``budget`` resident tenants; everyone
    else resolves to the ``other`` overflow bucket, so per-family
    series are <= budget + 1 forever (pinned by the 10k-churn test).

    Residency is LRU-of-activity with a deterministic twist: activity
    is a monotone integer tick (no wall clock — replays and tests see
    identical evictions), and a non-resident needs a SECOND touch
    while the budget is full to evict the least-recently-active
    resident. One-shot names — the churny tail — never displace a
    working set, they aggregate into ``other``; a genuinely active
    newcomer gets in on its second request. ``on_evict(tenant)`` fires
    (outside any hot path, same thread) so the owner can drop the
    evicted tenant's series (``_Metric.remove``).

    Thread-safe; stdlib only."""

    OTHER = TENANT_OTHER

    def __init__(self, budget: int = DEFAULT_TENANT_BUDGET,
                 on_evict: Optional[Callable[[str], None]] = None):
        if int(budget) < 1:
            raise ValueError(f"tenant budget must be >= 1, got {budget}")
        self.budget = int(budget)
        self._on_evict = on_evict
        self._lock = threading.Lock()
        self._tick = 0
        self._resident: Dict[str, int] = {}     # tenant -> last tick
        self._waiting: Dict[str, int] = {}      # non-resident touches
        self._evictions = 0
        self._overflow = 0

    def resolve(self, tenant: str) -> str:
        """The label value to use for ``tenant`` right now: the name
        itself while resident (or admitted by this touch), else
        ``other``. Every call counts as activity."""
        tenant = str(tenant)
        if tenant == TENANT_OTHER:
            return TENANT_OTHER
        evicted = None
        with self._lock:
            self._tick += 1
            if tenant in self._resident:
                self._resident[tenant] = self._tick
                return tenant
            if len(self._resident) < self.budget:
                self._resident[tenant] = self._tick
                self._waiting.pop(tenant, None)
                return tenant
            touches = self._waiting.get(tenant, 0) + 1
            if touches >= 2:
                lru = min(self._resident, key=self._resident.get)
                del self._resident[lru]
                self._evictions += 1
                evicted = lru
                self._resident[tenant] = self._tick
                self._waiting.pop(tenant, None)
            else:
                self._waiting[tenant] = touches
                # the waiting map is itself bounded: one-shot churn
                # must not hoard host memory either
                while len(self._waiting) > self.budget:
                    drop = next(iter(self._waiting))
                    del self._waiting[drop]
                self._overflow += 1
        if evicted is not None and self._on_evict is not None:
            try:
                self._on_evict(evicted)
            except Exception:
                pass
        if evicted is not None:
            return tenant
        return TENANT_OTHER

    def is_resident(self, tenant: str) -> bool:
        with self._lock:
            return tenant in self._resident

    def residents(self) -> List[str]:
        """Resident tenants, most recently active first."""
        with self._lock:
            return sorted(self._resident,
                          key=self._resident.get, reverse=True)

    def stats(self) -> dict:
        with self._lock:
            return {"budget": self.budget,
                    "live": len(self._resident),
                    "evictions": self._evictions,
                    "overflow": self._overflow}

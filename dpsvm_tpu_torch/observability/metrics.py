"""Metric registry (the part of ``dpsvm_tpu/observability/metrics.py``
the port's data and serving layers feed).

``MetricsRegistry`` holds counters, gauges and fixed-bucket histograms,
each with optional label sets, thread-safe; ``default_registry()`` is the
process-wide instance; ``DataMetrics`` is the ``dpsvm_data_*`` instrument
family the streaming shard reader (``data/stream.py``) counts into: shards
read and quarantined, transient-I/O retries, rows delivered and ingest
seconds. Every update is host-side around a file read, so a metered
streaming run makes no device-to-host transfer the unmetered one does not.
``render_prometheus()`` and ``snapshot()`` expose the registry as text and
JSON, and ``validate_exposition`` checks the text against the exposition
grammar. ``TenantLabelBudget`` is the bounded-cardinality resolver
(second-touch admission, LRU of activity) that the fleet's model cache
(``fleet/modelcache.py``) applies to model names and the serving stack
to tenants (``sanitize_tenant`` cleans a name at admission);
``incidents_counter`` is the watchtower's ``dpsvm_incidents_total``.
``TrainingMetrics`` is the ``dpsvm_train_*`` family the training driver
feeds at each poll from the values it already holds (the packed-stats
read, the phase buckets, the allocator snapshot, the drained capture and
build records); ``MetricsServer`` is the read-only sidecar
(``--metrics-port``) and ``write_snapshot`` the per-poll file
(``--metrics-out``). Stdlib only.
"""

from __future__ import annotations

import json
import math
import os
import re
import threading
import time
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
# exposition grammar validation (the test/selfcheck side of the format)
# ---------------------------------------------------------------------

_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?P<labels>\{[^{}]*\})?"
    r" (?P<value>[^ ]+)(?: (?P<ts>-?[0-9]+))?$")
_LABEL_PAIR_RE = re.compile(
    r'^(?P<name>[a-zA-Z_][a-zA-Z0-9_]*)="(?P<value>(?:[^"\\]|\\["\\n])*)"$')
_VALID_TYPES = ("counter", "gauge", "histogram", "summary", "untyped")


def _split_labels(raw: str) -> Optional[List[Tuple[str, str]]]:
    """Parse `{a="x",b="y"}` honoring escapes; None on bad syntax."""
    body = raw[1:-1]
    if not body:
        return []
    pairs: List[Tuple[str, str]] = []
    # split on commas not inside quotes
    parts: List[str] = []
    depth_quote = False
    cur = ""
    i = 0
    while i < len(body):
        ch = body[i]
        if ch == "\\" and depth_quote and i + 1 < len(body):
            cur += body[i:i + 2]
            i += 2
            continue
        if ch == '"':
            depth_quote = not depth_quote
        if ch == "," and not depth_quote:
            parts.append(cur)
            cur = ""
        else:
            cur += ch
        i += 1
    if depth_quote:
        return None
    if cur:
        parts.append(cur)
    for part in parts:
        m = _LABEL_PAIR_RE.match(part.strip())
        if m is None:
            return None
        pairs.append((m.group("name"), m.group("value")))
    return pairs


def _family_of(sample_name: str, typed: Dict[str, str]) -> str:
    """Map a sample name to its metric family (histogram samples use
    the _bucket/_sum/_count suffixes of the family name)."""
    for suffix in ("_bucket", "_sum", "_count"):
        if sample_name.endswith(suffix):
            base = sample_name[: -len(suffix)]
            if typed.get(base) in ("histogram", "summary"):
                return base
    return sample_name


def validate_exposition(text: str) -> List[str]:
    """Line-by-line grammar check of a Prometheus text exposition.
    Returns problems (empty = valid). Checked: HELP/TYPE line shape
    and ordering (TYPE before samples, at most one each per family,
    families contiguous), sample-line grammar incl. label escaping,
    duplicate series, and the histogram invariants — cumulative
    non-decreasing ``_bucket`` counts, a ``+Inf`` bucket equal to
    ``_count``, and a ``_sum`` sample per series."""
    problems: List[str] = []
    typed: Dict[str, str] = {}
    helped: Dict[str, bool] = {}
    seen_samples: Dict[str, List[Tuple[str, Tuple[Tuple[str, str], ...],
                                       float]]] = {}
    family_done: List[str] = []     # families whose block has closed
    current: Optional[str] = None
    seen_series = set()

    def close(fam: Optional[str]) -> None:
        if fam is not None and fam not in family_done:
            family_done.append(fam)

    for ln, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) < 3 or parts[1] not in ("HELP", "TYPE"):
                if line.startswith("# "):   # plain comment: allowed
                    continue
                problems.append(f"line {ln}: malformed comment {line!r}")
                continue
            kind, name = parts[1], parts[2]
            if not _NAME_RE.match(name):
                problems.append(f"line {ln}: bad metric name {name!r}")
                continue
            if name != current:
                close(current)
                if name in family_done:
                    problems.append(
                        f"line {ln}: family {name!r} reopened (families "
                        "must be contiguous)")
                current = name
            if kind == "HELP":
                if helped.get(name):
                    problems.append(f"line {ln}: second HELP for {name}")
                helped[name] = True
            else:
                if len(parts) != 4 or parts[3] not in _VALID_TYPES:
                    problems.append(
                        f"line {ln}: TYPE must be one of "
                        f"{_VALID_TYPES}, got {line!r}")
                    continue
                if name in typed:
                    problems.append(f"line {ln}: second TYPE for {name}")
                if name in seen_samples:
                    problems.append(
                        f"line {ln}: TYPE for {name} after its samples")
                typed[name] = parts[3]
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            problems.append(f"line {ln}: not a valid sample: {line!r}")
            continue
        name = m.group("name")
        labels_raw = m.group("labels")
        labels = _split_labels(labels_raw) if labels_raw else []
        if labels is None:
            problems.append(f"line {ln}: bad label syntax: "
                            f"{labels_raw!r}")
            continue
        try:
            value = float(m.group("value").replace("+Inf", "inf")
                          .replace("-Inf", "-inf").replace("NaN", "nan"))
        except ValueError:
            problems.append(f"line {ln}: bad sample value "
                            f"{m.group('value')!r}")
            continue
        fam = _family_of(name, typed)
        if fam != current:
            close(current)
            if fam in family_done:
                problems.append(
                    f"line {ln}: family {fam!r} reopened (families "
                    "must be contiguous)")
            current = fam
        series_key = (name, tuple(sorted(labels)))
        if series_key in seen_series:
            problems.append(f"line {ln}: duplicate series "
                            f"{name}{dict(labels)}")
        seen_series.add(series_key)
        seen_samples.setdefault(fam, []).append(
            (name, tuple(labels), value))
        kind = typed.get(fam)
        if kind == "counter" and not math.isnan(value) and value < 0:
            problems.append(f"line {ln}: counter {name} < 0")

    # histogram invariants, per family and per label set (minus `le`)
    for fam, kind in typed.items():
        if kind != "histogram":
            continue
        samples = seen_samples.get(fam, [])
        if not samples:
            problems.append(f"histogram {fam}: TYPE with no samples")
            continue
        by_series: Dict[Tuple[Tuple[str, str], ...], dict] = {}
        for name, labels, value in samples:
            base = tuple(p for p in labels if p[0] != "le")
            st = by_series.setdefault(
                base, {"buckets": [], "sum": None, "count": None})
            if name == fam + "_bucket":
                le = dict(labels).get("le")
                if le is None:
                    problems.append(
                        f"histogram {fam}: _bucket sample without le")
                    continue
                st["buckets"].append((le, value))
            elif name == fam + "_sum":
                st["sum"] = value
            elif name == fam + "_count":
                st["count"] = value
            else:
                problems.append(f"histogram {fam}: stray sample {name}")
        for base, st in by_series.items():
            lbl = dict(base)
            if st["sum"] is None:
                problems.append(f"histogram {fam}{lbl}: missing _sum")
            if st["count"] is None:
                problems.append(f"histogram {fam}{lbl}: missing _count")
            buckets = st["buckets"]
            if not buckets:
                problems.append(f"histogram {fam}{lbl}: no _bucket "
                                "samples")
                continue
            if buckets[-1][0] != "+Inf":
                problems.append(f"histogram {fam}{lbl}: last bucket "
                                f"must be le=\"+Inf\", got "
                                f"{buckets[-1][0]!r}")
            prev = -1.0
            for le, v in buckets:
                if v < prev:
                    problems.append(
                        f"histogram {fam}{lbl}: bucket counts not "
                        f"cumulative at le={le}")
                prev = v
            if (st["count"] is not None and buckets[-1][0] == "+Inf"
                    and buckets[-1][1] != st["count"]):
                problems.append(
                    f"histogram {fam}{lbl}: +Inf bucket "
                    f"{buckets[-1][1]} != _count {st['count']}")
    return problems


def incidents_counter(registry: Optional[MetricsRegistry] = None):
    """The process-wide ``dpsvm_incidents_total`` counter (one per
    registry; get-or-create): every alert-rule firing that produced an
    incident — serving watchtower or training driver alike — counts
    here, so one scrape answers "has this process paged"
    (docs/OBSERVABILITY.md "Watch & alerts")."""
    reg = registry if registry is not None else default_registry()
    return reg.counter(
        "dpsvm_incidents_total",
        "alert-rule firings that opened an incident").labels()


# ---------------------------------------------------------------------
# bounded-cardinality tenant labels
# ---------------------------------------------------------------------

#: the overflow bucket every out-of-budget tenant lands in: a fixed label
#: value, so total series stay <= budget + 1 a family.
TENANT_OTHER = "other"

#: default top-K active tenants that get their own label value
#: (``serve --tenant-budget`` overrides).
DEFAULT_TENANT_BUDGET = 32

#: longest tenant name accepted at admission; longer ones are clamped
#: (a label value is an identity, not a payload channel).
MAX_TENANT_LEN = 64


def sanitize_tenant(name) -> Optional[str]:
    """Admission-side tenant-name hygiene: strip, replace control
    characters (newline included) with ``_``, clamp to MAX_TENANT_LEN.
    Returns None for an unusable name (empty / whitespace / not a
    string-able scalar) so the caller falls back to its default.

    Printable hostile characters (``"`` and ``\\``) are deliberately
    KEPT: the exposition escapes them (``escape_label_value``) and the
    grammar validator accepts the escaped form, so a tenant named
    ``acme"prod`` stays identifiable instead of being silently
    renamed."""
    if name is None or isinstance(name, (dict, list, tuple)):
        return None
    s = str(name)
    s = "".join(ch if ch.isprintable() else "_" for ch in s)
    s = s.strip()[:MAX_TENANT_LEN].strip()
    return s or None


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


# ---------------------------------------------------------------------
# the training half: packed-stats polls -> registry
# ---------------------------------------------------------------------

class TrainingMetrics:
    """Feeds training instruments from the values the driver already
    holds at each poll boundary — the packed-stats read, the PhaseTimer
    buckets, the host-side HBM snapshot and the drained compilewatch
    observations (captures and builds). Every update is host-side dict
    arithmetic: a scraped (or snapshotted) training run performs no
    device-to-host transfer the bare run does not, pinned by
    tests/test_torch_trace.py."""

    def __init__(self, registry: Optional[MetricsRegistry] = None, *,
                 solver: str = "", n: int = 0, d: int = 0):
        reg = registry if registry is not None else default_registry()
        self.registry = reg
        self._g_info = reg.gauge(
            "dpsvm_train_run_info",
            "1 while a run is live; labels carry the run identity",
            labels=("solver",))
        self._g_iter = reg.gauge("dpsvm_train_iterations",
                                 "solver iteration count at the last "
                                 "poll")
        self._g_gap = reg.gauge("dpsvm_train_gap",
                                "duality gap (b_lo - b_hi) at the last "
                                "poll")
        self._g_nsv = reg.gauge("dpsvm_train_n_sv",
                                "support-vector count at the last poll")
        self._g_ips = reg.gauge("dpsvm_train_iters_per_sec",
                                "iteration throughput between the last "
                                "two polls")
        self._c_polls = reg.counter("dpsvm_train_polls_total",
                                    "host packed-stats polls")
        self._g_hits = reg.gauge("dpsvm_train_cache_hits",
                                 "kernel-row cache hits (device "
                                 "cumulative)")
        self._g_misses = reg.gauge("dpsvm_train_cache_misses",
                                   "kernel-row cache misses (device "
                                   "cumulative)")
        self._g_hbm = reg.gauge("dpsvm_train_hbm_peak_bytes",
                                "allocator high-water mark (absent "
                                "stats report 0)")
        self._c_compiles = reg.counter("dpsvm_train_compiles_total",
                                       "CUDA-graph captures and kernel "
                                       "builds of chunk programs")
        self._c_compile_s = reg.counter(
            "dpsvm_train_compile_seconds_total",
            "wall seconds spent in captures and builds")
        self._g_phase = reg.gauge("dpsvm_train_phase_seconds",
                                  "cumulative host-loop phase seconds",
                                  labels=("phase",))
        self._g_phase_calls = reg.gauge("dpsvm_train_phase_calls",
                                        "cumulative host-loop phase "
                                        "call counts",
                                        labels=("phase",))
        self._g_heartbeat = reg.gauge(
            "dpsvm_train_shard_heartbeat_age_seconds",
            "seconds since a shard's reported progress advanced",
            labels=("shard",))
        self._g_converged = reg.gauge("dpsvm_train_converged",
                                      "1 once the run converged")
        self._info = self._g_info.labels(solver=solver or "unknown")
        self._info.set(1)
        self._g_converged.set(0)
        self._prev: Optional[Tuple[int, float]] = None   # (n_iter, t)

    def on_poll(self, *, n_iter: int, b_lo: float, b_hi: float,
                n_sv: int = 0, cache_hits: int = 0,
                cache_misses: int = 0,
                phases: Optional[Dict[str, float]] = None,
                phase_counts: Optional[Dict[str, int]] = None,
                hbm: Optional[dict] = None,
                shard_ages: Optional[Sequence[float]] = None) -> None:
        now = time.perf_counter()
        self._c_polls.inc()
        self._g_iter.set(n_iter)
        gap = b_lo - b_hi
        self._g_gap.set(gap if math.isfinite(gap) else float("nan"))
        self._g_nsv.set(n_sv)
        self._g_hits.set(cache_hits)
        self._g_misses.set(cache_misses)
        if self._prev is not None and now > self._prev[1]:
            self._g_ips.set((n_iter - self._prev[0])
                            / (now - self._prev[1]))
        self._prev = (int(n_iter), now)
        peak = (hbm or {}).get("peak")
        if peak is not None:
            self._g_hbm.set(int(peak))
        for name, sec in (phases or {}).items():
            self._g_phase.labels(phase=name).set(float(sec))
        for name, cnt in (phase_counts or {}).items():
            self._g_phase_calls.labels(phase=name).set(int(cnt))
        for i, age in enumerate(shard_ages or ()):
            self._g_heartbeat.labels(shard=str(i)).set(float(age))

    def on_compile(self, rec: dict) -> None:
        self._c_compiles.inc()
        self._c_compile_s.inc(float(rec.get("seconds", 0.0)))

    def compile_totals(self) -> Tuple[float, float]:
        """(compiles, compile-seconds) — cumulative process counters,
        read by the driver's watch hook to feed the compile-storm rule
        (observability/slo.py) without a second accounting path."""
        return (float(self._c_compiles.value),
                float(self._c_compile_s.value))

    def on_done(self, *, converged: bool, n_iter: int) -> None:
        self._g_converged.set(1 if converged else 0)
        self._g_iter.set(n_iter)
        self._info.set(0)


# ---------------------------------------------------------------------
# exporters: sidecar HTTP server + scrape-less file snapshots
# ---------------------------------------------------------------------

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def wants_prometheus(path: str) -> bool:
    """True when a /metricsz request asks for the text exposition
    (`?format=prometheus`): the threaded server and the async front
    door speak the same dialect."""
    from urllib.parse import parse_qs, urlsplit
    q = parse_qs(urlsplit(path).query)
    return q.get("format", [""])[0] == "prometheus"


class MetricsServer:
    """Read-only metrics sidecar for a training run: GET ``/metricsz``
    answers the JSON snapshot, ``/metricsz?format=prometheus`` the text
    exposition — the same handler semantics as the serving server's
    endpoint. One daemon thread; ``close()`` tears it down at run end
    (the driver's finally block)."""

    def __init__(self, registry: MetricsRegistry,
                 host: str = "127.0.0.1", port: int = 0):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        reg = registry

        class _Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            server_version = "dpsvm-metrics"

            def log_message(self, fmt, *args):      # quiet sidecar
                pass

            def do_GET(self):                       # noqa: N802
                if not self.path.startswith("/metricsz"):
                    body = b'{"error": "only /metricsz here"}'
                    self.send_response(404)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if wants_prometheus(self.path):
                    body = reg.render_prometheus().encode()
                    ctype = PROMETHEUS_CONTENT_TYPE
                else:
                    body = json.dumps(reg.snapshot()).encode()
                    ctype = "application/json"
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                try:
                    self.wfile.write(body)
                except (BrokenPipeError, ConnectionResetError):
                    pass

        self._httpd = ThreadingHTTPServer((host, int(port)), _Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="dpsvm-metrics-http",
            kwargs={"poll_interval": 0.1}, daemon=True)
        self._thread.start()

    @property
    def port(self) -> int:
        return int(self._httpd.server_address[1])

    def close(self) -> None:
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._thread.join(1.0)
        except Exception:
            pass


#: per-path monotonic snapshot sequence numbers (process-local): the
#: header line every ``write_snapshot`` emits so a tailing consumer
#: (``dpsvm watch``, observability/slo.SnapshotFollower) can tell a
#: missed snapshot from a duplicate re-read instead of silently
#: mis-windowing its rates. Reset only with the process.
_SNAPSHOT_SEQS: Dict[str, int] = {}
_SNAPSHOT_LOCK = threading.Lock()


def snapshot_header(seq: int, now: Optional[float] = None) -> str:
    """The one header line (a plain comment to every Prometheus
    parser; slo.parse_snapshot_header reads it back):
    ``# dpsvm-snapshot seq=N unix=T time=ISO``."""
    now = time.time() if now is None else float(now)
    iso = time.strftime("%Y-%m-%dT%H:%M:%S%z", time.localtime(now))
    return f"# dpsvm-snapshot seq={int(seq)} unix={now:.3f} time={iso}"


def write_snapshot(registry: MetricsRegistry, path: str,
                   seq: Optional[int] = None,
                   now: Optional[float] = None) -> int:
    """Atomic text-exposition snapshot (tmp + rename): the scrape-less
    CI story — ``train --metrics-out FILE`` refreshes it every poll, so
    a harness reads a complete, parseable exposition at any moment.
    The first line is the monotonic ``seq`` + wall-timestamp header
    (``snapshot_header``); returns the seq written. Best-effort: a
    full disk must not kill the training run."""
    if seq is None:
        with _SNAPSHOT_LOCK:
            seq = _SNAPSHOT_SEQS.get(path, 0) + 1
            _SNAPSHOT_SEQS[path] = seq
    try:
        tmp = f"{path}.tmp{os.getpid()}"
        with open(tmp, "w") as fh:
            fh.write(snapshot_header(seq, now) + "\n")
            fh.write(registry.render_prometheus())
        os.replace(tmp, path)
    except OSError:
        pass
    return int(seq)

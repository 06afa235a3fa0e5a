"""Out-of-core datasets: integrity-manifested shard directories (port of
``dpsvm_tpu/data/stream.py``, numpy only).

* **Shard format**, shared with the JAX package: a dataset is a directory
  of fixed-shape ``.npz`` shards (``shard-00000.npz`` holding ``x`` (rows,
  d) float32 and ``y`` (rows,) int32/float32) plus one ``manifest.json``
  carrying per-shard payload CRC32s, row counts, dtype/width and running
  scaling stats. A directory either package writes loads in the other,
  and for the same source both write the same manifest, byte for byte.
* **Resumable conversion**: ``convert_to_shards`` (CLI ``convert shards``)
  streams a CSV or libsvm file row by row into shards, never
  materializing it, and checkpoints its cursor after every durable shard;
  a killed conversion resumes to a byte-identical manifest.
* **Quarantine-and-continue ingest**: every shard read verifies the
  manifest CRC and row finiteness. A bad shard raises
  (``on_bad_shard="raise"``) or is quarantined (``"quarantine"``):
  recorded on the handle, skipped by every later pass, queued as a
  ``quarantine`` event for the training driver's next poll, and bounded
  by ``max_bad_fraction``. Transient ``OSError`` reads retry with backoff
  (``DPSVM_IO_RETRIES`` / ``DPSVM_IO_RETRY_BACKOFF_S``). The
  ``DPSVM_FAULT_IO_*`` knobs (``resilience/faultinject.py``) inject each
  failure deterministically.
* **Memory-budget guards**: ``check_materialize_budget`` /
  ``check_stream_budget`` refuse up front, naming the shard-count math.

``loader.load_dataset`` reads a shard directory through ``materialize``;
training on data that never materializes is
``approx/primal.fit_approx_stream`` and
``solver/cascade.fit_cascade_stream``. Ingest metrics (``dpsvm_data_*``)
go to the process metric registry on the host. The live shard log
(``data/live.py``: appends, pinned generations, the watcher) is ROADMAP
item 10c; a live log's manifest is read here as a frozen view (its
self-CRC verified).
"""

from __future__ import annotations

import io
import json
import os
import sys
import time
import zlib
from typing import Callable, Iterator, List, Optional, Tuple

import numpy as np

from dpsvm_tpu_torch.resilience import faultinject

MANIFEST_NAME = "manifest.json"
CURSOR_NAME = "convert.cursor.json"
SHARD_FORMAT_VERSION = 1
DEFAULT_ROWS_PER_SHARD = 4096
#: abort threshold for quarantine-and-continue: once more than this
#: fraction of the dataset's rows sit in quarantined shards the ingest
#: aborts — a run that silently lost a quarter of its data is a worse
#: outcome than a loud failure.
MAX_BAD_FRACTION = 0.25
#: transient-read retry policy (env-overridable; the CI default keeps
#: drills fast while real deployments can afford longer backoff)
DEFAULT_IO_RETRIES = 3
DEFAULT_IO_BACKOFF_S = 0.05


class StreamError(Exception):
    """Base of every shard-dataset failure this module raises."""


class ShardCorruptError(StreamError):
    """A shard file exists but its payload cannot be trusted:
    unreadable/truncated .npz, wrong shapes, or a manifest CRC32
    mismatch. Names the shard and the reason."""

    def __init__(self, shard: int, reason: str):
        self.shard = int(shard)
        self.reason = str(reason)
        super().__init__(f"shard {shard}: {reason}")


class IngestAbortError(StreamError):
    """Quarantine-and-continue crossed the bounded bad fraction (or
    lost every shard): continuing would train on too little data."""


class MemBudgetError(StreamError):
    """An admission guard refused a load that would exceed the memory
    budget — raised BEFORE any allocation, with the shard math."""


class TornPublishError(StreamError):
    """manifest.json exists but cannot be trusted: unparseable JSON beside
    a ``.prev`` backup, or a failed self-CRC — a live-log writer crashed
    mid-publish (the live log itself is ROADMAP item 10c)."""


def _log(msg: str) -> None:
    print(f"INGEST: {msg}", file=sys.stderr, flush=True)


def _metrics():
    from dpsvm_tpu_torch.observability.metrics import DataMetrics
    return DataMetrics()


# ---------------------------------------------------------------------
# manifest / shard primitives
# ---------------------------------------------------------------------

def shard_filename(k: int) -> str:
    return f"shard-{k:05d}.npz"


def payload_crc(x: np.ndarray, y: np.ndarray) -> int:
    """CRC32 over the shard's array payloads (the checkpoint module's
    pattern): container-independent, so a re-written .npz with
    identical rows verifies identically."""
    crc = zlib.crc32(np.ascontiguousarray(x).tobytes())
    return zlib.crc32(np.ascontiguousarray(y).tobytes(), crc)


def is_shard_dir(path: str) -> bool:
    """True when ``path`` is a converted shard-dataset directory."""
    return (os.path.isdir(path)
            and os.path.exists(os.path.join(path, MANIFEST_NAME)))


def manifest_crc(manifest: dict) -> int:
    """CRC32 over the canonical serialization of a live-log manifest
    without its ``manifest_crc`` key (the JAX package's ``data/live.py``
    helper, which a frozen reader needs to trust such a manifest)."""
    body = {k: v for k, v in manifest.items() if k != "manifest_crc"}
    raw = json.dumps(body, sort_keys=True, separators=(",", ":")).encode()
    return zlib.crc32(raw)


def verify_manifest_crc(manifest: dict, where: str = "manifest") -> None:
    got = manifest_crc(manifest)
    want = int(manifest["manifest_crc"])
    if got != want:
        raise TornPublishError(
            f"{where}: manifest self-CRC mismatch (recorded {want}, "
            f"computed {got}) — a torn or bit-rotted publish; readers "
            "must hold their last admitted view")


def _write_json_atomic(path: str, obj: dict) -> None:
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w") as fh:
        # sort_keys + fixed separators: the manifest must be a pure
        # function of its content so a resumed conversion lands
        # byte-identical to an uninterrupted one.
        json.dump(obj, fh, sort_keys=True, indent=1)
        fh.write("\n")
    os.replace(tmp, path)


def _write_shard_atomic(path: str, x: np.ndarray, y: np.ndarray) -> None:
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as fh:
        np.savez(fh, x=x, y=y)
    os.replace(tmp, path)


class ShardedDataset:
    """Handle to one converted shard directory.

    Integrity state (the quarantine set) lives on the handle: a shard
    that failed its CRC once is skipped by every later pass in this
    process, and the bounded bad-fraction abort is evaluated against
    the manifest's total row count.
    """

    def __init__(self, directory: str, manifest: dict):
        self.directory = directory
        self.manifest = manifest
        self.n = int(manifest["n"])
        self.d = int(manifest["d"])
        self.rows_per_shard = int(manifest["rows_per_shard"])
        self.shards = list(manifest["shards"])
        self.float_labels = manifest.get("label_dtype") == "float32"
        self.quarantined: dict = {}          # shard idx -> reason
        self.max_bad_fraction = MAX_BAD_FRACTION
        self._rebuild_offsets()

    def _rebuild_offsets(self) -> None:
        # Cumulative row offsets: converted directories only ever have
        # a short final shard, but a live log may hold partial shards
        # mid-stream (each append publishes whatever rows it has), so
        # the global index of shard k's first row is the running sum.
        off = 0
        self._offsets: List[int] = []
        for s in self.shards:
            self._offsets.append(off)
            off += int(s["rows"])

    # -- opening -------------------------------------------------------

    @classmethod
    def open(cls, directory: str) -> "ShardedDataset":
        mpath = os.path.join(directory, MANIFEST_NAME)
        if not os.path.exists(mpath):
            raise FileNotFoundError(
                f"{directory}: not a shard dataset (no {MANIFEST_NAME}; "
                "convert one with `dpsvm convert shards SRC DIR`)")
        try:
            with open(mpath) as fh:
                manifest = json.load(fh)
        except (OSError, json.JSONDecodeError) as e:
            if os.path.exists(mpath + ".prev"):
                # The torn-publish signature of a LIVE log (a frozen
                # conversion has no .prev backup): a writer crashed
                # mid-publish; the restarted writer repairs it.
                raise TornPublishError(
                    f"{mpath}: unparseable manifest ({e}) beside a "
                    ".prev backup — a torn live-log publish; the "
                    "restarted writer repairs it on its next append"
                ) from e
            raise StreamError(f"{mpath}: unreadable manifest ({e}); "
                              "re-run the conversion") from e
        for key in ("format", "version", "n", "d", "rows_per_shard",
                    "shards"):
            if key not in manifest:
                raise StreamError(f"{mpath}: manifest missing {key!r}")
        if manifest["format"] != "dpsvm-shards":
            raise StreamError(f"{mpath}: format {manifest['format']!r} "
                              "is not 'dpsvm-shards'")
        if int(manifest["version"]) > SHARD_FORMAT_VERSION:
            raise StreamError(
                f"{mpath}: manifest version {manifest['version']} is "
                f"newer than this reader ({SHARD_FORMAT_VERSION})")
        rows = sum(int(s["rows"]) for s in manifest["shards"])
        if rows != int(manifest["n"]):
            raise StreamError(
                f"{mpath}: shard rows sum to {rows} but manifest says "
                f"n={manifest['n']} — truncated conversion? (a killed "
                "convert leaves a cursor, not a manifest)")
        if "manifest_crc" in manifest:
            # Live-log manifests carry a self-CRC: a torn publish on a
            # non-atomic filesystem must never be mistaken for a dataset.
            verify_manifest_crc(manifest, where=mpath)
        return cls(directory, manifest)

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    def shard_rows(self, k: int) -> int:
        return int(self.shards[k]["rows"])

    def shard_path(self, k: int) -> str:
        return os.path.join(self.directory, self.shards[k]["file"])

    def row_offset(self, k: int) -> int:
        """Global index of shard k's first row (shards are contiguous
        in append order; a live log may hold partial shards mid-
        stream, so this is the running sum, not k * rows_per_shard)."""
        return self._offsets[k]

    # -- reading -------------------------------------------------------

    def _read_shard_raw(self, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """One verified shard read: fault hooks -> npz load -> shape +
        dtype + CRC checks. Raises OSError on transient I/O trouble
        (retried by the caller) and ShardCorruptError on anything the
        manifest contract rejects."""
        meta = self.shards[k]
        path = self.shard_path(k)
        plan = faultinject.current()
        if plan is not None:
            plan.io_read_begin(k)          # slow-read + transient fail
        with open(path, "rb") as fh:
            raw = fh.read()
        if plan is not None and plan.io_truncate_now(k):
            raw = raw[: len(raw) // 2]
        try:
            with np.load(io.BytesIO(raw)) as npz:
                x = np.asarray(npz["x"])
                y = np.asarray(npz["y"])
        except Exception as e:
            raise ShardCorruptError(
                k, f"unreadable npz ({type(e).__name__}: {e}) — "
                   "truncated or damaged file") from e
        if plan is not None and plan.io_corrupt_now(k):
            x = x.copy()
            x.view(np.uint8)[0] ^= 1       # one flipped payload byte
        rows = int(meta["rows"])
        if x.shape != (rows, self.d) or y.shape != (rows,):
            raise ShardCorruptError(
                k, f"shape {x.shape}/{y.shape} does not match the "
                   f"manifest's ({rows}, {self.d})")
        if x.dtype != np.float32:
            raise ShardCorruptError(k, f"x dtype {x.dtype} != float32")
        got = payload_crc(x, y)
        if got != int(meta["crc32"]):
            raise ShardCorruptError(
                k, f"payload CRC mismatch (manifest {meta['crc32']}, "
                   f"file {got}) — bit rot or a torn write")
        return x, y

    def read_shard(self, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Read + verify shard k with bounded transient-I/O retry.
        Raises ShardCorruptError / OSError; policy handling (quarantine
        vs raise) is ``read_shard_checked``."""
        retries = int(os.environ.get("DPSVM_IO_RETRIES",
                                     str(DEFAULT_IO_RETRIES)))
        backoff = float(os.environ.get("DPSVM_IO_RETRY_BACKOFF_S",
                                       str(DEFAULT_IO_BACKOFF_S)))
        metrics = _metrics()
        t0 = time.perf_counter()
        try:
            for attempt in range(retries + 1):
                try:
                    x, y = self._read_shard_raw(k)
                    metrics.on_read(rows=len(y))
                    return x, y
                except OSError as e:
                    if attempt >= retries:
                        raise
                    metrics.on_retry()
                    wait = backoff * (2.0 ** attempt)
                    _log(f"transient read failure on shard {k} "
                         f"({e}); retry {attempt + 1}/{retries} in "
                         f"{wait:g}s")
                    time.sleep(wait)
        finally:
            metrics.on_ingest_seconds(time.perf_counter() - t0)
        raise AssertionError("unreachable")

    def _check_finite(self, k: int, x: np.ndarray,
                      allow_nonfinite: bool) -> None:
        # Reduction-based fast path (no (rows, d) mask allocation):
        # min/max are finite iff every element is — NaN propagates
        # through min, inf survives max.
        if np.isfinite(x.min()) and np.isfinite(x.max()):
            return
        bad = np.argwhere(~np.isfinite(x))[0]
        row, col = int(bad[0]), int(bad[1])
        msg = (f"non-finite value at shard row {row}, column {col} "
               f"(dataset row {self.row_offset(k) + row})")
        if allow_nonfinite:
            _log(f"WARNING: shard {k}: {msg}; loading anyway "
                 "(--allow-nonfinite)")
            return
        raise ShardCorruptError(k, msg + " — rejected; pass "
                                "--allow-nonfinite to load anyway")

    def read_shard_checked(
            self, k: int, *, on_bad_shard: str = "raise",
            allow_nonfinite: bool = False,
            on_quarantine: Optional[Callable[[int, str], None]] = None,
    ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Policy-wrapped shard read: the one entry point training and
        materialization loop over.

        Returns ``(x, y)``, or None when the shard is (or becomes)
        quarantined under ``on_bad_shard="quarantine"``. A fresh
        quarantine is recorded on the handle, reported through
        ``on_quarantine`` (default: a ``quarantine`` trace event via
        the driver's pending-event queue + the metric registry), and
        checked against ``max_bad_fraction`` — crossing it raises
        ``IngestAbortError`` rather than training on a sliver."""
        if on_bad_shard not in ("raise", "quarantine"):
            raise ValueError(f"on_bad_shard must be 'raise' or "
                             f"'quarantine', got {on_bad_shard!r}")
        if k in self.quarantined:
            return None
        try:
            x, y = self.read_shard(k)
            self._check_finite(k, x, allow_nonfinite)
            return x, y
        except (ShardCorruptError, OSError) as e:
            reason = (e.reason if isinstance(e, ShardCorruptError)
                      else f"I/O error after retries: {e}")
            if on_bad_shard == "raise":
                if isinstance(e, ShardCorruptError):
                    raise
                raise ShardCorruptError(k, reason) from e
            self._note_quarantine(k, reason, on_quarantine)
            return None

    def _note_quarantine(self, k: int, reason: str,
                         on_quarantine=None) -> None:
        self.quarantined[k] = reason
        _metrics().on_quarantine()
        _log(f"QUARANTINED shard {k} ({self.shards[k]['file']}): "
             f"{reason}")
        if on_quarantine is not None:
            on_quarantine(k, reason)
        else:
            # Default consumer: the training driver's pending-event
            # queue, drained into the run trace at the next poll
            # boundary (or right after the manifest when queued before
            # the run starts).
            from dpsvm_tpu_torch.solver.driver import queue_trace_event
            queue_trace_event("quarantine", shard=int(k),
                              reason=reason,
                              rows=self.shard_rows(k))
        bad_rows = sum(self.shard_rows(i) for i in self.quarantined)
        if bad_rows > self.max_bad_fraction * self.n:
            raise IngestAbortError(
                f"{len(self.quarantined)} quarantined shard(s) hold "
                f"{bad_rows}/{self.n} rows — past the "
                f"{self.max_bad_fraction:.0%} bad-fraction bound; "
                "refusing to continue on a sliver of the dataset "
                f"(quarantined: {sorted(self.quarantined)})")

    def iter_shards(self, *, on_bad_shard: str = "raise",
                    allow_nonfinite: bool = False
                    ) -> Iterator[Tuple[int, np.ndarray, np.ndarray]]:
        """One pass over every non-quarantined shard, policy applied."""
        for k in range(self.n_shards):
            got = self.read_shard_checked(
                k, on_bad_shard=on_bad_shard,
                allow_nonfinite=allow_nonfinite)
            if got is not None:
                yield k, got[0], got[1]

    def gather_rows(self, indices: np.ndarray) -> np.ndarray:
        """Rows at sorted global ``indices`` (the Nystrom landmark
        fetch): reads only the shards that hold them, strict policy —
        a landmark inside a corrupt shard is a hard error, because the
        feature map must be rebuildable bit-identically forever."""
        indices = np.asarray(indices, np.int64)
        out = np.empty((len(indices), self.d), np.float32)
        offsets = np.asarray(self._offsets, np.int64)
        by_shard: dict = {}
        for pos, gi in enumerate(indices):
            k = int(np.searchsorted(offsets, int(gi),
                                    side="right")) - 1
            by_shard.setdefault(k, []).append(pos)
        for k in sorted(by_shard):
            x, _ = self.read_shard(k)
            base = self.row_offset(k)
            for pos in by_shard[k]:
                out[pos] = x[int(indices[pos]) - base]
        return out

    def materialize(self, *, mem_budget_mb: Optional[float] = None,
                    on_bad_shard: str = "raise",
                    allow_nonfinite: bool = False
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """Assemble the full (x, y) through the integrity path — the
        shard-directory branch of ``loader.load_dataset``, for
        consumers that genuinely need arrays (CV folds, the exact dual
        solvers, test evaluation). Budget-guarded up front; rows of
        quarantined shards are DROPPED from the result (count on
        stderr + quarantine events), bounded by ``max_bad_fraction``
        like every other pass."""
        check_materialize_budget(mem_budget_mb, n=self.n, d=self.d,
                                 what=self.directory)
        ydt = np.float32 if self.float_labels else np.int32
        xs: List[np.ndarray] = []
        ys: List[np.ndarray] = []
        for _k, x, y in self.iter_shards(on_bad_shard=on_bad_shard,
                                         allow_nonfinite=allow_nonfinite):
            xs.append(x)
            ys.append(np.asarray(y, ydt))
        if not xs:
            raise IngestAbortError(
                f"{self.directory}: every shard is quarantined")
        dropped = self.n - sum(len(y) for y in ys)
        if dropped:
            _log(f"materialized {self.directory} minus {dropped} "
                 f"row(s) in {len(self.quarantined)} quarantined "
                 f"shard(s)")
        return np.concatenate(xs), np.concatenate(ys)

    def verify(self, spot: Optional[int] = None) -> List[str]:
        """Integrity sweep for `dpsvm doctor`: CRC-verify ``spot``
        shards (first / middle / last; None = all). Returns problem
        strings (empty = healthy) without mutating quarantine state."""
        if spot is None or self.n_shards <= spot:
            picks = list(range(self.n_shards))
        else:
            picks = sorted({0, self.n_shards // 2, self.n_shards - 1})
        problems = []
        for k in picks:
            try:
                self._read_shard_raw(k)
            except (ShardCorruptError, OSError) as e:
                problems.append(f"shard {k} "
                                f"({self.shards[k]['file']}): {e}")
        return problems


# ---------------------------------------------------------------------
# memory-budget admission guards
# ---------------------------------------------------------------------

def _mb(nbytes: float) -> float:
    return nbytes / (1024.0 * 1024.0)


def _fmt_mb(nbytes: float) -> str:
    """MiB with enough precision that tiny datasets never render as
    '0.0 MiB' in a refusal message."""
    mb = _mb(nbytes)
    return f"{mb:.1f} MiB" if mb >= 0.95 else f"{mb:.3g} MiB"


def materialize_bytes(n: int, d: int) -> int:
    """Host bytes a fully materialized (x, y) costs: the f32 matrix
    plus a 4-byte label lane."""
    return n * d * 4 + n * 4


def stream_peak_bytes(rows_per_shard: int, d: int,
                      feat_dim: int = 0) -> int:
    """Peak host bytes of the streaming train path: one raw shard
    block beside its featurized block (+ label/weight lanes). The
    feature block lives on device too, but host peak is what the
    admission guard bounds."""
    return rows_per_shard * (d + feat_dim) * 4 + rows_per_shard * 8


def budget_admit_rows(budget_mb: float, d: int) -> int:
    """How many d-wide rows a ``budget_mb`` materialization admits —
    the inverse of ``materialize_bytes``, shared by the refusal math
    below and the cascade's auto screen-cap (solver/cascade.py: the
    screened subproblem must be a materialization that fits)."""
    return max(int(budget_mb * 1024 * 1024 / (d * 4 + 4)), 1)


def check_materialize_budget(budget_mb: Optional[float], *, n: int,
                             d: int, what: str = "dataset") -> None:
    """Refuse a full materialization that cannot fit ``budget_mb`` —
    up front, naming the shard-count math that WOULD fit."""
    if not budget_mb:
        return
    need = materialize_bytes(n, d)
    if _mb(need) <= float(budget_mb):
        return
    admits = budget_admit_rows(budget_mb, d)
    rps = max(min(DEFAULT_ROWS_PER_SHARD, admits // 4), 1)
    n_shards = -(-n // rps)
    raise MemBudgetError(
        f"{what}: materializing {n} rows x {d} f32 needs "
        f"{_fmt_mb(need)} but --mem-budget-mb {budget_mb:g} admits "
        f"~{admits} rows. Stream it instead: `dpsvm convert shards SRC "
        f"DIR --rows-per-shard {rps}` -> {n_shards} shards "
        f"(ceil({n}/{rps})), then train --solver approx-rff (or "
        f"--solver cascade for exact-quality decisions) on the shard "
        f"directory (per-shard peak "
        f"~{_fmt_mb(stream_peak_bytes(rps, d))})")


def check_stream_budget(budget_mb: Optional[float], *, n: int, d: int,
                        rows_per_shard: int, feat_dim: int = 0,
                        what: str = "dataset") -> None:
    """Admission guard for the streaming train path: the PER-SHARD
    working set must fit the budget; the refusal names the
    rows_per_shard that would."""
    if not budget_mb:
        return
    need = stream_peak_bytes(rows_per_shard, d, feat_dim)
    if _mb(need) <= float(budget_mb):
        return
    per_row = (d + feat_dim) * 4 + 8
    fit_rows = max(int(budget_mb * 1024 * 1024 / per_row), 1)
    raise MemBudgetError(
        f"{what}: streaming at rows_per_shard={rows_per_shard} peaks "
        f"at {_fmt_mb(need)} per shard block ({rows_per_shard} "
        f"rows x ({d} raw + {feat_dim} feature) f32 columns) — over "
        f"--mem-budget-mb {budget_mb:g}. Re-convert with "
        f"--rows-per-shard <= {fit_rows} "
        f"(-> ceil({n}/{fit_rows}) = {-(-n // fit_rows)} shards), or "
        "lower --approx-dim")


# ---------------------------------------------------------------------
# streaming source readers (conversion input)
# ---------------------------------------------------------------------

def _iter_csv_rows(path: str, d: int) -> Iterator[Tuple[float,
                                                        np.ndarray]]:
    with open(path, "r") as fh:
        for lineno, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            parts = line.split(",")
            if len(parts) < d + 1:
                raise ValueError(f"{path}:{lineno}: expected {d + 1} "
                                 f"fields, got {len(parts)}")
            yield (float(parts[0]),
                   np.asarray(parts[1:d + 1], dtype=np.float32))


def _iter_libsvm_rows(path: str, d: int) -> Iterator[Tuple[float,
                                                           np.ndarray]]:
    with open(path, "r") as fh:
        for lineno, line in enumerate(fh, 1):
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            try:
                lab = float(parts[0])
            except ValueError as e:
                raise ValueError(f"{path}:{lineno}: bad label "
                                 f"{parts[0]!r}") from e
            row = np.zeros((d,), np.float32)
            for tok in parts[1:]:
                try:
                    idx_s, val_s = tok.split(":", 1)
                    idx = int(idx_s)
                    val = float(val_s)
                except ValueError as e:
                    raise ValueError(f"{path}:{lineno}: bad feature "
                                     f"token {tok!r}") from e
                if idx < 1:
                    raise ValueError(f"{path}:{lineno}: feature "
                                     "indices are 1-based")
                if idx <= d:        # loader's column-narrowing rule
                    row[idx - 1] = val
            yield lab, row


def source_shape(path: str) -> Tuple[int, int, str]:
    """(rows, width, format) of a loader-supported file, discovered by
    a streaming scan — never materializing the data (the native helper
    accelerates both formats when present)."""
    from dpsvm_tpu_torch.data.loader import csv_shape, sniff_format
    fmt = sniff_format(path)
    if fmt == "csv":
        n, d = csv_shape(path)
        return n, d, fmt
    from dpsvm_tpu_torch.native import load_native_lib
    lib = load_native_lib()
    if lib is not None:
        import ctypes
        max_idx = ctypes.c_long(0)
        n_found = lib.dpsvm_libsvm_stats(path.encode(), np.int64(0),
                                         ctypes.byref(max_idx))
        if n_found > 0:
            return int(n_found), int(max_idx.value), fmt
    n = 0
    max_idx = 0
    with open(path, "r") as fh:
        for line in fh:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            n += 1
            for tok in parts[1:]:
                idx_s = tok.split(":", 1)[0]
                try:
                    max_idx = max(max_idx, int(idx_s))
                except ValueError:
                    pass                  # the fill pass owns the error
    return n, max_idx, fmt


# ---------------------------------------------------------------------
# resumable conversion
# ---------------------------------------------------------------------

def _round_stat(v: float) -> float:
    """Stats enter the manifest as exact float32 values so a resumed
    conversion reproduces them bit-for-bit."""
    return float(np.float32(v))


def convert_to_shards(src: str, out_dir: str, *,
                      rows_per_shard: int = DEFAULT_ROWS_PER_SHARD,
                      num_attributes: Optional[int] = None,
                      float_labels: bool = False,
                      allow_nonfinite: bool = False,
                      resume: bool = True,
                      _stop_after_shards: Optional[int] = None) -> dict:
    """Convert any loader-supported file into a shard directory,
    checkpointing the cursor after every durable shard.

    Returns the manifest dict (written to ``manifest.json``). A killed
    conversion leaves ``convert.cursor.json`` + the durable shards; the
    next call with ``resume=True`` (the default, and the CLI's
    behavior) picks up at the last durable shard and produces a
    manifest byte-identical to an uninterrupted conversion — the
    manifest is a pure function of the source bytes and the shard
    geometry (no timestamps). ``_stop_after_shards`` is the test seam
    for the kill: stop (cursor intact, no manifest) after writing that
    many NEW shards.
    """
    if rows_per_shard < 1:
        raise ValueError(f"rows_per_shard must be >= 1, got "
                         f"{rows_per_shard}")
    if not os.path.exists(src):
        raise FileNotFoundError(src)
    os.makedirs(out_dir, exist_ok=True)
    mpath = os.path.join(out_dir, MANIFEST_NAME)
    if os.path.exists(mpath):
        raise StreamError(
            f"{out_dir}: already holds a completed shard dataset "
            f"({MANIFEST_NAME} exists); convert into a fresh directory")

    n_total, d_file, fmt = source_shape(src)
    d = int(num_attributes) if num_attributes else d_file
    if n_total <= 0 or d <= 0:
        raise ValueError(f"empty dataset: {src!r} scans as "
                         f"({n_total}, {d})")

    cursor_path = os.path.join(out_dir, CURSOR_NAME)
    state = {
        "source": os.path.abspath(src),
        "source_size": os.path.getsize(src),
        "rows_per_shard": int(rows_per_shard),
        "d": d,
        "float_labels": bool(float_labels),
        "rows_done": 0,
        "shards": [],
        "stats": None,
    }
    if resume and os.path.exists(cursor_path):
        try:
            with open(cursor_path) as fh:
                prev = json.load(fh)
        except (OSError, json.JSONDecodeError):
            prev = None
        if (prev is not None
                and prev.get("source_size") == state["source_size"]
                and prev.get("rows_per_shard") == rows_per_shard
                and prev.get("d") == d
                and prev.get("float_labels") == bool(float_labels)):
            state = prev
            _log(f"resuming conversion of {src} at row "
                 f"{state['rows_done']} (shard "
                 f"{len(state['shards'])} of "
                 f"{-(-n_total // rows_per_shard)})")
        elif prev is not None:
            _log("cursor does not match this source/geometry; "
                 "restarting the conversion from scratch")

    stats = state["stats"] or {
        "feature_min": None, "feature_max": None,
        "label_min": None, "label_max": None,
        "rows_nonfinite": 0,
    }
    ydt = np.float32 if float_labels else np.int32
    rows_iter = (_iter_csv_rows(src, d) if fmt == "csv"
                 else _iter_libsvm_rows(src, d))

    buf_x = np.empty((rows_per_shard, d), np.float32)
    buf_y = np.empty((rows_per_shard,), ydt)
    fill = 0
    row_idx = 0
    written_now = 0
    fmin = (np.asarray(stats["feature_min"], np.float32)
            if stats["feature_min"] is not None else None)
    fmax = (np.asarray(stats["feature_max"], np.float32)
            if stats["feature_max"] is not None else None)

    def flush() -> None:
        nonlocal fill, fmin, fmax, written_now
        if fill == 0:
            return
        x = np.ascontiguousarray(buf_x[:fill])
        y = np.ascontiguousarray(buf_y[:fill])
        k = len(state["shards"])
        fname = shard_filename(k)
        _write_shard_atomic(os.path.join(out_dir, fname), x, y)
        state["shards"].append({"file": fname, "rows": int(fill),
                                "crc32": int(payload_crc(x, y))})
        fmin = x.min(axis=0) if fmin is None else np.minimum(fmin,
                                                             x.min(axis=0))
        fmax = x.max(axis=0) if fmax is None else np.maximum(fmax,
                                                             x.max(axis=0))
        lo, hi = float(y.min()), float(y.max())
        stats["label_min"] = (lo if stats["label_min"] is None
                              else min(stats["label_min"], lo))
        stats["label_max"] = (hi if stats["label_max"] is None
                              else max(stats["label_max"], hi))
        stats["feature_min"] = [_round_stat(v) for v in fmin]
        stats["feature_max"] = [_round_stat(v) for v in fmax]
        state["rows_done"] += fill
        state["stats"] = stats
        fill = 0
        written_now += 1
        # The cursor is only written AFTER the shard is durable, so a
        # crash between the two re-writes one (deterministic) shard.
        _write_json_atomic(cursor_path, state)

    for lab, row in rows_iter:
        if row_idx < state["rows_done"]:
            row_idx += 1                 # resume: skip durable rows
            continue
        if not np.isfinite(row).all() or not np.isfinite(lab):
            bad = (np.argwhere(~np.isfinite(row))[0]
                   if not np.isfinite(row).all() else [-1])
            col = int(bad[0])
            where = (f"row {row_idx}, column {col}" if col >= 0
                     else f"row {row_idx} label")
            if not allow_nonfinite:
                raise ValueError(
                    f"{src}: non-finite value at {where} — rejected at "
                    "conversion; pass --allow-nonfinite to shard it "
                    "anyway (the streaming reader will quarantine or "
                    "re-flag it)")
            stats["rows_nonfinite"] = int(stats["rows_nonfinite"]) + 1
        if not float_labels and int(lab) != lab:
            raise ValueError(
                f"{src}: non-integer label {lab!r} at row {row_idx} "
                "(classification shards store int32 labels; convert "
                "regression targets with --float-labels)")
        buf_x[fill] = row
        buf_y[fill] = lab if float_labels else int(lab)
        fill += 1
        row_idx += 1
        if fill == rows_per_shard:
            flush()
            if (_stop_after_shards is not None
                    and written_now >= _stop_after_shards):
                _log(f"stopping after {written_now} shard(s) "
                     "(test seam); cursor left for resume")
                return dict(state)
    flush()
    if row_idx != n_total:
        raise ValueError(f"{src}: scan said {n_total} rows but the "
                         f"fill pass saw {row_idx}")

    manifest = {
        "format": "dpsvm-shards",
        "version": SHARD_FORMAT_VERSION,
        "n": int(state["rows_done"]),
        "d": d,
        "rows_per_shard": int(rows_per_shard),
        "dtype": "float32",
        "label_dtype": "float32" if float_labels else "int32",
        "source_format": fmt,
        "shards": state["shards"],
        "stats": stats,
    }
    _write_json_atomic(mpath, manifest)
    try:
        os.unlink(cursor_path)
    except OSError:
        pass
    return manifest

"""Live shard logs: crash-safe appends and the watcher that admits them
(port of ``dpsvm_tpu/data/live.py``, numpy only; the file format and the
protocol are the JAX package's, so a log either package appends to is
admitted by the other's watcher).

A shard directory (``data/stream.py``) is already a log; this module adds
the protocol that makes it safe to APPEND to while readers train on it.

* **Publish protocol**: a writer lands the shard file with the atomic
  write (tmp + rename), then PUBLISHES it by swapping in a new
  ``manifest.json`` whose ``generation`` is strictly incremented and whose
  bytes carry a self-CRC (``manifest_crc`` over the canonical
  serialization). The swap is atomic too, and the previous good manifest
  is kept at ``manifest.json.prev`` so that a writer restarted over a torn
  manifest (a non-atomic filesystem, a kill -9 mid-write: the
  ``DPSVM_FAULT_LIVE_TORN_PUBLISH`` model) recovers without rebuilding
  state. Readers never consult ``.prev`` (that would regress the
  generation); only writers do.
* **Reader rules**: a reader advances only on a manifest that (a) parses,
  (b) passes its self-CRC, (c) carries a generation STRICTLY greater than
  the reader's, and (d) purely EXTENDS the admitted shard list (the common
  prefix identical). A torn publish, a replayed stale generation or a
  rewritten prefix leaves the reader's view untouched.
* **ShardLogWatcher**: the polling reader: bounded transient-read retry
  (``DPSVM_IO_RETRIES``), quarantine of bad appended shards under the
  ``on_bad_shard`` policy, and an ``append_admitted`` event per admitted
  shard naming shard and generation (live training wires the sink to the
  driver's event queue; a standalone watcher emits nowhere).

The consumer is ``approx/primal.fit_approx_stream(live=True)``, which
admits new durable shards at sweep boundaries. ``python -m
dpsvm_tpu_torch.data.live DIR --append N`` is a writer process
(``writer_main``). No device is touched here: a writer needs no card.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Callable, List, Optional

import numpy as np

from dpsvm_tpu_torch.data.stream import (DEFAULT_IO_BACKOFF_S,
                                         DEFAULT_IO_RETRIES, MANIFEST_NAME,
                                         ShardedDataset, StreamError,
                                         TornPublishError,
                                         _write_json_atomic,
                                         _write_shard_atomic, manifest_crc,
                                         payload_crc, pin_manifest_generation,
                                         shard_filename, verify_manifest_crc)
from dpsvm_tpu_torch.resilience import faultinject

__all__ = ["PREV_MANIFEST_NAME", "TornPublishError", "WriterCrashError",
           "manifest_crc", "verify_manifest_crc", "read_manifest_checked",
           "append_shard", "publish_manifest", "ShardLogWatcher",
           "writer_main"]

#: the writer's rolling backup of the last good manifest: consulted only
#: by writers recovering from a torn publish
PREV_MANIFEST_NAME = MANIFEST_NAME + ".prev"


class WriterCrashError(StreamError):
    """Raised by the LIVE_* fault hooks at their crash point: the
    deterministic stand-in for a writer process dying."""


def _log(msg: str) -> None:
    print(f"LIVELOG: {msg}", file=sys.stderr, flush=True)


def read_manifest_checked(directory: str) -> dict:
    """Parse and verify ``directory``'s manifest under the reader rules:
    raises ``TornPublishError`` on anything a mid-publish writer could
    have left (unparseable bytes, a failed self-CRC) and ``StreamError``
    on a missing manifest. A manifest without a self-CRC (a converted
    directory never appended to) passes."""
    mpath = os.path.join(directory, MANIFEST_NAME)
    if not os.path.exists(mpath):
        raise StreamError(f"{directory}: no {MANIFEST_NAME} — not a "
                          "shard dataset")
    try:
        with open(mpath) as fh:
            manifest = json.load(fh)
    except (OSError, json.JSONDecodeError) as e:
        raise TornPublishError(
            f"{mpath}: unparseable manifest ({e}) — a torn publish; "
            "readers must hold their last admitted view") from e
    if "manifest_crc" in manifest:
        verify_manifest_crc(manifest, where=mpath)
    return manifest


# ---------------------------------------------------------------------
# the writer side: crash-safe append
# ---------------------------------------------------------------------

def _read_writer_manifest(directory: str) -> dict:
    """The manifest a writer resumes from: the live one when intact, else
    the ``.prev`` backup (recovering a torn publish; the torn
    generation's shard is orphaned on disk and the next append rewrites
    it)."""
    try:
        return read_manifest_checked(directory)
    except TornPublishError as e:
        prev = os.path.join(directory, PREV_MANIFEST_NAME)
        if os.path.exists(prev):
            try:
                with open(prev) as fh:
                    manifest = json.load(fh)
                if "manifest_crc" in manifest:
                    verify_manifest_crc(manifest, where=prev)
                _log(f"recovering from torn publish via {prev} "
                     f"(generation {manifest.get('generation', 0)}); "
                     "re-publishing will repair the live manifest")
                return manifest
            except (OSError, json.JSONDecodeError, TornPublishError):
                pass
        raise StreamError(
            f"{directory}: manifest is torn and no intact "
            f"{PREV_MANIFEST_NAME} backup exists — {e}") from e


def append_shard(directory: str, x: np.ndarray, y: np.ndarray) -> dict:
    """Append one shard to a live log, crash-safely: atomic shard write,
    atomic backup of the current manifest to ``.prev``, atomic publish of
    the new manifest with ``generation + 1``, the shard's entry stamped
    with the generation that published it, and a fresh self-CRC. ``x``
    holds 1..``rows_per_shard`` rows (a partial batch publishes as a
    partial shard). Returns the published manifest."""
    manifest = _read_writer_manifest(directory)
    x = np.ascontiguousarray(np.asarray(x, np.float32))
    ydt = (np.float32 if manifest.get("label_dtype") == "float32"
           else np.int32)
    y = np.ascontiguousarray(np.asarray(y, ydt))
    if x.ndim != 2 or x.shape[1] != int(manifest["d"]):
        raise ValueError(
            f"appended shard must be (rows, {manifest['d']}), got "
            f"{x.shape}")
    if y.shape != (x.shape[0],):
        raise ValueError(f"labels must be ({x.shape[0]},), got "
                         f"{y.shape}")
    rows = int(x.shape[0])
    rps = int(manifest["rows_per_shard"])
    if not (1 <= rows <= rps):
        raise ValueError(
            f"appended shard holds {rows} row(s); the log's geometry "
            f"admits 1..{rps} (rows_per_shard={rps} — fixed shapes "
            "are the zero-retrace contract)")
    if not np.isfinite(x).all():
        bad = np.argwhere(~np.isfinite(x))[0]
        raise ValueError(f"appended shard has a non-finite value at "
                         f"row {int(bad[0])}, column {int(bad[1])} — "
                         "rejected before it can poison the log")

    k = len(manifest["shards"])
    gen = int(manifest.get("generation", 0)) + 1
    fname = shard_filename(k)
    _write_shard_atomic(os.path.join(directory, fname), x, y)

    plan = faultinject.current()
    if plan is not None and plan.live_append_begin():
        # durable but unpublished: the orphan file is in no manifest, and
        # the next append overwrites it at the same index
        raise WriterCrashError(
            f"writer crashed after shard {fname} was durable, before "
            "its publish (injected)")

    new = dict(manifest)
    new["shards"] = list(manifest["shards"]) + [{
        "file": fname, "rows": rows, "crc32": int(payload_crc(x, y)),
        "generation": gen,
    }]
    new["n"] = int(manifest["n"]) + rows
    new["generation"] = gen
    stats = dict(manifest.get("stats") or {})
    if stats.get("feature_min") is not None:
        fmin = np.minimum(np.asarray(stats["feature_min"], np.float32),
                          x.min(axis=0))
        fmax = np.maximum(np.asarray(stats["feature_max"], np.float32),
                          x.max(axis=0))
        stats["feature_min"] = [float(np.float32(v)) for v in fmin]
        stats["feature_max"] = [float(np.float32(v)) for v in fmax]
        stats["label_min"] = min(float(stats["label_min"]),
                                 float(y.min()))
        stats["label_max"] = max(float(stats["label_max"]),
                                 float(y.max()))
        new["stats"] = stats
    return publish_manifest(directory, new, previous=manifest)


def publish_manifest(directory: str, manifest: dict, *,
                     previous: Optional[dict] = None) -> dict:
    """The atomic generation swap: back the current good manifest up to
    ``.prev``, stamp the self-CRC, replace ``manifest.json``. The fault
    hooks simulate the writer's two failure modes here: a TORN publish
    (half the bytes written in place, then a crash) and a STALE publish
    (CRC-valid bytes whose generation did not advance)."""
    mpath = os.path.join(directory, MANIFEST_NAME)
    if previous is not None:
        _write_json_atomic(os.path.join(directory, PREV_MANIFEST_NAME),
                           previous)
    plan = faultinject.current()
    mode = plan.live_publish_mode() if plan is not None else "clean"
    if mode == "stale":
        stale = dict(manifest)
        stale["generation"] = int(previous.get("generation", 0)
                                  if previous is not None else 0)
        stale["manifest_crc"] = manifest_crc(stale)
        _write_json_atomic(mpath, stale)
        return stale
    manifest = dict(manifest)
    manifest["manifest_crc"] = manifest_crc(manifest)
    if mode == "torn":
        raw = (json.dumps(manifest, sort_keys=True, indent=1)
               + "\n").encode()
        with open(mpath, "wb") as fh:      # deliberately NON-atomic
            fh.write(raw[: len(raw) // 2])
        raise WriterCrashError(
            "writer crashed mid-publish: manifest.json is torn "
            "(injected); readers hold their view, the restarted "
            "writer recovers from .prev")
    _write_json_atomic(mpath, manifest)
    return manifest


# ---------------------------------------------------------------------
# the reader side: the watcher
# ---------------------------------------------------------------------

def admission_barrier(observed_gen: int, committed_gen: int) -> int:
    """The generation this process may commit: on one host the identity;
    inside a supervised host group the minimum over the group's published
    generations (``resilience/hostgroup.admission_barrier``)."""
    from dpsvm_tpu_torch.resilience import hostgroup
    return hostgroup.admission_barrier(observed_gen, committed_gen)


class ShardLogWatcher:
    """Polling reader over a live shard log.

    Wraps a ``ShardedDataset`` handle, whose view it grows in place
    (every consumer holding the handle sees the admitted shards), and
    enforces the reader rules of the module docstring. ``poll()`` is host
    I/O only: one manifest read a call, and shard payloads only when
    ``verify_appends`` asks for an integrity read of new shards.

    Counters: ``torn_observed`` / ``stale_observed`` count the publishes
    this reader refused; ``admitted_shards`` / ``admitted_rows`` total
    what it accepted.
    """

    def __init__(self, ds: ShardedDataset, *,
                 on_bad_shard: str = "raise",
                 allow_nonfinite: bool = False,
                 on_event: Optional[Callable[..., None]] = None,
                 verify_appends: bool = True):
        self.ds = ds
        self.on_bad_shard = on_bad_shard
        self.allow_nonfinite = allow_nonfinite
        self.verify_appends = verify_appends
        self._on_event = on_event
        self.torn_observed = 0
        self.stale_observed = 0
        self.admitted_shards = 0
        self.admitted_rows = 0

    @property
    def generation(self) -> int:
        return self.ds.generation

    def _emit(self, event: str, **extra) -> None:
        # No default sink: a standalone watcher must not feed the training
        # driver's global event queue.
        if self._on_event is not None:
            self._on_event(event, **extra)

    def _read_manifest_retrying(self) -> Optional[dict]:
        retries = int(os.environ.get("DPSVM_IO_RETRIES",
                                     str(DEFAULT_IO_RETRIES)))
        backoff = float(os.environ.get("DPSVM_IO_RETRY_BACKOFF_S",
                                       str(DEFAULT_IO_BACKOFF_S)))
        for attempt in range(retries + 1):
            try:
                return read_manifest_checked(self.ds.directory)
            except TornPublishError:
                # a writer mid-crash (or mid-write): hold the view; the
                # next poll is the retry
                self.torn_observed += 1
                _log(f"{self.ds.directory}: torn publish observed "
                     f"(#{self.torn_observed}); holding generation "
                     f"{self.ds.generation}")
                return None
            except (OSError, StreamError) as e:
                if attempt >= retries or not isinstance(e, OSError):
                    raise
                wait = backoff * (2.0 ** attempt)
                _log(f"transient manifest read failure ({e}); retry "
                     f"{attempt + 1}/{retries} in {wait:g}s")
                time.sleep(wait)
        return None

    def poll(self) -> List[int]:
        """One watch cycle: the newly admitted shard indices (empty when
        the log did not durably advance). Emits one ``append_admitted``
        event a shard (shard, generation, rows)."""
        manifest = self._read_manifest_retrying()
        if manifest is None:
            return []
        gen = int(manifest.get("generation", 0))
        if gen < self.ds.generation:
            # a replayed generation: never regress
            self.stale_observed += 1
            _log(f"{self.ds.directory}: manifest generation {gen} < "
                 f"admitted {self.ds.generation}; refusing to regress "
                 f"(#{self.stale_observed})")
            return []
        if gen == self.ds.generation:
            if len(manifest["shards"]) != len(self.ds.shards):
                # same generation, other content: a publish that changed
                # the log without advancing the counter
                self.stale_observed += 1
                _log(f"{self.ds.directory}: generation {gen} manifest "
                     f"holds {len(manifest['shards'])} shard(s) vs "
                     f"the admitted {len(self.ds.shards)} at the SAME "
                     "generation; refusing a non-advancing publish "
                     f"(#{self.stale_observed})")
            return []
        commit = admission_barrier(gen, self.ds.generation)
        if commit <= self.ds.generation:
            return []
        if commit < gen:
            manifest = pin_manifest_generation(manifest, commit)
            gen = commit
        admitted = self.ds.admit_manifest(manifest)
        for k in admitted:
            meta = self.ds.shards[k]
            if self.verify_appends:
                got = self.ds.read_shard_checked(
                    k, on_bad_shard=self.on_bad_shard,
                    allow_nonfinite=self.allow_nonfinite)
                if got is None:          # quarantined under the policy
                    continue
            self.admitted_shards += 1
            self.admitted_rows += int(meta["rows"])
            self._emit("append_admitted", shard=int(k),
                       generation=int(meta.get("generation", gen)),
                       rows=int(meta["rows"]))
        return admitted

    def wait_for_generation(self, generation: int, *,
                            timeout_s: float = 30.0,
                            interval_s: float = 0.02) -> bool:
        """Poll until the admitted generation reaches ``generation``
        (True) or the deadline passes (False)."""
        deadline = time.monotonic() + timeout_s
        while self.ds.generation < generation:
            if time.monotonic() > deadline:
                return False
            self.poll()
            if self.ds.generation < generation:
                time.sleep(interval_s)
        return True


# ---------------------------------------------------------------------
# subprocess writer
# ---------------------------------------------------------------------

def writer_main(argv: Optional[List[str]] = None) -> int:
    """``python -m dpsvm_tpu_torch.data.live DIR --append N --rows R``: a
    writer process appending synthetic blob shards to a live log (the
    ``DPSVM_FAULT_LIVE_*`` knobs apply). ``--source FILE.npz`` appends
    the rows of its ``x``/``y`` arrays in order instead. Prints one
    ``APPENDED k generation g`` line a publish."""
    import argparse

    p = argparse.ArgumentParser(prog="python -m dpsvm_tpu_torch.data.live")
    p.add_argument("directory")
    p.add_argument("--append", type=int, default=4,
                   help="how many shards to append")
    p.add_argument("--rows", type=int, default=0,
                   help="rows per appended shard (0 = the log's "
                        "rows_per_shard)")
    p.add_argument("--seed", type=int, default=100)
    p.add_argument("--d", type=int, default=0,
                   help="feature width (0 = the log's)")
    p.add_argument("--interval-ms", type=float, default=0.0)
    p.add_argument("--shift", type=float, default=0.0,
                   help="mean shift applied to shards the "
                        "LIVE_SHIFT_AT_SHARD hook selects (or all, "
                        "when --shift-all)")
    p.add_argument("--shift-all", action="store_true")
    p.add_argument("--source", default=None, metavar="FILE.npz",
                   help="append rows of this file's x and y arrays in "
                        "order (a planted dataset) instead of blobs")
    p.add_argument("--ready", action="store_true",
                   help="print READY once started (before --delay-ms), "
                        "so a reader can start its run first")
    p.add_argument("--delay-ms", type=float, default=0.0,
                   help="sleep this long before the first append")
    args = p.parse_args(argv)

    manifest = _read_writer_manifest(args.directory)
    d = args.d or int(manifest["d"])
    rows = args.rows or int(manifest["rows_per_shard"])
    rng = np.random.default_rng(args.seed)
    plan = faultinject.current()
    src = None
    if args.source:
        with np.load(args.source) as npz:
            src = (np.asarray(npz["x"], np.float32), np.asarray(npz["y"]))
    lo = 0
    if args.ready:
        print("READY", flush=True)
    if args.delay_ms:
        time.sleep(args.delay_ms / 1000.0)
    for i in range(args.append):
        if src is not None:
            if lo >= src[0].shape[0]:
                break
            x, y = src[0][lo:lo + rows], src[1][lo:lo + rows]
            lo += x.shape[0]
        else:
            x = rng.standard_normal((rows, d)).astype(np.float32)
            y = np.where(x[:, 0] + 0.25 * x[:, 1] > 0, 1, -1)
            shifted = (args.shift_all
                       or (plan is not None and plan.live_shift_now(i)))
            if shifted and args.shift:
                x = x + np.float32(args.shift)
                # concept stays, covariates move
                y = np.where((x[:, 0] - args.shift)
                             + 0.25 * (x[:, 1] - args.shift) > 0, 1, -1)
        m = append_shard(args.directory, x, y)
        print(f"APPENDED {len(m['shards']) - 1} generation "
              f"{m['generation']}", flush=True)
        if args.interval_ms:
            time.sleep(args.interval_ms / 1000.0)
    return 0


if __name__ == "__main__":
    sys.exit(writer_main())

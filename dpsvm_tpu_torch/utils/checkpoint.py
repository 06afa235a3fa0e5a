"""Mid-training checkpoint and resume (port of ``dpsvm_tpu/utils/checkpoint.py``).

The solver state is two n-vectors (alpha, f) and a few scalars, so a
checkpoint is one .npz written every ``checkpoint_every`` iterations at a
poll of the host loop, and a resumed run continues the same trajectory:
the loop condition depends only on (alpha, f, b_lo, b_hi, n_iter), all of
which are saved. The file format is the JAX package's, version 3, so a
file written by either package resumes in the other.

Hardening, as there:

* atomic write: tmp + rename, so a crash mid-save never corrupts the
  previous checkpoint;
* payload CRC32, stored in the .npz and verified on load, so a bit-flipped
  or truncated file raises ``CheckpointCorruptError``;
* keep-N rotation: ``save_checkpoint(..., keep=N)`` shifts the previous
  file to ``state.1.npz``, ``state.2.npz``, ... before the rename, so a
  corrupt newest slot still leaves an intact older state to resume from
  (``solver.driver.resume_state``).

Hyperparameters are stored beside the state and checked on load; a
checkpoint of another problem shape or config raises
``CheckpointMismatchError`` (a ``ValueError``).

The shard-aware manifest (format 2: the mesh the state was saved on and a
CRC32 a shard region) and the host group (format 3) are written and read
as the JAX package does. A run on one device writes ``shards=1``,
``host_count=1``, ``host_id=0``; a distributed run (``parallel/``) gathers
the global (alpha, f) on every rank and rank 0 writes them with
``shards=P``, ``host_count=P`` (one process a rank) and ``host_id=0``,
and a CRC32 for each of the P shard regions (``shard_slices``). A file of
any mesh resumes on any other, since the state is the global unpadded
(alpha, f). Pre-elastic files (no mesh fields) load as single-shard
records.
"""

from __future__ import annotations

import dataclasses
import io
import os
import struct
import sys
import tempfile
import zipfile
import zlib
from typing import Callable, List, Optional, Tuple

import numpy as np

# LIBSVM -t order; index = the integer stored in the checkpoint scalars.
_KERNEL_T = ("linear", "poly", "rbf", "sigmoid", "precomputed")

#: On-disk format version stored in the ``mesh`` array: 3 = the host-group
#: manifest, 2 = the shard manifest, files without the array are version 1.
CKPT_FORMAT_VERSION = 3


def shard_slices(n: int, shards: int) -> List[Tuple[int, int]]:
    """The per-shard (lo, hi) row ranges of the save-time layout:
    contiguous equal shards of n padded up to a multiple of ``shards``,
    clipped to n. The per-shard CRCs are computed over exactly these."""
    shards = max(int(shards), 1)
    n_s = (n + shards - 1) // shards
    return [(min(k * n_s, n), min((k + 1) * n_s, n))
            for k in range(shards)]


def _shard_crcs(alpha: np.ndarray, f: np.ndarray,
                shards: int) -> np.ndarray:
    out = np.zeros((max(int(shards), 1),), np.uint32)
    for k, (lo, hi) in enumerate(shard_slices(len(alpha), shards)):
        crc = zlib.crc32(np.ascontiguousarray(alpha[lo:hi]).tobytes())
        out[k] = zlib.crc32(np.ascontiguousarray(f[lo:hi]).tobytes(),
                            crc)
    return out


class CheckpointError(Exception):
    """Base of every checkpoint failure this module raises."""


class CheckpointCorruptError(CheckpointError):
    """The file exists but its payload cannot be trusted: truncated or
    unreadable .npz, missing arrays, or a CRC32 mismatch."""


class CheckpointMismatchError(CheckpointError, ValueError):
    """An intact checkpoint of another problem or config."""


@dataclasses.dataclass
class SolverCheckpoint:
    alpha: np.ndarray      # (n,) f32
    f: np.ndarray          # (n,) f32
    n_iter: int
    b_lo: float
    b_hi: float
    c: float
    gamma: float
    epsilon: float
    n: int
    d: int
    weight_pos: float = 1.0
    weight_neg: float = 1.0
    kernel: str = "rbf"
    coef0: float = 0.0
    degree: int = 3
    # Format 2: the mesh the state was saved on and a CRC32 a shard
    # region (pre-elastic files read as shards=1, shard_crcs=None).
    shards: int = 1
    shard_crcs: Optional[np.ndarray] = None
    # Format 3: the host group it was saved from; informational (pre-v3
    # files read as host_count=1, host_id=0).
    host_count: int = 1
    host_id: int = 0

    def mesh_desc(self) -> str:
        return (f"({self.shards},)-mesh / {self.shards} device"
                f"{'s' if self.shards != 1 else ''}")

    def validate_against(self, n: int, d: int, config, gamma: float,
                         shards: Optional[int] = None) -> None:
        """Raise ``CheckpointMismatchError`` on a permanent mismatch. A
        difference of mesh alone is never one."""
        here = (f"({shards},)-mesh / {shards} device"
                f"{'s' if shards != 1 else ''}"
                if shards is not None else "this run's mesh")
        if self.kernel == "precomputed" and self.n != self.d:
            raise CheckpointMismatchError(
                f"checkpoint kernel='precomputed' must be square (n, n), "
                f"got ({self.n}, {self.d})")
        if (self.n, self.d) != (n, d):
            raise CheckpointMismatchError(
                f"checkpoint is for a ({self.n}, {self.d}) problem "
                f"saved on a {self.mesh_desc()}; "
                f"data is ({n}, {d}) on {here}")
        if self.kernel != config.kernel:
            raise CheckpointMismatchError(
                f"checkpoint kernel={self.kernel!r} != "
                f"configured kernel={config.kernel!r}")
        for name, mine, theirs in (
                ("c", self.c, config.c),
                ("gamma", self.gamma, gamma),
                ("coef0", self.coef0, config.coef0),
                ("degree", self.degree, config.degree),
                ("epsilon", self.epsilon, config.epsilon),
                ("weight_pos", self.weight_pos, config.weight_pos),
                ("weight_neg", self.weight_neg, config.weight_neg)):
            if abs(mine - theirs) > 1e-12 * max(1.0, abs(mine)):
                raise CheckpointMismatchError(
                    f"checkpoint {name}={mine} != configured {name}={theirs}")

    def needs_reshard(self, shards: int) -> bool:
        return int(self.shards) != int(shards)

    def verify_shard_crcs(self) -> List[int]:
        """Indices of shard regions whose recorded CRC does not match the
        loaded payload (empty: all intact, or no manifest)."""
        if self.shard_crcs is None:
            return []
        actual = _shard_crcs(
            np.ascontiguousarray(self.alpha, np.float32),
            np.ascontiguousarray(self.f, np.float32), self.shards)
        want = np.asarray(self.shard_crcs, np.uint32)
        if len(actual) != len(want):
            return list(range(len(want)))
        return [k for k in range(len(want)) if actual[k] != want[k]]


def _payload(alpha: np.ndarray, f: np.ndarray,
             scalars: np.ndarray) -> tuple:
    return (np.ascontiguousarray(alpha, np.float32),
            np.ascontiguousarray(f, np.float32),
            np.ascontiguousarray(scalars, np.float64))


def _crc32(alpha: np.ndarray, f: np.ndarray, scalars: np.ndarray) -> int:
    crc = zlib.crc32(alpha.tobytes())
    crc = zlib.crc32(f.tobytes(), crc)
    return zlib.crc32(scalars.tobytes(), crc)


def rotation_path(path: str, k: int) -> str:
    """Slot k of a rotation set: ``state.npz`` -> ``state.1.npz``; k=0 is
    the path itself."""
    if k == 0:
        return path
    base, ext = os.path.splitext(path)
    return f"{base}.{k}{ext}" if ext else f"{path}.{k}"


def checkpoint_candidates(path: str, limit: int = 100) -> List[str]:
    """Existing rotation slots, newest first: [path, path.1, ...]. The
    primary path is listed even when absent (so an error names it)."""
    out = [path]
    for k in range(1, limit):
        p = rotation_path(path, k)
        if not os.path.exists(p):
            break
        out.append(p)
    return out


def _rotate(path: str, keep: int) -> None:
    """Shift path -> path.1 -> ... keeping ``keep`` files in all (the
    newest, about to be written, counts as one)."""
    if keep <= 1 or not os.path.exists(path):
        return
    for k in range(keep - 1, 0, -1):
        src = rotation_path(path, k - 1)
        if os.path.exists(src):
            os.replace(src, rotation_path(path, k))


def save_checkpoint(path: str, ckpt: SolverCheckpoint,
                    keep: int = 1) -> None:
    """Atomic write (tmp + rename) with an embedded payload CRC32;
    ``keep > 1`` first rotates the previous files to ``.1``, ``.2``, ..."""
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    alpha, f, scalars = _payload(
        ckpt.alpha, ckpt.f,
        np.asarray(
            [ckpt.n_iter, ckpt.b_lo, ckpt.b_hi, ckpt.c, ckpt.gamma,
             ckpt.epsilon, ckpt.n, ckpt.d, ckpt.weight_pos,
             ckpt.weight_neg, _KERNEL_T.index(ckpt.kernel), ckpt.coef0,
             ckpt.degree], np.float64))
    shards = max(int(ckpt.shards or 1), 1)
    mesh = np.asarray([CKPT_FORMAT_VERSION, shards,
                       max(int(ckpt.host_count or 1), 1),
                       max(int(ckpt.host_id or 0), 0)], np.int64)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            np.savez(fh, alpha=alpha, f=f, scalars=scalars,
                     crc32=np.asarray([_crc32(alpha, f, scalars)],
                                      np.uint32),
                     mesh=mesh, shard_crc=_shard_crcs(alpha, f, shards))
        _rotate(path, keep)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _bad_shards(alpha, f, mesh, shard_crc) -> Optional[List[int]]:
    """Shard regions whose bytes fail the recorded per-shard CRC; None
    when the file has no shard manifest."""
    shards = int(mesh[1]) if mesh is not None and len(mesh) > 1 else 1
    if shard_crc is None or len(shard_crc) != shards:
        return None
    actual = _shard_crcs(np.asarray(alpha, np.float32),
                         np.asarray(f, np.float32), shards)
    want = np.asarray(shard_crc, np.uint32)
    return [k for k in range(shards) if actual[k] != want[k]]


def _integrity_detail(alpha, f, mesh, shard_crc) -> str:
    """The '; damaged shard region(s) ...' suffix of corruption errors
    (empty when the file has no shard manifest)."""
    bad = _bad_shards(alpha, f, mesh, shard_crc)
    if bad is None:
        return ""
    shards = int(mesh[1]) if mesh is not None and len(mesh) > 1 else 1
    return (f"; damaged shard region(s) {bad or ['scalars']} "
            f"of {shards}")


def _salvage_npz(path: str) -> dict:
    """An .npz's member arrays read past the zip's per-member CRC, from
    the local file headers, so that a bit-flipped payload can still be
    diagnosed by shard region. Used only to word the error of a file the
    zip layer already rejected."""
    out: dict = {}
    with zipfile.ZipFile(path) as zf, open(path, "rb") as fh:
        for info in zf.infolist():
            fh.seek(info.header_offset)
            hdr = fh.read(30)
            if len(hdr) < 30 or hdr[:4] != b"PK\x03\x04":
                raise ValueError(f"bad local header for {info.filename}")
            fn_len, extra_len = struct.unpack("<HH", hdr[26:30])
            fh.seek(info.header_offset + 30 + fn_len + extra_len)
            data = fh.read(info.compress_size)
            if info.compress_type == zipfile.ZIP_DEFLATED:
                data = zlib.decompressobj(-15).decompress(data)
            name = (info.filename[:-4]
                    if info.filename.endswith(".npy") else info.filename)
            out[name] = np.lib.format.read_array(io.BytesIO(data),
                                                 allow_pickle=False)
    return out


def load_checkpoint(path: str) -> SolverCheckpoint:
    """Read and integrity-check one checkpoint file.

    Raises ``FileNotFoundError`` for a missing path and
    ``CheckpointCorruptError`` for anything unreadable: a truncated or
    empty file, a bad zip, missing arrays, or a CRC mismatch. Files from
    before the CRC field load without the check."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    try:
        with np.load(path) as z:
            alpha = np.asarray(z["alpha"], np.float32)
            f = np.asarray(z["f"], np.float32)
            s = np.asarray(z["scalars"], np.float64)
            stored_crc = (int(np.asarray(z["crc32"]).ravel()[0])
                          if "crc32" in z.files else None)
            mesh = (np.asarray(z["mesh"], np.int64)
                    if "mesh" in z.files else None)
            shard_crc = (np.asarray(z["shard_crc"], np.uint32)
                         if "shard_crc" in z.files else None)
    except FileNotFoundError:
        raise
    except Exception as e:     # BadZipFile, EOFError, KeyError, ValueError
        where = ""
        try:
            z = _salvage_npz(path)
            where = _integrity_detail(
                np.asarray(z["alpha"], np.float32),
                np.asarray(z["f"], np.float32),
                z.get("mesh"), z.get("shard_crc"))
        except Exception:
            pass
        raise CheckpointCorruptError(
            f"unreadable checkpoint {path}: "
            f"{type(e).__name__}: {e}{where}") from e
    shards = int(mesh[1]) if mesh is not None and len(mesh) > 1 else 1
    host_count = int(mesh[2]) if mesh is not None and len(mesh) > 2 else 1
    host_id = int(mesh[3]) if mesh is not None and len(mesh) > 3 else 0
    if stored_crc is not None:
        actual = _crc32(*_payload(alpha, f, s))
        if actual != stored_crc:
            where = _integrity_detail(alpha, f, mesh, shard_crc)
            raise CheckpointCorruptError(
                f"checkpoint {path} failed its integrity check "
                f"(crc32 {actual:#010x} != stored {stored_crc:#010x})"
                + where)
        # The payload verifies: a per-shard mismatch means the manifest
        # itself is damaged, and the slot cannot be trusted.
        if _bad_shards(alpha, f, mesh, shard_crc):
            raise CheckpointCorruptError(
                f"checkpoint {path} has a damaged shard-CRC manifest "
                f"(payload verifies, shard records do not)")
    if s.ndim != 1 or len(s) < 8 or alpha.ndim != 1 or f.ndim != 1:
        raise CheckpointCorruptError(
            f"checkpoint {path} has a malformed payload "
            f"(scalars shape {s.shape}, alpha shape {alpha.shape})")
    return SolverCheckpoint(
        alpha=alpha, f=f,
        n_iter=int(s[0]), b_lo=float(s[1]), b_hi=float(s[2]),
        c=float(s[3]), gamma=float(s[4]), epsilon=float(s[5]),
        n=int(s[6]), d=int(s[7]),
        # files from before class weights carry 8 scalars; from before
        # the kernel family, 10
        weight_pos=float(s[8]) if len(s) > 8 else 1.0,
        weight_neg=float(s[9]) if len(s) > 9 else 1.0,
        kernel=_KERNEL_T[int(s[10])] if len(s) > 10 else "rbf",
        coef0=float(s[11]) if len(s) > 11 else 0.0,
        degree=int(s[12]) if len(s) > 12 else 3,
        shards=shards, shard_crcs=shard_crc,
        host_count=host_count, host_id=host_id)


def newest_intact_checkpoint(path: str) -> Tuple[Optional[str], List[str]]:
    """(newest rotation slot that loads cleanly, slots skipped as corrupt
    or missing). Checking it against a config is the caller's job."""
    skipped: List[str] = []
    for p in checkpoint_candidates(path):
        try:
            load_checkpoint(p)
            return p, skipped
        except (CheckpointError, FileNotFoundError, OSError):
            skipped.append(p)
    return None, skipped


def maybe_checkpoint(config, last_saved_iter: int, n_iter: int,
                     make: Callable[[], SolverCheckpoint]) -> int:
    """Save when an every-N boundary was crossed; returns the new
    last_saved_iter. A failed periodic save is a warning: the training
    state is intact and the rotation slots still hold the previous
    file."""
    every = config.checkpoint_every
    path = config.checkpoint_path
    if not every or not path:
        return last_saved_iter
    if n_iter // every > last_saved_iter // every:
        try:
            save_checkpoint(path, make(), keep=config.checkpoint_keep)
        except (OSError, CheckpointError) as e:
            print(f"WARNING: checkpoint save failed at iter {n_iter} "
                  f"({e}); training continues, previous checkpoint kept",
                  file=sys.stderr, flush=True)
            return last_saved_iter
        return n_iter
    return last_saved_iter


def dist_checkpoint(config, last_saved_iter: int, n_iter: int,
                    make: Callable[[], SolverCheckpoint],
                    write: bool) -> int:
    """``maybe_checkpoint`` for the ranks of a distributed run: when an
    every-N boundary is crossed every rank calls ``make`` (it gathers the
    state, a collective) and only the rank with ``write`` saves. Every
    rank records the boundary as taken, a failed save included (a warning
    on the writer), so that no rank ever gathers alone."""
    every = config.checkpoint_every
    if not every or not config.checkpoint_path:
        return last_saved_iter
    if n_iter // every <= last_saved_iter // every:
        return last_saved_iter
    ckpt = make()
    if write:
        try:
            save_checkpoint(config.checkpoint_path, ckpt,
                            keep=config.checkpoint_keep)
        except (OSError, CheckpointError) as e:
            print(f"WARNING: checkpoint save failed at iter {n_iter} "
                  f"({e}); training continues, previous checkpoint kept",
                  file=sys.stderr, flush=True)
    return n_iter

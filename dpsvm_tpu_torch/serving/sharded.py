"""Sharded decision pass: one model's buffers spread over several devices
(port of ``dpsvm_tpu/serving/sharded.py``).

The engine's single-device ladder assumes the packed model fits one
device's memory. A model that does not (a large SV set, a wide approx
feature map) is served here by sharding the REDUCTION axis of its
decision program over an explicit list of torch devices, in one process:

* **SV models**: the support-vector axis. Each device holds S/n SV rows
  with their coefficients and squared norms and computes its partial
  (m, S/n) kernel product times coefficients; the query rows are copied
  to every device (they are small).
* **Approx models**: the FEATURE axis. RFF: each device holds a column
  block of omega and the matching (cos half, sin half) weight slices, so
  its partial is the single-device featurize-and-dot, narrower, at the
  GLOBAL scale sqrt(2/dim). Nystrom: the landmarks are copied to every
  device; the whitening projection's columns and w are sharded.

The sharded axis is padded to a multiple of the device count with zero
coefficients or zero weights, whose float32 contribution is exactly 0.0.
The partials are copied to the first device and added there in device
order. The JAX package runs one program over a mesh of local devices with
a ``psum``; this is the same reduction as explicit copies and adds, so
that the tests can pass ``devices=[cpu] * 4`` and the card
``[cuda:0] * 2`` (one process, no collective library).

**Parity.** Float32 addition does not reassociate, so a fold of partials
is not bitwise the single-pass ladder's decision (it agrees to float32
rounding, within 1e-5 at the tests' sizes). What is exact is ``reference``:
the same blocked program on the first device alone, partial by partial
in device order, bitwise what the spread run produces whenever the
devices are of one kind.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
import torch

from dpsvm_tpu_torch.models.svm import row_tiles
from dpsvm_tpu_torch.ops.kernels import (dots_f32, exact_f32, kernel_rows,
                                         row_norms_sq, rows_from_dots)

__all__ = ["ShardedDecider", "model_bytes_est", "eligible"]


def model_bytes_est(model) -> int:
    """Estimated device bytes of the packed decision buffers: SV rows,
    coefficients and squared norms (f32) for SV models, the feature map's
    arrays and w for approx models, summed over the pairs of a multiclass
    model. Query blocks and outputs are ladder-bounded and excluded."""
    if getattr(model, "is_approx", False):
        fmap = model.fmap
        dim = int(fmap.dim)
        if fmap.kind == "rff":
            return (int(fmap.d) * (dim // 2) + dim) * 4
        n_land = int(fmap.landmarks.shape[0])
        return (n_land * int(fmap.d) + n_land + n_land * dim + dim) * 4
    if getattr(model, "models", None) is not None:       # multiclass
        return int(sum(model_bytes_est(m) for m in model.models))
    if model.kernel == "precomputed":
        return int(model.n_sv) * (4 + 8)
    d = int(model.x_sv.shape[1])
    return int(model.n_sv) * (d + 2) * 4


def eligible(model) -> bool:
    """Binary SV models with a vector kernel shard the SV axis; approx
    models the feature axis. Precomputed models hold a column gather, and
    multiclass directories are handled pair by pair by the engine."""
    if getattr(model, "models", None) is not None:
        return False
    if getattr(model, "is_approx", False):
        return True
    return model.kernel != "precomputed"


def _pad_rows(a: np.ndarray, n: int) -> np.ndarray:
    rem = (-a.shape[0]) % n
    if rem == 0:
        return a
    return np.pad(a, [(0, rem)] + [(0, 0)] * (a.ndim - 1))


def _pad_cols(a: np.ndarray, n: int) -> np.ndarray:
    rem = (-a.shape[1]) % n
    if rem == 0:
        return a
    return np.pad(a, ((0, 0), (0, rem)))


def _to(a: np.ndarray, dev, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)


class ShardedDecider:
    """``block -> decisions`` over ``devices`` (module docstring). Takes a
    (rows, d) float32 block (a tensor on any device, or an array) and
    returns the (rows,) decisions on the first device, the intercept
    applied per ``include_b``. ``devices`` None: every visible GPU."""

    def __init__(self, model, *, include_b: bool = True,
                 precision: str = "highest",
                 devices: Optional[Sequence] = None):
        if devices is None:
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        self.devices: List[torch.device] = [torch.device(d)
                                            for d in devices]
        self.n_shards = len(self.devices)
        if self.n_shards < 1:
            raise ValueError("ShardedDecider needs at least one device")
        self.include_b = bool(include_b)
        self.low = str(precision).lower() == "default"
        self.is_approx = bool(getattr(model, "is_approx", False))
        self.axis = "feature" if self.is_approx else "sv"
        self.resident_bytes_est = model_bytes_est(model)
        self._b = np.float32(getattr(model, "b", 0.0))
        self._host: List[tuple] = []    # each shard's arrays, host side
        if self.is_approx:
            self._build_approx(model)
        else:
            self._build_sv(model)
        # each shard's operands on its own device
        self._operands = [tuple(_to(a, dev) for a in arrs)
                          for arrs, dev in zip(self._host, self.devices)]
        self._lows = [self._low_of(ops) for ops in self._operands]

    # -- builders ------------------------------------------------------

    def _build_sv(self, model) -> None:
        n = self.n_shards
        x_sv = _pad_rows(np.asarray(model.x_sv, np.float32), n)
        coef = _pad_rows(np.asarray(model.alpha, np.float32)
                         * np.asarray(model.y_sv, np.float32), n)
        self.orig_len = int(model.n_sv)
        self.padded_len = int(x_sv.shape[0])
        c = self.padded_len // n
        self.spec = model.kernel_spec
        self._host = [(x_sv[k * c:(k + 1) * c], coef[k * c:(k + 1) * c])
                      for k in range(n)]
        self._partial = self._sv_partial

    def _build_approx(self, model) -> None:
        fmap = model.fmap
        n = self.n_shards
        w = np.asarray(model.w, np.float32)
        self.orig_len = int(fmap.dim)
        self.kind = fmap.kind
        if fmap.kind == "rff":
            # omega's dim/2 columns sharded; each shard's weights are its
            # [cos block | sin block], at the global scale
            d2 = int(fmap.omega.shape[1])
            omega = _pad_cols(np.asarray(fmap.omega, np.float32), n)
            d2p = int(omega.shape[1])
            self.padded_len = 2 * d2p
            w_cos, w_sin = _pad_rows(w[:d2], n), _pad_rows(w[d2:], n)
            c = d2p // n
            self.scale = float(np.float32(math.sqrt(2.0 / (2 * d2))))
            self._host = [(omega[:, k * c:(k + 1) * c].T,
                           np.concatenate([w_cos[k * c:(k + 1) * c],
                                           w_sin[k * c:(k + 1) * c]]))
                          for k in range(n)]
            self._partial = self._rff_partial
            return
        landmarks = np.asarray(fmap.landmarks, np.float32)
        proj = _pad_cols(np.asarray(fmap.proj, np.float32), n)
        w_pad = _pad_rows(w, n)
        self.padded_len = int(proj.shape[1])
        c = self.padded_len // n
        self.spec = fmap.kernel_spec
        self._host = [(landmarks, proj[:, k * c:(k + 1) * c].T.copy(),
                       w_pad[k * c:(k + 1) * c]) for k in range(n)]
        self._partial = self._nystrom_partial

    def _low_of(self, ops) -> Optional[torch.Tensor]:
        """The bfloat16 operand of the first product under
        ``precision="default"``."""
        return ops[0].to(torch.bfloat16) if self.low else None

    # -- the partial programs (one definition each: the spread run and
    # the reference call the same math at the same shapes) ------------

    def _dots(self, xb, rows, low):
        if low is not None:
            return dots_f32(xb.to(torch.bfloat16), low)
        return dots_f32(xb, rows)

    def _sv_partial(self, xb, ops, low):
        sv, coef = ops
        sv2 = row_norms_sq(sv)
        if low is not None:
            k = rows_from_dots(self._dots(xb, sv, low), row_norms_sq(xb),
                               sv2, self.spec)
        else:
            k = kernel_rows(xb, row_norms_sq(xb), sv, sv2, self.spec)
        return torch.matmul(k, coef)

    def _rff_partial(self, xb, ops, low):
        omega_t, w = ops
        z = self._dots(xb, omega_t, low)
        phi = torch.cat([torch.cos(z), torch.sin(z)], dim=1).mul_(self.scale)
        return torch.matmul(phi, w)

    def _nystrom_partial(self, xb, ops, low):
        landmarks, proj_t, w = ops
        k = rows_from_dots(self._dots(xb, landmarks, low), row_norms_sq(xb),
                           row_norms_sq(landmarks), self.spec)
        return torch.matmul(dots_f32(k, proj_t), w)

    # -- evaluation ----------------------------------------------------

    def _fold(self, xb, shards) -> torch.Tensor:
        """Partials of ``shards`` ((operands, low, device) each) added in
        order on the first device, then the intercept."""
        first = self.devices[0]
        acc = None
        with exact_f32():
            for ops, low, dev in shards:
                # row tiles, as every decision block computes
                p = row_tiles(lambda t: self._partial(t, ops, low),
                              xb.to(dev)).to(first)
                acc = p if acc is None else acc + p
        if self.include_b:
            acc = acc - torch.tensor(self._b, device=first)
        return acc

    def __call__(self, block) -> torch.Tensor:
        xb = (block if isinstance(block, torch.Tensor)
              else torch.from_numpy(np.ascontiguousarray(block,
                                                         np.float32)))
        return self._fold(xb.float(), zip(self._operands, self._lows,
                                          self.devices))

    decide = __call__

    def reference(self, block) -> torch.Tensor:
        """The same blocked decision on the first device alone: every
        shard's partial in device order, added in order."""
        first = self.devices[0]
        ops = [tuple(t.to(first) for t in o) for o in self._operands]
        lows = [self._low_of(o) for o in ops]
        xb = (block if isinstance(block, torch.Tensor)
              else torch.from_numpy(np.ascontiguousarray(block,
                                                         np.float32)))
        return self._fold(xb.float(), zip(ops, lows,
                                          [first] * self.n_shards))

    def device_bytes(self) -> int:
        ts = [t for o in self._operands for t in o]
        ts += [t for t in self._lows if t is not None]
        return int(sum(t.numel() * t.element_size() for t in ts))

    def facts(self) -> dict:
        return {
            "sharded": True,
            "shard_axis": self.axis,
            "shards": self.n_shards,
            "devices": [str(d) for d in self.devices],
            "padded_len": self.padded_len,
            "orig_len": self.orig_len,
            "resident_bytes_est": int(self.resident_bytes_est),
            "per_device_bytes_est":
                int(self.resident_bytes_est // self.n_shards),
        }

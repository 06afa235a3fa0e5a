"""Hardware-roofline accounting: achieved against peak, per phase (port
of ``dpsvm_tpu/observability/roofline.py``).

The trace's work counts (``est_flops``/``est_bytes`` per iteration,
recorded with the chunk program's first launch by
observability/compilewatch), its iteration count and wall seconds, over
a per-device peak table, give

* an **achieved fraction**: measured FLOP/s over the device's peak, and
  measured bytes/s over its peak memory rate;
* an **arithmetic-intensity verdict**: FLOPs per byte against the
  device's ridge point (peak FLOP/s over peak bandwidth): above it the
  program is compute-bound, below it memory-bound;
* a **per-phase split**: the host-loop phases that overlap device work
  (dispatch, poll) carry the verdict; host phases (checkpoint, hook)
  are labelled host-side.

**The peak table is a data sheet, not a measurement.** Its one row is
NVIDIA's H100 SXM data sheet, dense rates: 989 TFLOP/s bf16 on the
tensor cores, 67 TFLOP/s f32 outside them, 3.35 TB/s of HBM3. The JAX
package derives f32 as half its bf16 peak; that is wrong for this card,
so the row holds both, and every fraction names the one it used
(``peak_precision``). The port's hand-written kernels compute in f32
FMA (kernel A reads a bf16 X but accumulates in f32), so fractions use
the f32 peak unless a caller asks for bf16. A card may run below its
700 W maximum power limit, and then below these rates: whatever renders
a row prints the power limit the trace recorded beside it. The CPU and
unknown devices yield ``None``, and every consumer prints n/a.

**Work-count honesty**: the counts are the ones ``chip_smoke.py``'s
bound column uses (each input read once, each output written once), so
the bandwidth fraction reads as a share of the bytes bound.

Stdlib only: report and compare render on a machine with no card.
"""

from __future__ import annotations

from typing import Dict, List, Optional

#: Data-sheet peaks: (substring keys, canonical name, bf16 tensor-core
#: FLOP/s, f32 FLOP/s outside the tensor cores, memory bytes/s). Keys
#: match ``torch.cuda.get_device_name`` case-insensitively ("NVIDIA
#: H100 80GB HBM3"). The rates are NVIDIA's H100 SXM data sheet, dense.
PEAKS = (
    (("h100",), "NVIDIA H100 SXM (data-sheet spec)", 989e12, 67e12,
     3.35e12),
)

#: the source every row's numbers come from, printed with the row
PEAK_SOURCE = "NVIDIA data sheet, SXM, dense: a spec, not a measurement"

#: PhaseTimer phases that overlap device execution: the chunk program
#: runs while the host enqueues it (``dispatch``) and while the host
#: blocks on the poll's one stats read (``poll``; solver/driver.py).
#: Everything else is host-side work the roofline cannot attribute to
#: the card.
DEVICE_PHASES = ("dispatch", "poll", "measure", "compile+warmup")


def peaks_for(device_kind: Optional[str],
              precision: str = "f32") -> Optional[dict]:
    """The peak row for a device kind, or None for unrecognized hardware
    (the CPU included: an honest unknown). ``peak_flops`` is the
    ``precision`` peak ("f32" or "bf16"); both ride in the row."""
    if not device_kind:
        return None
    if precision not in ("f32", "bf16"):
        raise ValueError(f"precision must be 'f32' or 'bf16', got "
                         f"{precision!r}")
    low = str(device_kind).lower()
    for keys, name, bf16, f32, bw in PEAKS:
        if any(k in low for k in keys):
            flops = f32 if precision == "f32" else bf16
            return {"device": name, "source": PEAK_SOURCE,
                    "peak_precision": precision, "peak_flops": flops,
                    "peak_flops_bf16": bf16, "peak_flops_f32": f32,
                    "peak_hbm_Bps": bw,
                    "ridge_flops_per_byte": flops / bw}
    return None


def roofline_facts(*, est_flops: Optional[float],
                   est_bytes: Optional[float],
                   iters: Optional[float], seconds: Optional[float],
                   device_kind: Optional[str],
                   phases: Optional[Dict[str, float]] = None,
                   power_limit: Optional[str] = None,
                   precision: str = "f32") -> dict:
    """The roofline digest rendered by ``report`` and ``compare``.

    Always returns the full key set (presence is the contract, like
    the trace schema): unknown hardware or a missing work count yields
    nulls, never absent keys. ``power_limit`` is the card's limit as the
    run recorded it (``nvidia-smi``), printed beside the row."""
    peaks = peaks_for(device_kind, precision)
    out = {
        "device_kind": device_kind,
        "power_limit": power_limit,
        "peak_precision": peaks["peak_precision"] if peaks else None,
        "peaks": peaks,
        "achieved_flops_per_sec": None,
        "achieved_bytes_per_sec": None,
        "flops_fraction": None,
        "bandwidth_fraction": None,
        "arith_intensity": None,
        "verdict": None,
        "phases": {},
    }
    measurable = (est_flops and seconds and iters
                  and seconds > 0 and iters > 0)
    if measurable:
        out["achieved_flops_per_sec"] = est_flops * iters / seconds
    if est_bytes and seconds and iters and seconds > 0 and iters > 0:
        out["achieved_bytes_per_sec"] = est_bytes * iters / seconds
    if est_flops and est_bytes:
        out["arith_intensity"] = est_flops / est_bytes
    if peaks is not None:
        if out["achieved_flops_per_sec"] is not None:
            out["flops_fraction"] = (out["achieved_flops_per_sec"]
                                     / peaks["peak_flops"])
        if out["achieved_bytes_per_sec"] is not None:
            out["bandwidth_fraction"] = (out["achieved_bytes_per_sec"]
                                         / peaks["peak_hbm_Bps"])
        if out["arith_intensity"] is not None:
            out["verdict"] = (
                "compute-bound"
                if out["arith_intensity"]
                >= peaks["ridge_flops_per_byte"]
                else "memory-bound")
    # Per-phase split: device-overlapped phases inherit the kernel's
    # verdict (the chunk program IS what runs during them); host
    # phases are the roofline's blind spot and say so.
    total = sum((phases or {}).values())
    for name, sec in sorted((phases or {}).items(),
                            key=lambda kv: -kv[1]):
        device = name in DEVICE_PHASES
        out["phases"][name] = {
            "seconds": round(float(sec), 6),
            "share": round(sec / total, 4) if total > 0 else None,
            "kind": "device" if device else "host",
            "verdict": (out["verdict"] if device else "host-side"),
        }
    return out


def _fmt_flops(v: float) -> str:
    for unit in ("", "K", "M", "G", "T", "P"):
        if abs(v) < 1000 or unit == "P":
            return f"{v:,.1f} {unit}FLOP/s"
        v /= 1000
    return f"{v:,.1f} PFLOP/s"


def _fmt_bw(v: float) -> str:
    return f"{v / 1e9:,.1f} GB/s"


def render_roofline(rf: dict) -> List[str]:
    """The human lines ``report`` prints under "roofline:"."""
    peaks = rf.get("peaks")
    if peaks is None:
        return [f"roofline: n/a (no peak table for device kind "
                f"{rf.get('device_kind')!r}: fractions need a known "
                "denominator)"]
    power = rf.get("power_limit") or "power limit not recorded"
    prec = peaks["peak_precision"]
    out = [f"roofline: {peaks['device']}: "
           f"{_fmt_flops(peaks['peak_flops_f32'])} f32 (no tensor cores), "
           f"{_fmt_flops(peaks['peak_flops_bf16'])} bf16 tensor, "
           f"{_fmt_bw(peaks['peak_hbm_Bps'])} HBM3; {peaks['source']}; "
           f"this card: {power}",
           f"roofline: fractions against the {prec} peak, ridge "
           f"{peaks['ridge_flops_per_byte']:,.1f} FLOP/B"]
    if rf.get("flops_fraction") is not None:
        out.append(
            f"roofline: achieved "
            f"{_fmt_flops(rf['achieved_flops_per_sec'])} = "
            f"{rf['flops_fraction']:.1%} of the {prec} peak"
            + (f"; {_fmt_bw(rf['achieved_bytes_per_sec'])} = "
               f"{rf['bandwidth_fraction']:.1%} of HBM bandwidth"
               if rf.get("bandwidth_fraction") is not None else ""))
    else:
        out.append("roofline: achieved fraction n/a (no work count or "
                   "no measured window)")
    if rf.get("verdict") is not None:
        out.append(
            f"roofline: arithmetic intensity "
            f"{rf['arith_intensity']:,.1f} FLOP/B -> {rf['verdict']} "
            f"(ridge {peaks['ridge_flops_per_byte']:,.1f})")
    for name, p in rf.get("phases", {}).items():
        share = (f"{p['share']:.0%}" if p["share"] is not None
                 else "n/a")
        out.append(f"roofline:   {name:<14} {p['seconds']:8.3f} s "
                   f"{share:>5}  [{p['verdict']}]")
    return out


def doctor_lines(device_kinds) -> List[str]:
    """The peak-table printout: the roofline denominators for every
    visible device kind, with an honest `unknown` for unrecognized
    hardware instead of a silent n/a later in report."""
    out: List[str] = []
    seen = []
    for kind in device_kinds or [None]:
        if kind in seen:
            continue
        seen.append(kind)
        peaks = peaks_for(kind)
        if peaks is None:
            out.append(f"{kind!r}: unknown device kind — no peak "
                       "table entry; `report` will render roofline "
                       "fractions as n/a")
        else:
            out.append(
                f"{kind!r} -> {peaks['device']}: "
                f"{_fmt_flops(peaks['peak_flops_f32'])} f32, "
                f"{_fmt_flops(peaks['peak_flops_bf16'])} bf16 tensor, "
                f"{_fmt_bw(peaks['peak_hbm_Bps'])} HBM3 "
                f"({peaks['source']})")
    return out


def fraction(*, est_flops: Optional[float], iters: Optional[float],
             seconds: Optional[float], device_kind: Optional[str],
             precision: str = "f32") -> Optional[float]:
    """The one-number ledger column (``roofline_fraction``): achieved over
    the ``precision`` peak FLOP/s, or None when either side is unknown
    (CPU rows never gate on a made-up denominator)."""
    rf = roofline_facts(est_flops=est_flops, est_bytes=None,
                        iters=iters, seconds=seconds,
                        device_kind=device_kind, precision=precision)
    f = rf["flops_fraction"]
    return round(f, 6) if f is not None else None

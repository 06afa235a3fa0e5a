"""Microseconds of device idle time a poll: the wall of the program's
``train.loop`` spans in the profiled fit less the union of the kernels,
copies and sets inside them (as ``device_idle_pct`` reckons idle), over
the ``poll`` spans inside them."""

from svmbench.trace import _clip, _union_s


def read(ctx):
    tr = ctx.trace
    if tr is None or ctx.cell.kind != "fit":
        return None
    idle_s, polls = 0.0, 0
    for name, t0, dur in tr.host:
        if name != "train.loop":
            continue
        t1 = t0 + dur
        idle_s += dur / 1e6 - _union_s(_clip(tr.kernels + tr.copies,
                                             t0, t1))
        polls += sum(n == "poll" and ts >= t0 and ts + d <= t1
                     for n, ts, d in tr.host)
    return 1e6 * idle_s / polls if polls else None

"""Share of the profiled fit's wall, in %, in which the device ran no
kernel, copy or set (the union of their intervals from the trace)."""


def read(ctx):
    if ctx.trace is None or ctx.cell.kind != "fit":
        return None
    return ctx.trace.idle_pct()

"""Milliseconds of host-to-device copies a thousand rows scored: the
device time of the ``HtoD`` copies in the profiled slice over the rows
the slice's jobs scored."""


def read(ctx):
    cell, tr = ctx.cell, ctx.trace
    if tr is None or cell.kind != "score":
        return None
    rows = cell.slice_rows()
    secs = tr.copy_s("HtoD")
    if rows <= 0 or secs is None:
        return None
    return 1e3 * secs / (rows / 1e3)

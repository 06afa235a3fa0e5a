"""Host milliseconds of the engine's copy up a thousand rows scored: the
summed ``engine.upload`` spans of the profiled slice over the rows the
slice's jobs scored. Beside ``engine_h2d_ms_per_krow`` (the copy's
device time), the host's price of the copy."""


def read(ctx):
    cell, tr = ctx.cell, ctx.trace
    if tr is None or cell.kind != "score":
        return None
    us = [dur for name, _, dur in tr.host if name == "engine.upload"]
    rows = cell.slice_rows()
    if not us or rows <= 0:
        return None
    return sum(us) / 1e3 / (rows / 1e3)

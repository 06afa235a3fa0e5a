"""Milliseconds of the engine's host padding a thousand rows scored: the
summed ``engine.pad`` spans of the profiled slice (the padded block's
allocation and fill) over the rows the slice's jobs scored."""


def read(ctx):
    cell, tr = ctx.cell, ctx.trace
    if tr is None or cell.kind != "score":
        return None
    us = [dur for name, _, dur in tr.host if name == "engine.pad"]
    rows = cell.slice_rows()
    if not us or rows <= 0:
        return None
    return sum(us) / 1e3 / (rows / 1e3)

"""The whole scoring job's share of the chip's peak, in %: the least time
of the rows scored in the profiled slice (``roofline.score_bound_s``) over
the slice's wall."""


def read(ctx):
    cell, tr = ctx.cell, ctx.trace
    if tr is None or cell.kind != "score" or tr.window_s <= 0:
        return None
    least = cell.slice_least_s()
    return 100.0 * least / tr.window_s if least > 0 else None

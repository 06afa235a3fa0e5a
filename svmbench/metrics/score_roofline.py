"""The serving engine's share of its roofline, in %: the least time of the
rows scored in the profiled slice (``roofline.score_bound_s`` a job: 2
n_sv d operations a row at the float32 peak, or the bytes read once at
the HBM peak) over the device's kernel time in the slice. Padding rows of
the engine's buckets are not counted, so the share errs low."""


def read(ctx):
    cell, tr = ctx.cell, ctx.trace
    if tr is None or cell.kind != "score":
        return None
    secs = tr.kernel_s()
    least = cell.slice_least_s()
    return 100.0 * least / secs if secs > 0 and least > 0 else None

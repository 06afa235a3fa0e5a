"""Solver updates a second: the fits' summed ``TrainResult.n_iter`` over
their summed ``train_seconds`` (the program's own counters), over the
window's fits outside the profiler where it has any, else over all."""


def read(ctx):
    if ctx.cell.kind != "fit" or not ctx.cell.fits:
        return None
    fits = ctx.cell.fits
    use = [f for f in fits if not f.profiled] or fits
    secs = sum(f.train_seconds for f in use)
    return sum(f.n_iter for f in use) / secs if secs > 0 else None

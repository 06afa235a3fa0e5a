"""Kernel A's device time per iteration, in microseconds: the device time
of ``fused_iter_kernel`` in the profiled fit over the iterations it ran."""


def read(ctx):
    cell, tr = ctx.cell, ctx.trace
    if tr is None or cell.kind != "fit":
        return None
    iters = sum(f.n_iter for f in cell.fits if f.profiled)
    secs = tr.kernel_s("fused_iter_kernel")
    if iters <= 0 or secs <= 0:
        return None
    return 1e6 * secs / iters

"""Kernel A's share of its roofline, in %: the least time of one iteration
(``roofline.kernel_a_bound_s``: its bytes at the HBM peak or its
operations at the float32 peak, whichever is larger) over the device time
of ``fused_iter_kernel`` in the profiled fit, per iteration the fit ran
(launches that exit early, after convergence, count in the time)."""

from svmbench import roofline


def read(ctx):
    cell, tr = ctx.cell, ctx.trace
    if tr is None or cell.kind != "fit":
        return None
    iters = sum(f.n_iter for f in cell.fits if f.profiled)
    secs = tr.kernel_s("fused_iter_kernel")
    if iters <= 0 or secs <= 0:
        return None
    n, d = cell.x.shape
    return 100.0 * roofline.kernel_a_bound_s(n, d, cell.el) * iters / secs

"""The whole fit's share of the chip's peak, in %: the fits' iterations
times kernel A's least time an iteration (``roofline.kernel_a_bound_s``)
over the fits' wall (host arrays in, model out), over the window's fits
outside the profiler where it has any. It bounds the fit whatever kernel
runs the iterations."""

from svmbench import roofline


def read(ctx):
    cell = ctx.cell
    if cell.kind != "fit" or not cell.fits:
        return None
    use = [f for f in cell.fits if not f.profiled] or cell.fits
    wall = sum(f.wall for f in use)
    n, d = cell.x.shape
    least = roofline.kernel_a_bound_s(n, d, cell.el) * sum(
        f.n_iter for f in use)
    return 100.0 * least / wall if wall > 0 else None

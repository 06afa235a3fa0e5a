"""Milliseconds from the start of the program's ``fit`` span to the start
of its ``train.loop`` span in the profiled fit: validation, X's copy up,
the first selection and the solver loop's set-up."""


def read(ctx):
    tr = ctx.trace
    if tr is None or ctx.cell.kind != "fit":
        return None
    fit = [ts for name, ts, _ in tr.host if name == "fit"]
    loop = [ts for name, ts, _ in tr.host if name == "train.loop"]
    if not fit or not loop:
        return None
    return (min(loop) - min(fit)) / 1e3

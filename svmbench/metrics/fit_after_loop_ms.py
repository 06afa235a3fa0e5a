"""Milliseconds from the end of the program's ``train.loop`` span to the
end of its ``fit`` span in the profiled fit: alpha's read back and the
SV compaction."""


def read(ctx):
    tr = ctx.trace
    if tr is None or ctx.cell.kind != "fit":
        return None
    fit = [ts + dur for name, ts, dur in tr.host if name == "fit"]
    loop = [ts + dur for name, ts, dur in tr.host if name == "train.loop"]
    if not fit or not loop:
        return None
    return (max(fit) - max(loop)) / 1e3

"""Device milliseconds per traced pair in operations the port did not
write (PyTorch's elementwise ops and copies, cuFFT), by kernel name
(``devtrace.op_class``), NCCL's left out; the largest over the ranks."""

from h100bench.devtrace import op_class

REDUCE = "max"


def read(ctx):
    ops = ctx.timeline.pair_ops()
    if not ops:
        return None
    us = sum(o.dur for o in ops if op_class(o) == "library")
    return us / 1e3 / ctx.timeline.pairs

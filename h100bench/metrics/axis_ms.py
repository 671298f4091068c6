"""Device milliseconds per traced pair whose innermost program span is
an ``fft_axis[<route>]`` span (one axis pass: the strided and row
kernels, the two-level passes, a fallback's library ops), both
directions; the largest over the ranks. An untangle's inner C2C counts
here, not in ``untangle_ms``. None where no such span launched work."""

REDUCE = "max"


def read(ctx):
    ops = [o for o in ctx.timeline.pair_ops()
           if o.spans and o.spans[-1].startswith("fft_axis[")]
    if not ops:
        return None
    return sum(o.dur for o in ops) / 1e3 / ctx.timeline.pairs

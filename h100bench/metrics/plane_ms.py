"""Device milliseconds per traced pair whose innermost program span is
``fft_plane`` (the plane kernel over the trailing two axes, both
directions); the largest over the ranks. None where no such span
launched work."""

REDUCE = "max"


def read(ctx):
    ops = [o for o in ctx.timeline.pair_ops()
           if o.spans and o.spans[-1] == "fft_plane"]
    if not ops:
        return None
    return sum(o.dur for o in ops) / 1e3 / ctx.timeline.pairs

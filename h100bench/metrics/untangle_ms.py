"""Device milliseconds per traced pair whose innermost program span is
``r2c_untangle`` or ``c2r_untangle`` (the real transform's packing,
flip, conjugate, twiddle product and copies, its inner C2C left out);
the largest over the ranks. None where no such span launched work."""

REDUCE = "max"
SPANS = ("r2c_untangle", "c2r_untangle")


def read(ctx):
    ops = [o for o in ctx.timeline.pair_ops()
           if o.spans and o.spans[-1] in SPANS]
    if not ops:
        return None
    return sum(o.dur for o in ops) / 1e3 / ctx.timeline.pairs

"""Device milliseconds per traced pair whose innermost program span is
``a2a_pack`` or ``a2a_unpack`` (the all-to-all's stack before the
collective and concatenation after it, NCCL's kernels left out), both
directions; the largest over the ranks. None where no such span
launched work."""

REDUCE = "max"
SPANS = ("a2a_pack", "a2a_unpack")


def read(ctx):
    ops = [o for o in ctx.timeline.pair_ops()
           if o.spans and o.spans[-1] in SPANS]
    if not ops:
        return None
    return sum(o.dur for o in ops) / 1e3 / ctx.timeline.pairs

"""The least time one rank's share of a pair could take (the larger of
its bytes, each transform's input read once and output written once,
over the card's published bandwidth, and its flops over its float32
peak: ``yardstick.pair_least_seconds``) over the device time per traced
pair of every kernel and copy but NCCL's; the smallest over the ranks.
None on a card with no published peaks or with no device record."""

from h100bench.devtrace import op_class

REDUCE = "min"


def read(ctx):
    ops = ctx.timeline.pair_ops()
    if not ops or ctx.least_pair_s is None:
        return None
    us = sum(o.dur for o in ops if op_class(o) != "nccl")
    return 100.0 * ctx.least_pair_s / (us / 1e6 / ctx.timeline.pairs)

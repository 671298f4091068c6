"""Device milliseconds per traced pair under the program's ``t2``
exchange spans (``t2_exchange_*``; NCCL's all-to-all and the copies
around it), both directions; the largest over the ranks. None where no
such span launched work."""

from h100bench.devtrace import stage_key

REDUCE = "max"
STAGE = "t2"


def read(ctx):
    ops = [o for o in ctx.timeline.pair_ops()
           if any(stage_key(s) == STAGE for s in o.spans)]
    if not ops:
        return None
    return sum(o.dur for o in ops) / 1e3 / ctx.timeline.pairs

"""Device milliseconds per traced pair under the program's ``t0`` spans
(the forward's ``t0_fft_yz`` and the backward's first local stage); the
largest over the ranks. None where no such span launched work."""

from h100bench.devtrace import stage_key

REDUCE = "max"
STAGE = "t0"


def read(ctx):
    ops = [o for o in ctx.timeline.pair_ops()
           if any(stage_key(s) == STAGE for s in o.spans)]
    if not ops:
        return None
    return sum(o.dur for o in ops) / 1e3 / ctx.timeline.pairs

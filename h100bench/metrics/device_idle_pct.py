"""Share of the traced window (from the traced pairs' first device
operation to their last) in which no kernel or copy ran on the card;
the largest over the ranks."""

REDUCE = "max"


def read(ctx):
    win = ctx.timeline.window()
    if win is None:
        return None
    lo, hi = win
    return 100.0 * (1.0 - ctx.timeline.busy() / (hi - lo))

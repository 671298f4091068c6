"""The 95th percentile over every pair of the window of one pair's time,
by CUDA events recorded on the stream between pairs (on several ranks
the largest over the ranks for the same pair). None off the card."""

from h100bench.yardstick import percentile


def read(ctx):
    if not ctx.pair_s:
        return None
    return percentile(ctx.pair_s, 95) * 1e3

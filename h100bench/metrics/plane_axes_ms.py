"""Device milliseconds per traced pair under the program's
``fft_plane[per_axis]`` spans at any depth (the two trailing-axis passes
of a plane past the plane gate, run per axis, both directions); the
largest over the ranks. The leading axis's pass is then ``axis_ms`` less
this. None where no such span launched work."""

REDUCE = "max"
SPAN = "fft_plane[per_axis]"


def read(ctx):
    ops = [o for o in ctx.timeline.pair_ops() if SPAN in o.spans]
    if not ops:
        return None
    return sum(o.dur for o in ops) / 1e3 / ctx.timeline.pairs

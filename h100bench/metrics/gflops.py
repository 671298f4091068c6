"""GFlop/s of the window: the flops of every transform completed in it
(5 N log2 N for a complex transform, 2.5 N log2 N for a real one, N the
global grid points: the traffic file's ``flops_factor``) over its host
seconds, from before the first pair to after the last one finished; on
several ranks the longest rank's window."""


def read(ctx):
    return ctx.transforms * ctx.flops_per_transform / ctx.window_s / 1e9

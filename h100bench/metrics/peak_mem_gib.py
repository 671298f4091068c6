"""GiB of the caching allocator's peak (``max_memory_allocated``) over
set-up and the window, the largest over the ranks: the program's working
set for back-to-back pairs with the input box. The window's peak is read
less the outputs the check keeps beyond their pair (every kept pair but
the last), so the harness's own buffers do not count. None off the
card."""


def read(ctx):
    if ctx.peak_bytes is None:
        return None
    return ctx.peak_bytes / 2 ** 30

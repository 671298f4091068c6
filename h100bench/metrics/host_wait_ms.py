"""Device idle milliseconds per traced pair that the host's waits cost:
after each of the program's ``host_wait[<site>]`` spans inside a pair's
span (each around a step that blocks the host until the card drains),
the gap from the end of the last device operation launched before the
span ended to the start of the first one launched after it, the card
idle while the host, released, enqueues again; the largest over the
ranks. Not the host's time in the span, which is its lead over the card
and falls when the host gets slower. 0 where the program opens its pass
spans (``fft_plane``, ``fft_axis[<route>]``) on the card and no wait;
None where it opens none (a program without them) or no operation ran on
the card."""

from h100bench.devtrace import PAIR_SPAN

REDUCE = "max"
PROBE = ("fft_plane", "fft_axis[")


def read(ctx):
    tl = ctx.timeline
    ops = [o for o in tl.pair_ops() if o.launch is not None]
    if not any(s.startswith(PROBE) for o in ops for s in o.spans):
        return None
    pairs = [(a, b) for a, b, n in tl.host_ops if n == PAIR_SPAN]
    idle = 0.0
    for a, b, n in tl.host_ops:
        if not n.startswith("host_wait[") or not any(
                lo <= a and b <= hi for lo, hi in pairs):
            continue
        drained = [o.ts + o.dur for o in ops if o.launch <= b]
        after = [o.ts for o in ops if o.launch > b]
        if drained and after:
            idle += max(0.0, min(after) - max(drained))
    return idle / 1e3 / tl.pairs

"""Host milliseconds per pair from the forward call's start to the
backward call's return, each pair issued on an idle card with no
synchronisation inside it: the cost of enqueuing a pair. The mean over
``bench.HOST_PAIRS`` pairs; the largest over the ranks."""

REDUCE = "max"


def read(ctx):
    if not ctx.host_call_s:
        return None
    return 1e3 * sum(ctx.host_call_s) / len(ctx.host_call_s)

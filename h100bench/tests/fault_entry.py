"""Rank functions that break the timed path underneath a spawned run,
for the fault tests."""

import torch.distributed as dist

from h100bench import bench


class _Done:
    def wait(self):
        return True

    def is_completed(self):
        return True


def _no_exchange(out, inp, *args, async_op=False, **kw):
    out.copy_(inp)   # every rank keeps its own blocks
    return _Done() if async_op else None


def exchange_left_out(rank, size, cell, spec, init, out):
    """A rank whose all-to-all sends nothing between the ranks."""
    dist.all_to_all_single = _no_exchange
    bench.rank_entry(rank, size, cell, spec, init, out)

"""A run whose timed path is broken underneath comes out not correct:
one fault at a time, the rest of the run as it is (the look for a card
skipped by ``--cpu``, at a tiny size)."""

import pytest

from h100bench import bench, run
from helpers import last_json, tiny_root


class Broken:
    """A plan whose call is replaced, every other attribute the plan's."""

    def __init__(self, plan, call):
        self._plan, self._call = plan, call

    def __getattr__(self, name):
        return getattr(self._plan, name)

    def __call__(self, x):
        return self._call(self._plan, x)


def unchanged(plan, x):
    """A step that returns its input unchanged (a constant where the
    output's type differs from the input's)."""
    return x.clone() if plan.in_dtype == plan.out_dtype else \
        plan(x) * 0 + 1


def half_left_out(plan, x):
    """Half of the field left out, the rest scaled to stand for it."""
    h = x.clone()
    h[h.shape[0] // 2:] = 0
    return plan(h) * 2


def answer_altered(plan, x):
    """One value of the answer altered where it is produced."""
    y = plan(x).clone()
    y.view(-1)[1] = -y.view(-1)[1]
    return y


FAULTS = {"unchanged": unchanged, "half_left_out": half_left_out,
          "answer_altered": answer_altered}


@pytest.mark.parametrize("side", ["forward", "backward"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", ["grid512_1card.c2c", "grid512_1card.r2c"])
def test_one_rank_fault(tmp_path, capsys, monkeypatch, cell, fault, side):
    make = bench.make_plans

    def broken_plans(*args, **kw):
        fwd, bwd = make(*args, **kw)
        if side == "forward":
            return Broken(fwd, FAULTS[fault]), bwd
        return fwd, Broken(bwd, FAULTS[fault])

    monkeypatch.setattr(bench, "make_plans", broken_plans)
    rc = run.main(["--workload", cell, "--seed", "77", "--seconds", "0.2",
                   "--cpu", "--root", str(tiny_root(tmp_path))])
    out, err = capsys.readouterr()
    assert rc == 0, err
    line = last_json(out)
    assert line["correct"] is False and line["failed"] > 0
    over = [k for k, c in line["checks"].items() if c["value"] > c["limit"]]
    assert over


def test_four_ranks_exchange_left_out(tmp_path, capsys):
    from fault_entry import exchange_left_out

    rc = run.main(["--workload", "grid512_slab4.c2c", "--seed", "78",
                   "--seconds", "0.2", "--cpu", "--root",
                   str(tiny_root(tmp_path))], entry=exchange_left_out)
    out, err = capsys.readouterr()
    assert rc == 0, err
    line = last_json(out)
    assert line["correct"] is False
    assert line["checks"]["fwd_err"]["value"] > \
        line["checks"]["fwd_err"]["limit"]

"""The readers of the program's pass spans (``plane_ms``, ``axis_ms``,
``untangle_ms``, ``a2a_copy_ms``, ``host_wait_ms``) on hand-made
timelines: an operation counts under its innermost span alone, a reader
gives None where no such span launched work, and a host wait counts, only
inside a traced pair, the card's idle time from its drain to the next
operation."""

import importlib.util
from types import SimpleNamespace

import pytest

from h100bench.devtrace import PAIR_SPAN, Op, Timeline
from helpers import REPO

READERS = ("plane_ms", "axis_ms", "untangle_ms", "a2a_copy_ms",
           "host_wait_ms")


def _reader(name):
    path = REPO / "h100bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"reader_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _read(name, tl):
    return _reader(name).read(SimpleNamespace(timeline=tl))


def _op(dur, *spans, pair=0, ts=0.0, launch=0.0):
    return Op("k", "kernel", float(ts), float(dur), pair, tuple(spans),
              float(launch))


def _r2c_pair_ops():
    """One R2C-like pair: passes outside and inside the untangles, an
    untangle's own ops, a twiddle upload under its host wait."""
    return [
        _op(100, "execute_r2c_single", "r2c_untangle", "fft_axis[radix]"),
        _op(300, "execute_r2c_single", "r2c_untangle"),
        _op(7, "execute_r2c_single", "r2c_untangle",
            "host_wait[rfft_twiddle]"),
        _op(200, "execute_r2c_single", "fft_axis[radix]"),
        _op(50, "execute_c2r_single", "c2r_untangle"),
        _op(100, "execute_c2r_single", "c2r_untangle", "fft_axis[radix]"),
    ]


def test_innermost_span_takes_the_time():
    tl = Timeline(_r2c_pair_ops(), 1, [])
    # the untangles' inner C2C counts in axis_ms, not in untangle_ms
    assert _read("axis_ms", tl) == pytest.approx(0.4)
    assert _read("untangle_ms", tl) == pytest.approx(0.35)
    assert _read("plane_ms", tl) is None
    assert _read("a2a_copy_ms", tl) is None


def test_per_pair_and_outside_pairs():
    ops = [_op(400, "execute_c2c_single", "fft_plane", pair=p)
           for p in (0, 1)]
    ops += [_op(600, "execute_c2c_single", "fft_axis[radix2]", pair=p)
            for p in (0, 1)]
    ops.append(_op(999, "fft_plane", pair=None))     # a pad, no pair
    tl = Timeline(ops, 2, [])
    assert _read("plane_ms", tl) == pytest.approx(0.4)
    assert _read("axis_ms", tl) == pytest.approx(0.6)


def test_exchange_copies_leave_nccl_out():
    ops = [_op(300, "execute_c2c_slab", "t2_exchange_slab", "a2a_pack"),
           _op(1500, "execute_c2c_slab", "t2_exchange_slab"),  # NCCL
           _op(400, "execute_c2c_slab", "t2_exchange_slab", "a2a_unpack"),
           _op(500, "execute_c2c_slab", "t0_fft_yz", "fft_plane")]
    tl = Timeline(ops, 1, [])
    assert _read("a2a_copy_ms", tl) == pytest.approx(0.7)
    assert _read("plane_ms", tl) == pytest.approx(0.5)


def test_none_without_the_program_spans():
    """A program that opens only its stage and call spans (or no device
    operation at all) gives no reading of any of the five."""
    ops = [_op(100, "execute_c2c_slab", "t0_fft_yz"),
           _op(200, "execute_c2c_slab", "t2_exchange_slab"),
           _op(300, "execute_r2c_single")]
    for tl in (Timeline(ops, 1, [(0.0, 10.0, PAIR_SPAN)]),
               Timeline([], 1, [(0.0, 10.0, PAIR_SPAN),
                                (1.0, 2.0, "host_wait[rfft_twiddle]")])):
        assert {name: _read(name, tl) for name in READERS} == \
            dict.fromkeys(READERS)


def test_host_waits_inside_pairs_only():
    """Each wait inside a pair costs the gap from the end of the work
    launched before it ended to the start of the next operation; a wait
    outside every pair, and the host's time in a wait, count nothing."""
    ops = [  # pair 0: a wait from 100 to 400 us, the card drained at 380
        _op(300, "execute_r2c_single", "fft_axis[radix]", ts=50,
            launch=10),
        _op(30, "execute_r2c_single", "r2c_untangle",
            "host_wait[rfft_twiddle]", ts=350, launch=120),
        _op(200, "execute_r2c_single", "r2c_untangle", ts=520, launch=450),
        # pair 1: a wait from 2100 to 2200, the card drained at 2150
        _op(100, "execute_r2c_single", "fft_axis[radix]", ts=2050,
            launch=2010, pair=1),
        _op(100, "execute_r2c_single", "r2c_untangle", ts=2350,
            launch=2300, pair=1)]
    host = [(0.0, 1000.0, PAIR_SPAN),
            (100.0, 400.0, "host_wait[rfft_twiddle]"),
            (2000.0, 3000.0, PAIR_SPAN),
            (2100.0, 2200.0, "host_wait[rfft_twiddle]"),
            (2300.0, 2900.0, "aten::copy_"),
            # before the first pair: warm-up, not counted
            (-500.0, -100.0, "host_wait[rfft_twiddle]")]
    tl = Timeline(ops, 2, host)
    assert _read("host_wait_ms", tl) == \
        pytest.approx(((520 - 380) + (2350 - 2150)) / 1e3 / 2)


def test_no_host_wait_reads_zero():
    ops = [_op(400, "execute_c2c_single", "fft_plane")]
    tl = Timeline(ops, 1, [(0.0, 1000.0, PAIR_SPAN)])
    assert _read("host_wait_ms", tl) == 0.0

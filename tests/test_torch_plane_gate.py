"""The trailing plane past the plane gate (``cuda_fft.eligible2d``: at
most 524288 elements, the JAX package's gate, kept by the port).

On the CPU (the kernels' plain versions), the single C2C plan on
``executor="cuda"``: a [2, 1024, 1024] field, its 1024 x 1024 planes past
the gate, runs per axis, agrees with the benchmark's blocked float64
reference (``h100bench/references/fft3d_blocked.py``) both ways, counts
``FALLBACKS[(2, "plane2d")]`` once a call and opens one
``fft_plane[per_axis]`` around its two trailing-axis passes, the leading
axis (2 < 64: ``dft_matmul``) outside it. A plane exactly at the gate,
[512, 1024], still takes ``fft_plane`` and opens no per-axis span."""

import importlib.util
import weakref
from pathlib import Path

import pytest
import torch

import distributedfft_tpu_torch as tdfft
from distributedfft_tpu_torch import testing
from distributedfft_tpu_torch.ops import cuda_fft
from distributedfft_tpu_torch.utils import trace as ttr

REF = (Path(__file__).resolve().parents[1] / "h100bench" / "references"
       / "fft3d_blocked.py")
PAST = (2, 1024, 1024)
AT = (2, 512, 1024)
SPAN = "fft_plane[per_axis]"


def _reference():
    spec = importlib.util.spec_from_file_location("fft3d_blocked", REF)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _field(shape, seed=29):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, dtype=torch.complex64, generator=g)


def _plans(shape, **kw):
    kw = dict(executor="cuda", device="cpu", **kw)
    return (tdfft.plan_dft_c2c_3d(shape, None, direction=tdfft.FORWARD, **kw),
            tdfft.plan_dft_c2c_3d(shape, None, direction=tdfft.BACKWARD,
                                  **kw))


def _gap(got, want):
    """The check's number: the widest gap over the reference's rms."""
    rms = float(want.abs().pow(2).mean().sqrt())
    return float((got - want).abs().max()) / rms


def _call(plan, x):
    """(output, spans, plane2d fallbacks) of one plan call."""
    before = cuda_fft.FALLBACKS[(2, "plane2d")]
    with ttr.capture_events() as ev:
        y = plan(x)
    return y, list(ev), cuda_fft.FALLBACKS[(2, "plane2d")] - before


def _inside(a, b) -> bool:
    return b[1] <= a[1] and a[2] <= b[2]


def test_past_the_gate_agrees_with_the_blocked_reference():
    ref = _reference()
    fwd, bwd = _plans(PAST)
    x = _field(PAST)
    y, _, _ = _call(fwd, x)
    # blocks smaller than the axes: 1 plane, then 1 row along axis 1
    spec = ref.forward(x, "c2c", block=1)
    assert _gap(y, spec) < 2e-6
    z, _, _ = _call(bwd, y)
    assert _gap(z, ref.backward(y, "c2c", PAST, block=1)) < 2e-6
    assert _gap(z, x) < 2e-6


@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_past_the_gate_runs_per_axis_under_one_span(direction):
    fwd, bwd = _plans(PAST)
    plan = fwd if direction == "forward" else bwd
    _, ev, fallbacks = _call(plan, _field(PAST))
    assert fallbacks == 1
    outer = [e for e in ev if e[0] == SPAN]
    assert len(outer) == 1 and testing.pass_span(SPAN)
    held = [e[0] for e in ev if e is not outer[0] and _inside(e, outer[0])]
    assert held == ["fft_axis[radix]", "fft_axis[radix]"]
    # the leading axis (length 2) runs before the span, outside it
    lead = [e for e in ev if e[0] == "fft_axis[fallback]"]
    assert len(lead) == 1 and lead[0][2] <= outer[0][1]
    assert "fft_plane" not in {e[0] for e in ev}


def test_past_the_gate_frees_each_pass_input(monkeypatch):
    """When a pass runs, no output of an earlier pass but its own input
    is still held: on the card at 1024^3 each held one is 8 GiB more of
    the working set."""
    fwd, _ = _plans(PAST)
    x = _field(PAST, seed=11)
    outs, held = [], []
    run = cuda_fft.fft_along_axis

    def spy(t, axis, forward=True):
        held.append(sum(r() is not None for r in outs[:-1]))
        y = run(t, axis, forward)
        outs.append(weakref.ref(y))
        return y

    monkeypatch.setattr(cuda_fft, "fft_along_axis", spy)
    fwd(x)
    assert held == [0, 0, 0]


def test_donated_past_the_gate_gives_the_same_bits():
    fwd, _ = _plans(PAST)
    don, _ = _plans(PAST, donate=True)
    x = _field(PAST, seed=31)
    y, ev, fallbacks = _call(don, x.clone())
    assert torch.equal(y, fwd(x))
    assert fallbacks == 1 and [e[0] for e in ev].count(SPAN) == 1


def test_at_the_gate_takes_the_plane_kernel():
    ref = _reference()
    fwd, bwd = _plans(AT)
    x = _field(AT, seed=7)
    y, ev, fallbacks = _call(fwd, x)
    names = [e[0] for e in ev]
    assert fallbacks == 0 and SPAN not in names
    assert names.count("fft_plane") == 1
    assert _gap(y, ref.forward(x, "c2c")) < 2e-6
    z, ev, _ = _call(bwd, y)
    assert SPAN not in [e[0] for e in ev]
    assert _gap(z, x) < 2e-6

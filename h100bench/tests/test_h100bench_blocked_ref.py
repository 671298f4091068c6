"""The blocked float64 reference (``references/fft3d_blocked.py``) and
the reader of the per-axis plane span (``metrics/plane_axes_ms.py``),
with a tiny rehearsal of the cell that uses both.

The reference agrees with ``fft3d.py``'s whole-array transforms within
the one rounding to complex64 it adds, at odd and even shapes and with
blocks smaller than the axes; ``plane_axes_ms`` counts the device time
under ``fft_plane[per_axis]`` at any depth, and gives None where no such
span launched work (every cell whose planes are under the gate, and a
program that opens no such span)."""

import importlib.util
import json
from types import SimpleNamespace

import pytest
import torch

from h100bench import bench, control, run
from h100bench.devtrace import Op, Timeline
from helpers import REPO, last_json, tiny_root

CELL = "grid1024_1card.c2c"


def _file(kind, name):
    path = REPO / "h100bench" / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _field(shape, transform, seed):
    g = torch.Generator().manual_seed(seed)
    dt = torch.complex64 if transform == "c2c" else torch.float32
    return torch.randn(shape, dtype=dt, generator=g)


def _rounding_gap(got, want) -> tuple[float, float]:
    """(widest gap over the rms, the most one rounding of ``want`` to
    complex64 or float32 can give)."""
    rms = float(want.abs().pow(2).mean().sqrt())
    gap = float((got.to(want.dtype) - want).abs().max()) / rms
    return gap, 2.0 ** -23 * float(want.abs().max()) / rms


@pytest.mark.parametrize("block", [None, 1, 3])
@pytest.mark.parametrize("transform", ["c2c", "r2c"])
@pytest.mark.parametrize("shape", [(6, 10, 14), (8, 12, 16), (5, 7, 9)])
def test_blocked_agrees_with_whole_arrays(shape, transform, block):
    whole, blocked = _file("references", "fft3d"), _file("references",
                                                        "fft3d_blocked")
    x = _field(shape, transform, seed=sum(shape))
    spec = whole.forward(x, transform)
    got = blocked.forward(x, transform, block=block)
    assert got.dtype == torch.complex64 and got.shape == spec.shape
    gap, most = _rounding_gap(got, spec)
    assert gap <= most
    back = whole.backward(spec, transform, shape)
    got = blocked.backward(spec, transform, shape, block=block)
    assert got.dtype == (torch.complex64 if transform == "c2c"
                         else torch.float32)
    gap, most = _rounding_gap(got, back)
    assert gap <= most


def test_blocks_fit_the_budget():
    blocked = _file("references", "fft3d_blocked")
    # a 1024 x 1024 complex128 plane is 16 MiB: 32 planes a block
    assert blocked._step(1024 * 1024, None) * 16 * 1024 * 1024 == \
        blocked.BLOCK_BYTES
    assert blocked._step(10 ** 9, None) == 1
    assert blocked._step(1024 * 1024, 5) == 5


def test_lowp_control_is_fft3d_s():
    whole, blocked = _file("references", "fft3d"), _file("references",
                                                         "fft3d_blocked")
    x = _field((8, 12, 16), "c2c", seed=3)
    y = blocked.forward_lowp(x, "c2c")
    assert torch.equal(y, whole.forward_lowp(x, "c2c"))
    assert torch.equal(blocked.backward_lowp(y, "c2c", x.shape),
                       whole.backward_lowp(y, "c2c", x.shape))


def _op(dur, *spans, pair=0):
    return Op("k", "kernel", 0.0, float(dur), pair, tuple(spans), 0.0)


def _read(name, tl):
    return _file("metrics", name).read(SimpleNamespace(timeline=tl))


def test_plane_axes_reads_its_span_at_any_depth():
    """A pair past the gate: the leading axis's pass outside the span,
    the two trailing-axis passes inside it, each direction."""
    ops = []
    for call in ("execute_c2c_single", "execute_c2c_single"):
        ops.append(_op(600, call, "fft_axis[radix]"))
        ops += [_op(500, call, "fft_plane[per_axis]", "fft_axis[radix]"),
                _op(400, call, "fft_plane[per_axis]", "fft_axis[radix]")]
    ops.append(_op(999, "fft_plane[per_axis]", "fft_axis[radix]",
                   pair=None))                      # outside every pair
    tl = Timeline(ops, 1, [])
    assert _read("plane_axes_ms", tl) == pytest.approx(1.8)
    assert _read("axis_ms", tl) == pytest.approx(3.0)
    assert _read("plane_ms", tl) is None


def test_plane_axes_none_without_its_span():
    ops = [_op(400, "execute_c2c_single", "fft_plane"),
           _op(300, "execute_c2c_single", "fft_axis[radix]")]
    for tl in (Timeline(ops, 1, []), Timeline([], 1, [])):
        assert _read("plane_axes_ms", tl) is None


def test_cell_files():
    cell = bench.load_cell(REPO, CELL)
    assert cell.config["reference"] == "fft3d_blocked"
    assert cell.config["shape"] == [1024, 1024, 1024]
    assert cell.chips == 1 and cell.traffic["transform"] == "c2c"
    layer = {name for name, _ in cell.per_layer}
    assert "plane_axes_ms" in layer and "axis_ms" in layer
    assert not layer & {"plane_ms", "t0_ms", "t2_ms", "a2a_copy_ms",
                        "untangle_ms"}


@pytest.mark.parametrize("trace", [0, 1])
def test_cell_rehearsal(tmp_path, capsys, trace):
    """The cell at 16^3 on the CPU (no device records: a traced line
    carries only host-clock metrics), checked by the blocked
    reference."""
    root = tiny_root(tmp_path)
    rc = run.main(["--workload", CELL, "--seed", str(2 ** 31 + 29),
                   "--seconds", "0.3", "--trace", str(trace), "--cpu",
                   "--root", str(root)])
    out, err = capsys.readouterr()
    assert rc == 0, err
    line = last_json(out)
    assert line["correct"] is True and line["failed"] == 0
    cell = bench.load_cell(root, CELL)
    names = {n for n, _ in (cell.per_layer if trace else cell.end_to_end)}
    assert set(line["metrics"]) <= names
    assert (set(line["metrics"]) >= {"gflops", "setup_s"}
            if not trace else "host_call_ms" in line["metrics"])


def test_control_fails_and_program_passes(tmp_path):
    root = tiny_root(tmp_path / "root", n=32)
    out = tmp_path / "control.json"
    assert control.main(["--workload", CELL, "--first-seed", str(2 ** 40),
                         "--seeds", "3", "--cpu", "--root", str(root),
                         "--out", str(out)]) == 0
    rows = json.loads(out.read_text())["rows"]
    lim = bench.limits(bench.load_cell(root, CELL))
    for r in rows:
        assert all(r["program"][k] <= lim[k] for k in lim)
        assert any(r["control"][k] > lim[k] for k in lim)

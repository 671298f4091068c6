"""The yardstick's arithmetic against counts made by hand; the field's
boxes; the bytes of the kept outputs."""

import pytest
import torch

from h100bench import bench
from h100bench import yardstick as ys
from h100bench.field import make_field

N = 512 ** 3  # 134217728 points, log2 N = 27


def test_flops_by_hand():
    assert ys.transform_flops((512, 512, 512), 5.0) == 5 * N * 27
    assert ys.transform_flops((512, 512, 512), 2.5) == 2.5 * N * 27
    assert ys.transform_flops((8, 8, 8), 5.0) == 5 * 512 * 9


def test_bytes_by_hand():
    assert ys.transform_bytes((512,) * 3, "c2c", "float32", True) == 2 * N * 8
    half = 512 * 512 * 257 * 8
    assert ys.transform_bytes((512,) * 3, "r2c", "float32", True) == \
        N * 4 + half
    assert ys.transform_bytes((512,) * 3, "r2c", "float32", False) == \
        half + N * 4
    assert ys.transform_bytes((4, 4, 4), "c2c", "float64", True) == 2 * 64 * 16


@pytest.mark.parametrize("transform,ranks,want", [
    ("c2c", 1, 4 * N * 8 / 3.35e12),        # bytes-bound: 1.2821 ms
    ("c2c", 4, N * 8 / 3.35e12),
    ("r2c", 1, 2 * (N * 4 + 512 * 512 * 257 * 8) / 3.35e12),
])
def test_pair_least_seconds(transform, ranks, want):
    factor = 5.0 if transform == "c2c" else 2.5
    got = ys.pair_least_seconds((512,) * 3, transform, "float32", factor,
                                ranks, "NVIDIA H100 80GB HBM3")
    assert got == pytest.approx(want, rel=1e-12)
    # the flop side is smaller at these sizes
    assert 2 * ys.transform_flops((512,) * 3, factor) / ranks / 67e12 < got


def test_unknown_card_has_no_bound():
    assert ys.pair_least_seconds((8, 8, 8), "c2c", "float32", 5.0, 1,
                                 "cpu") is None


def test_percentile_nearest_rank():
    assert ys.percentile(range(1, 101), 95) == 95
    assert ys.percentile(range(1, 21), 95) == 19
    assert ys.percentile([3.0], 95) == 3.0
    assert ys.percentile([5, 1, 4, 2, 3], 50) == 3
    with pytest.raises(ValueError):
        ys.percentile([], 95)


SLABS = tuple(((128 * r, 0, 0), (128 * (r + 1), 512, 512))
              for r in range(4))
PENCILS = (((0, 0, 0), (8, 4, 8)), ((0, 0, 8), (8, 4, 16)),
           ((0, 4, 0), (8, 8, 8)), ((0, 4, 8), (8, 8, 16)))


def test_boxes_that_tile():
    ys.check_tiling(SLABS, (512, 512, 512))
    ys.check_tiling(PENCILS, (8, 8, 16))
    ys.check_tiling((((0, 0, 0), (0, 8, 8)), ((0, 0, 0), (4, 8, 8))),
                    (4, 8, 8))                 # an empty box overlaps none


@pytest.mark.parametrize("boxes,shape,what", [
    (SLABS[:3], (512, 512, 512), "cover"),
    (SLABS[:3] + (((383, 0, 0), (512, 512, 512)),), (512, 512, 512),
     "overlap"),
    (SLABS, (512, 512, 256), "leaves"),
    (PENCILS[:3] + (((0, 4, 8), (8, 8, 17)),), (8, 8, 16), "leaves"),
])
def test_boxes_that_do_not_tile(boxes, shape, what):
    with pytest.raises(ValueError, match=what):
        ys.check_tiling(boxes, shape)


@pytest.mark.parametrize("dtype", [torch.complex64, torch.float32])
def test_field_boxes_are_cut_from_whole_planes(dtype):
    shape, seed = (8, 8, 16), 2 ** 40 + 3
    whole = make_field(shape, (0, 0, 0), shape, dtype, seed, "cpu")
    for low, high in PENCILS + (((2, 0, 0), (4, 8, 16)),
                                ((1, 2, 3), (5, 7, 11))):
        box = make_field(shape, low, high, dtype, seed, "cpu")
        assert box.is_contiguous()
        assert torch.equal(box, whole[low[0]:high[0], low[1]:high[1],
                                      low[2]:high[2]])


def test_kept_bytes_counts_a_storage_once():
    y = torch.zeros(4, 8, dtype=torch.complex64)
    z = torch.zeros(4, 8, dtype=torch.float32)
    assert bench.kept_bytes([(y, z)]) == 4 * 8 * 8 + 4 * 8 * 4
    assert bench.kept_bytes([(y, y[1:])]) == 4 * 8 * 8
    assert bench.kept_bytes([]) == 0

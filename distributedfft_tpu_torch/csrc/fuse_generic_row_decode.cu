// The generic-prime-stage variants (MAXR = kMaxPrime) of the fused
// decode's row form (fuse.cuh: decode_rows_kernel) for each codec, both
// directions, in a unit of their own (ops/_build.py starts one nvcc per
// .cu, all together); fuse.cuh declares them extern everywhere else.

#define DFFT_FUSE_GENERIC_ROW_DECODE_TU
#include "fuse.cuh"

DFFT_FUSE_ROW_DECODE(, radix::kMaxPrime)

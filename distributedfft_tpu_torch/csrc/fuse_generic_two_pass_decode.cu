// The generic-prime-stage variants (MAXR = kMaxPrime) of the fused
// decode's first pass on the two-pass route (fuse.cuh:
// decode_first_kernel) for each codec, both directions, in a unit of
// their own (ops/_build.py starts one nvcc per .cu, all together);
// fuse.cuh declares them extern everywhere else.

#define DFFT_FUSE_GENERIC_TWO_PASS_DECODE_TU
#include "fuse.cuh"

DFFT_FUSE_TWO_PASS_DECODE(, radix::kMaxPrime)

// The generic-prime-stage variants (MAXR = kMaxPrime) of the fused
// encode's second pass on the two-pass route (fuse.cuh: ReorderCodecOut,
// TransposeCodecOut into each codec pack), both directions, in a unit of
// their own (ops/_build.py starts one nvcc per .cu, all together);
// fuse.cuh declares them extern everywhere else.

#define DFFT_FUSE_GENERIC_TWO_PASS_TU
#include "fuse.cuh"

DFFT_FUSE_TWO_PASS_ENCODE(, radix::kMaxPrime)

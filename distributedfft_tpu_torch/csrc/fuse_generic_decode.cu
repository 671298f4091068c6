// The generic-prime-stage variants (MAXR = kMaxPrime) of the fused decode
// kernel's column pass (fuse.cuh: decode_cols_kernel) for each codec,
// both directions. Like generic.cu's, each compiles every hand-written
// butterfly and radix.cuh:generic_stage, here with the wire reader in
// every first stage, so they build in a process of their own beside the
// other translation units (ops/_build.py starts one nvcc per .cu, all
// together). fuse.cuh declares them extern everywhere else.

#define DFFT_FUSE_GENERIC_DECODE_TU
#include "fuse.cuh"

DFFT_FUSE_COLUMN_DECODE(, radix::kMaxPrime)

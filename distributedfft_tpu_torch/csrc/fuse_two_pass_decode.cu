// The smooth variants (MAXR 8 and kMaxHand) of the fused decode's first
// pass on the two-pass route past 8192 (fuse.cuh: decode_first_kernel)
// for each codec, both directions. A unit of their own (ops/_build.py
// starts one nvcc per .cu, all together); fuse.cuh declares them extern
// everywhere else.

#define DFFT_FUSE_TWO_PASS_DECODE_TU
#include "fuse.cuh"

DFFT_FUSE_SMOOTH(DFFT_FUSE_TWO_PASS_DECODE, )

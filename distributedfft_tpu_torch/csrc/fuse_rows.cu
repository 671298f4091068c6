// The smooth variants (MAXR 8 and kMaxHand) of the fused kernels' row
// form, the route of a last-axis site (cols = 1) up to 8192: the
// encode's rows pass into each codec pack (fuse.cuh: RowCodecOut over
// Bf16Pack, AmaxPack) and the decode's rows pass (decode_rows_kernel) for
// each codec, both directions. A unit of their own, built beside fuse.cu
// (ops/_build.py starts one nvcc per .cu, all together); fuse.cuh
// declares them extern everywhere else.

#define DFFT_FUSE_ROWS_TU
#include "fuse.cuh"

DFFT_FUSE_SMOOTH(DFFT_FUSE_ROW_ENCODE, )
DFFT_FUSE_SMOOTH(DFFT_FUSE_ROW_DECODE, )

// The smooth variants (MAXR 8 and kMaxHand) of the fused encode's second
// pass on the two-pass route past 8192: the column pass with the
// reordering store (fuse.cuh: ReorderCodecOut) and, at cols = 1, the rows
// pass with the transposed store (TransposeCodecOut), each into each
// codec pack, both directions. A unit of their own (ops/_build.py starts
// one nvcc per .cu, all together); fuse.cuh declares them extern
// everywhere else.

#define DFFT_FUSE_TWO_PASS_TU
#include "fuse.cuh"

DFFT_FUSE_SMOOTH(DFFT_FUSE_TWO_PASS_ENCODE, )

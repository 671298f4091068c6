// The generic-prime-stage variants (MAXR = kMaxPrime) of the fused encode
// kernel of fuse.cu on the radix route: radix.cuh's column pass into the
// encode's outputs (fuse.cuh: Bf16Out, C64AmaxOut) and the row form's
// rows pass into each codec pack (RowCodecOut), both directions. Like
// generic.cu's, each compiles every hand-written butterfly and
// radix.cuh:generic_stage, so they build in a process of their own beside
// the other translation units (ops/_build.py starts one nvcc per .cu, all
// together), and the smooth variants in fuse.cu compile as they did
// before them. fuse.cuh declares them extern everywhere else.

#define DFFT_FUSE_GENERIC_ENCODE_TU
#include "fuse.cuh"

DFFT_FUSE_COLUMN_ENCODE(, radix::kMaxPrime)
DFFT_FUSE_ROW_ENCODE(, radix::kMaxPrime)

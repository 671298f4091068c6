// The generic-prime-stage variants (MAXR = kMaxPrime) of radix.cuh's row
// and column kernels, for the outputs the row and strided launchers of
// four_step.cu give them (RowOut, TransposeOut, C64Out, TwiddleOut,
// ReorderOut; both directions). Each compiles every hand-written
// butterfly and radix.cuh:generic_stage, so they are the heaviest kernels
// to build; kept in a translation unit of their own, they build in a
// process of their own beside four_step.cu and fuse.cu (ops/_build.py
// starts one nvcc per .cu, all together). radix.cuh declares them extern
// everywhere else.

#define DFFT_GENERIC_TU
#include "radix.cuh"

namespace radix {

DFFT_GENERIC_KERNELS();

}  // namespace radix

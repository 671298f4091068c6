// The radix-route device code of the fused stage+codec kernels (fuse.cu:
// dfft_fft_encode, dfft_decode_fft) that their generic-prime-stage
// variants share with the others: the encode's two outputs for radix.cuh's
// column pass (Bf16Out, C64AmaxOut), the wire reader and the decode's
// column kernel. Named (namespace fuse), not anonymous, so that their own
// translation units, fuse_generic_encode.cu and fuse_generic_decode.cu,
// compile the MAXR = kMaxPrime variants and every other declares them
// extern (as generic.cu and radix.cuh's DFFT_GENERIC_KERNELS do for the
// strided kernel's outputs): the smooth variants in fuse.cu then compile
// as they did before the generic stage, and the heaviest kernels build
// in nvcc processes of their own (ops/_build.py starts one per .cu, all
// together).
//
// Each output takes output i of a column as the strided kernel would
// store it, to the bit: same plan, table, kernel variant and scale before
// the sink; the decode's first stage reads the exactly unpacked wire.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "radix.cuh"

namespace fuse {

// Wire bytes per complex value of a codec: 0 bf16, 1 int8, 2 int16
// (split).
__host__ __device__ constexpr int pair_bytes(int codec) {
  return codec == 1 ? 2 : 4;
}

// The wire value whose (re, im) pair sits at e (device or shared memory)
// as c64, t its input tile, `side` the [tiles, 2] steps: exact.
template <int CODEC>
__device__ __forceinline__ float2 unpack(const char* e, const float* side,
                                         int t) {
  if (CODEC == 0)
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(e));
  const float sr = side[2 * t], si = side[2 * t + 1];
  if (CODEC == 1) {
    const char2 p = *reinterpret_cast<const char2*>(e);
    return make_float2((float)p.x * sr, (float)p.y * si);
  }
  const short2 p = *reinterpret_cast<const short2*>(e);
  return make_float2((float)p.x * sr, (float)p.y * si);
}

// decode_fft by the radix route over [lead, n, nz] (CODEC as above),
// `cols` neighbouring columns per group: radix.cuh's column pass with
// another landing step. The group's raw wire tile lands in shared memory
// (load_wire_tile: 16-byte copies of whole aligned row segments, else
// 4-byte copies of each segment's covering span, which an odd nz gives
// int8); the first stage, a register butterfly or the generic stage,
// reads each value through unpack, at the segment's offset in its landed
// row; the steps sit in shared memory after the stage table.
template <int CODEC, bool FWD, int MAXR>
__global__ void __launch_bounds__(radix::kThreads)
decode_cols_kernel(const void* q, const float* side, float2* y,
                   long long lead, long long nz, radix::Plan plan, int cols,
                   radix::Smem sm, int tiles, const float2* twg, float scale) {
  extern __shared__ float4 radix_smem[];
  float2* smem = reinterpret_cast<float2*>(radix_smem);
  const int n = plan.n;
  float2* tw = smem + sm.twiddles();
  float* steps = reinterpret_cast<float*>(tw + plan.table);
  radix::load_twiddles(tw, twg, plan);
  if (CODEC != 0)
    for (int i = threadIdx.x; i < 2 * tiles; i += blockDim.x)
      steps[i] = side[i];
  constexpr int pb = pair_bytes(CODEC);
  const int seg = n / tiles, bytes = cols * pb;
  const long long ld = nz * pb;
  const char* qb = static_cast<const char*>(q);
  const radix::Lane ln = radix::lane<true>(cols);
  const long long per = (nz + cols - 1) / cols;
  const long long groups = lead * per;
  // element offset of the group's first value; cnt: its columns
  auto where = [&](long long g, int* cnt) {
    const long long l = g / per, c0 = (g - l * per) * cols;
    *cnt = (int)(nz - c0 < cols ? nz - c0 : cols);
    return l * n * nz + c0;
  };
  auto fast = [&](const char* src, int cnt) {
    return cnt == cols && (bytes & 15) == 0 && (ld & 15) == 0 &&
           (reinterpret_cast<size_t>(src) & 15) == 0;
  };
  radix::group_loop(
      smem, sm, groups,
      [&](long long g, float2* dst) {
        int cnt;
        const char* src = qb + where(g, &cnt) * pb;
        radix::load_wire_tile(reinterpret_cast<char*>(dst), src, n, cnt * pb,
                              bytes, ld, fast(src, cnt));
      },
      [&](long long g, float2* p, float2* a, float2* b, auto after) {
        int cnt;
        const long long e0 = where(g, &cnt);
        const char* src = qb + e0 * pb;
        const bool f = fast(src, cnt);
        const int w = radix::wire_ld(bytes, f);
        // row i's segment starts at (src + i*ld) & 3 in its landed row
        const int o0 = f ? 0 : (int)(reinterpret_cast<size_t>(src) & 3);
        const int od = f ? 0 : (int)(ld & 3);
        const char* in = reinterpret_cast<const char*>(p) + ln.s * pb;
        radix::run_stages<FWD, true, MAXR>(
            [=](int i) {
              return unpack<CODEC>(in + i * w + ((o0 + i * od) & 3), steps,
                                   i / seg);
            },
            radix::store_c64(y + e0 + ln.s, nz), ln.s < cnt, ln, cols, plan,
            a, b, tw, scale, after);
      });
}

// fft_encode by the radix route: radix.cuh's column pass (cols_kernel,
// the strided kernel's template) with one of these outputs.

// bf16: each (re, im) pair rounded to nearest even.
struct Bf16Out {
  __nv_bfloat162* q;
  __device__ void begin(void*) {}
  __device__ auto column(long long e, long long stride) {
    __nv_bfloat162* d = q + e;
    return [=](int i, float2 v) {
      d[i * stride] = __floats2bfloat162_rn(v.x, v.y);
    };
  }
  __device__ void end() {}
};

// Tiles whose amax a thread keeps in registers.
constexpr int kRegTiles = 4;

// The tile of output index i: i / seg, as (i + 1/2) * (1/seg) in fp32.
// Exact for n = tiles*seg < 2^22: the product is within tiles * 2^-23 of
// (i + 1/2) / seg, which lies at least 1/(2 seg) from an integer.
__device__ __forceinline__ int tile_of(int i, float inv_seg) {
  return (int)(((float)i + 0.5f) * inv_seg);
}

// Pass A of the quantized encode: stores each value as the strided
// kernel does (y is then fft_axis0(x), bit for bit) and takes the amax
// of |re| and |im| of each tile of the output index into amax[2t] and
// amax[2t + 1], as the uint32 bits of the non-negative floats (they
// order as the floats do, so atomicMax is exact and the result does not
// depend on the order of the blocks). A thread keeps running maxima of
// up to kRegTiles tiles in registers over every group its block walks;
// at the block's end each warp reduces them (one shared atomicMax per
// warp and slot) and the block merges its 2*tiles shared slots into
// amax (one global atomicMax per slot). More tiles than kRegTiles go
// straight to the shared slots, value by value.
struct C64AmaxOut {
  float2* y;
  unsigned* amax;
  int tiles, seg;
  float inv_seg;
  unsigned* slots;
  float m[2 * kRegTiles];
  __device__ void begin(void* extra) {
    slots = static_cast<unsigned*>(extra);
    inv_seg = 1.0f / seg;
    for (int i = threadIdx.x; i < 2 * tiles; i += blockDim.x) slots[i] = 0u;
#pragma unroll
    for (int k = 0; k < 2 * kRegTiles; ++k) m[k] = 0.f;
  }
  __device__ auto column(long long e, long long stride) {
    float2* d = y + e;
    return [this, d, stride](int i, float2 v) {
      d[i * stride] = v;
      const int t = tile_of(i, inv_seg);
      const float re = fabsf(v.x), im = fabsf(v.y);
      if (tiles <= kRegTiles) {
#pragma unroll
        for (int k = 0; k < kRegTiles; ++k)
          if (k == t) {
            m[2 * k] = fmaxf(m[2 * k], re);
            m[2 * k + 1] = fmaxf(m[2 * k + 1], im);
          }
      } else {
        atomicMax(&slots[2 * t], __float_as_uint(re));
        atomicMax(&slots[2 * t + 1], __float_as_uint(im));
      }
    };
  }
  __device__ void end() {
    __syncthreads();
    if (tiles <= kRegTiles) {
#pragma unroll
      for (int k = 0; k < 2 * kRegTiles; ++k) {
        if (k >= 2 * tiles) break;
        const unsigned w =
            __reduce_max_sync(0xffffffffu, __float_as_uint(m[k]));
        if ((threadIdx.x & 31) == 0 && w != 0u) atomicMax(&slots[k], w);
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < 2 * tiles; i += blockDim.x)
      if (slots[i] != 0u) atomicMax(&amax[i], slots[i]);
  }
};

}  // namespace fuse

// The generic-stage variants (MAXR = kMaxPrime) of the fused kernels:
// the encode's column pass into each of its outputs (compiled in
// fuse_generic_encode.cu) and the decode for each codec (in
// fuse_generic_decode.cu), both directions; every other file only
// declares them. Two translation units, so that neither takes longer to
// build than fuse.cu.
#define DFFT_FUSE_GENERIC_ENCODE(PREFIX)                                   \
  namespace radix {                                                        \
  PREFIX DFFT_GENERIC_COLS(true, fuse::Bf16Out);                           \
  PREFIX DFFT_GENERIC_COLS(false, fuse::Bf16Out);                          \
  PREFIX DFFT_GENERIC_COLS(true, fuse::C64AmaxOut);                        \
  PREFIX DFFT_GENERIC_COLS(false, fuse::C64AmaxOut);                       \
  }
#define DFFT_FUSE_GENERIC_DECODE(CODEC, FWD)                               \
  template __global__ void decode_cols_kernel<CODEC, FWD,                  \
                                              radix::kMaxPrime>(           \
      const void*, const float*, float2*, long long, long long,            \
      radix::Plan, int, radix::Smem, int, const float2*, float)
#define DFFT_FUSE_GENERIC_DECODES(PREFIX)                                  \
  namespace fuse {                                                         \
  PREFIX DFFT_FUSE_GENERIC_DECODE(0, true);                                \
  PREFIX DFFT_FUSE_GENERIC_DECODE(0, false);                               \
  PREFIX DFFT_FUSE_GENERIC_DECODE(1, true);                                \
  PREFIX DFFT_FUSE_GENERIC_DECODE(1, false);                               \
  PREFIX DFFT_FUSE_GENERIC_DECODE(2, true);                                \
  PREFIX DFFT_FUSE_GENERIC_DECODE(2, false);                               \
  }
#ifndef DFFT_FUSE_GENERIC_ENCODE_TU
DFFT_FUSE_GENERIC_ENCODE(extern)
#endif
#ifndef DFFT_FUSE_GENERIC_DECODE_TU
DFFT_FUSE_GENERIC_DECODES(extern)
#endif

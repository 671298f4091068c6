// The radix-route device code of the fused stage+codec kernels (fuse.cu:
// dfft_fft_encode, dfft_decode_fft, dfft_fft_encode_2p,
// dfft_decode_fft_2p) that their variants share across translation
// units: the encode's outputs for radix.cuh's passes (Bf16Out,
// C64AmaxOut for the column pass; the codec packs Bf16Pack and AmaxPack
// behind the row form's RowCodecOut and the two-pass route's
// ReorderCodecOut / TransposeCodecOut), the wire readers and the
// decode's kernels (the column pass, the row form, the two-pass route's
// first pass). Named (namespace fuse), not anonymous, so that their own
// translation units compile the variants and every other declares them
// extern (as generic.cu and radix.cuh's DFFT_GENERIC_KERNELS do for the
// strided kernel's outputs): fuse.cu keeps the column-pass variants it
// had, and the heaviest kernels build in nvcc processes of their own
// (ops/_build.py starts one per .cu, all together).
//
// Each output takes each value as the unfused twin's pass would store
// it, to the bit: same plan, table, kernel variant and scale before the
// sink; each decode's first stage reads the exactly unpacked wire.

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

// decode_fft by the two-pass route, pass 1 over the wire as [lead, m1,
// nz], nz = m2*cols (CODEC as above): decode_cols_kernel's column pass of
// length m1 with the two-pass route's first store (radix.cuh:
// TwiddleOut into the scratch) in place of its complex64 one. Element i
// of column c is input j = i*m2 + j2 of the transform, j2 = (c % nz) /
// cols, and its tile is j / seg (seg = m1*m2 / tiles). A body of its own:
// sharing decode_cols_kernel's through a device function moved six of
// that kernel's variants by 3-7 registers.
template <int CODEC, bool FWD, int MAXR>
__global__ void __launch_bounds__(radix::kThreads)
decode_first_kernel(const void* q, const float* side, radix::TwiddleOut out,
                    long long lead, long long nz, radix::Plan plan, int cols,
                    radix::Smem sm, int tiles, const float2* twg,
                    float scale) {
  extern __shared__ float4 radix_smem[];
  float2* smem = reinterpret_cast<float2*>(radix_smem);
  const int n = plan.n, m2 = out.m2;
  float2* tw = smem + sm.twiddles();
  float* steps = reinterpret_cast<float*>(tw + plan.table);
  radix::load_twiddles(tw, twg, plan);
  if (CODEC != 0)
    for (int i = threadIdx.x; i < 2 * tiles; i += blockDim.x)
      steps[i] = side[i];
  constexpr int pb = pair_bytes(CODEC);
  const int seg = n * m2 / tiles, bytes = cols * pb;
  const long long ld = nz * pb;
  const char* qb = static_cast<const char*>(q);
  const radix::Lane ln = radix::lane<true>(cols);
  const long long per = (nz + cols - 1) / cols;
  const long long groups = lead * per;
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
        const int o0 = f ? 0 : (int)(reinterpret_cast<size_t>(src) & 3);
        const int od = f ? 0 : (int)(ld & 3);
        const char* in = reinterpret_cast<const char*>(p) + ln.s * pb;
        const int j2 = (int)(((e0 + ln.s) % nz) / out.cols);
        radix::run_stages<FWD, true, MAXR>(
            [=](int i) {
              return unpack<CODEC>(in + i * w + ((o0 + i * od) & 3), steps,
                                   (i * m2 + j2) / seg);
            },
            out.column(e0 + ln.s, nz), ln.s < cnt, ln, cols, plan, a, b, tw,
            scale, after);
      });
}

// Shared-memory bytes a group of `rows` wire rows of `bytes` each lands
// in: the rows, and room for the 4-byte covering span of a range that
// starts off a 4-byte boundary.
__host__ __device__ __forceinline__ long long wire_rows_bytes(int rows,
                                                              int bytes) {
  return (long long)rows * bytes + 8;
}

// Start copying `bytes` contiguous wire bytes into shared memory: 16-byte
// copies when the range is 16-byte aligned and whole, else 4-byte copies
// of its covering span, the range then starting at src & 3 (returned).
__device__ __forceinline__ int load_wire_range(char* dst, const char* src,
                                               int bytes) {
  if ((reinterpret_cast<size_t>(src) & 15) == 0 && (bytes & 15) == 0) {
    for (int i = threadIdx.x; i < bytes / 16; i += blockDim.x)
      radix::cp_async16(dst + 16 * i, src + 16 * i);
    return 0;
  }
  const int o = (int)(reinterpret_cast<size_t>(src) & 3);
  for (int k = threadIdx.x; 4 * k < o + bytes; k += blockDim.x)
    radix::cp_async4(dst + 4 * k, src - o + 4 * k);
  return o;
}

// decode_fft in the row form over [batch, n] (a last-axis site, cols =
// 1), `seqs` rows per group: radix.cuh's rows pass (rows_kernel, the row
// kernel's template) with another landing step. The group's raw wire
// rows, one contiguous range, land in shared memory (load_wire_range);
// the first stage reads each value through unpack (its input tile i /
// seg); the last stores complex64 rows as the row kernel does.
template <int CODEC, bool FWD, int MAXR>
__global__ void __launch_bounds__(radix::kThreads)
decode_rows_kernel(const void* q, const float* side, float2* y,
                   long long batch, radix::Plan plan, int seqs,
                   radix::Smem sm, int tiles, const float2* twg,
                   float scale) {
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
  const int seg = n / tiles, row_bytes = n * pb;
  const char* qb = static_cast<const char*>(q);
  const radix::Lane ln = radix::lane<false>(seqs);
  const long long groups = (batch + seqs - 1) / seqs;
  auto count = [&](long long g) {
    return (int)(batch - g * seqs < seqs ? batch - g * seqs : seqs);
  };
  int o = 0;  // where the landed range starts, set by each load
  radix::group_loop(
      smem, sm, groups,
      [&](long long g, float2* dst) {
        o = load_wire_range(reinterpret_cast<char*>(dst),
                            qb + g * seqs * row_bytes, count(g) * row_bytes);
      },
      [&](long long g, float2* p, float2* a, float2* b, auto after) {
        const long long row = g * seqs + ln.s;
        const char* in =
            reinterpret_cast<const char*>(p) + o + ln.s * row_bytes;
        radix::run_stages<FWD, false, MAXR>(
            [=](int i) { return unpack<CODEC>(in + i * pb, steps, i / seg); },
            radix::store_c64(y + row * n, 1), row < batch, ln, seqs, plan, a,
            b, tw, scale, after);
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

// The codec pack of the quantized encode's first launch: stores each
// value as the unfused pass does (y is then the transform, bit for bit)
// and takes the amax of |re| and |im| of each tile of the output index
// into amax[2t] and amax[2t + 1], as the uint32 bits of the non-negative
// floats (they order as the floats do, so atomicMax is exact and the
// result does not depend on the order of the blocks). A thread keeps
// running maxima of up to kRegTiles tiles in registers over every group
// its block walks; at the block's end each warp reduces them (one shared
// atomicMax per warp and slot) and the block merges its 2*tiles shared
// slots into amax (one global atomicMax per slot). More tiles than
// kRegTiles go straight to the shared slots, value by value. begin(extra)
// takes the slots (2*tiles uint32); put(at, k, v) stores v at y[at] as
// output index k of its sequence.
struct AmaxPack {
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
  // v's |re| and |im| into the maxima of the tile of output index k
  __device__ void note(int k, float2 v) {
    const int t = tile_of(k, inv_seg);
    const float re = fabsf(v.x), im = fabsf(v.y);
    if (tiles <= kRegTiles) {
#pragma unroll
      for (int u = 0; u < kRegTiles; ++u)
        if (u == t) {
          m[2 * u] = fmaxf(m[2 * u], re);
          m[2 * u + 1] = fmaxf(m[2 * u + 1], im);
        }
    } else {
      atomicMax(&slots[2 * t], __float_as_uint(re));
      atomicMax(&slots[2 * t + 1], __float_as_uint(im));
    }
  }
  __device__ void put(long long at, int k, float2 v) {
    y[at] = v;
    note(k, v);
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

// The codec pack of the bf16 encode: put(at, k, v) stores v's pair,
// rounded to nearest even, at q[at].
struct Bf16Pack {
  __nv_bfloat162* q;
  __device__ void begin(void*) {}
  __device__ void put(long long at, int, float2 v) {
    q[at] = __floats2bfloat162_rn(v.x, v.y);
  }
  __device__ void end() {}
};

// Pass A of the quantized encode on the column pass: AmaxPack's store
// and amax at y[e + i*stride], output index i.
struct C64AmaxOut : AmaxPack {
  __device__ auto column(long long e, long long stride) {
    float2* d = y + e;
    return [this, d, stride](int i, float2 v) {
      d[i * stride] = v;
      note(i, v);
    };
  }
};

// The encode's row form (a last-axis site, cols = 1): radix.cuh's rows
// pass (rows_kernel, the row kernel's template), output i of row r to the
// pack at r*n + i, output index i.
template <typename Pack>
struct RowCodecOut {
  Pack pack;
  int n;
  __device__ void begin(void* extra) { pack.begin(extra); }
  __device__ auto row(long long r, int) {
    Pack* p = &pack;
    const long long at = r * n;
    return [p, at](int i, float2 v) { p->put(at + i, i, v); };
  }
  __device__ void flush(long long, int) {}
  __device__ void end() { pack.end(); }
};

// The encode's second pass on the two-pass route, cols > 1: the column
// pass of length m2 over the [lead*m1, m2, cols] scratch, output k2 of
// its column c in block l*m1 + k1 to the pack at [l, k1 + m1*k2, c] (as
// radix.cuh's ReorderOut stores it), output index k = k1 + m1*k2.
template <typename Pack>
struct ReorderCodecOut {
  Pack pack;
  long long cols;
  int m1, m2;
  __device__ void begin(void* extra) { pack.begin(extra); }
  __device__ auto column(long long e, long long) {
    const long long span = (long long)m2 * cols;
    const long long blk = e / span, c = e - blk * span;
    const long long l = blk / m1;
    const int k1 = (int)(blk - l * m1), m = m1;
    const long long at = (l * m1 * m2 + k1) * cols + c, step = m1 * cols;
    Pack* p = &pack;
    return [=](int i, float2 v) { p->put(at + i * step, k1 + m * i, v); };
  }
  __device__ void end() { pack.end(); }
};

// The same at cols = 1: the rows pass over the [batch*m1, m2] scratch
// with radix.cuh's TransposeOut staging, flush handing each k2's run of
// the group's rows (consecutive k1) to the pack at [b, k1 + m1*k2],
// output index k1 + m1*k2. The pack's extra bytes follow the staging
// buffer.
template <typename Pack>
struct TransposeCodecOut {
  Pack pack;
  int m1, m2, ld;  // ld = odd_ld(rows per group)
  float2* stage;
  __device__ void begin(void* extra) {
    stage = static_cast<float2*>(extra);
    pack.begin(stage + (size_t)m2 * ld);
  }
  __device__ auto row(long long, int s) {
    float2* d = stage + s;
    const int step = ld;
    return [=](int i, float2 v) { d[i * step] = v; };
  }
  __device__ void flush(long long r0, int cnt) {
    const int per = blockDim.x / cnt, s = threadIdx.x % cnt;
    const int k0 = threadIdx.x / cnt;
    if (k0 >= per) return;
    const long long b0 = r0 / m1;
    const int k1 = (int)(r0 - b0 * m1) + s, q = k1 / m1, j = k1 - q * m1;
    const long long at = (b0 + q) * m1 * m2 + j;
    for (int k2 = k0; k2 < m2; k2 += per)
      pack.put(at + (long long)m1 * k2, j + m1 * k2, stage[k2 * ld + s]);
  }
  __device__ void end() { pack.end(); }
};

}  // namespace fuse

// The kernel variants of the fused kernels that translation units share.
// fuse.cu compiles the smooth (MAXR 8 and kMaxHand) column-pass variants
// itself; every other variant is compiled in one unit and declared
// extern in every other (PREFIX: nothing or extern), so that no unit
// takes much longer to build than another:
//   fuse_generic_encode.cu   the column pass into Bf16Out / C64AmaxOut,
//                            and the row form's encode, MAXR = kMaxPrime
//   fuse_generic_decode.cu   the decode column pass, kMaxPrime
//   fuse_rows.cu             the row form, encode and decode, MAXR 8 and
//                            kMaxHand
//   fuse_generic_row_decode.cu  the row form's decode, kMaxPrime
//   fuse_two_pass.cu         the two-pass encode's second pass (both
//                            stores), MAXR 8 and kMaxHand
//   fuse_two_pass_decode.cu  the two-pass decode's first pass, 8 and
//                            kMaxHand
//   fuse_generic_two_pass.cu, fuse_generic_two_pass_decode.cu: the same
//                            two, kMaxPrime.
#define DFFT_FUSE_ROWS_K(PREFIX, FWD, MAXR, OUT)                            \
  PREFIX template __global__ void rows_kernel<FWD, MAXR, OUT>(             \
      const float2*, OUT, long long, Plan, int, Smem, const float2*, float)
#define DFFT_FUSE_COLS_K(PREFIX, FWD, MAXR, OUT)                            \
  PREFIX template __global__ void cols_kernel<FWD, MAXR, OUT>(             \
      const float2*, OUT, long long, long long, Plan, int, Smem,           \
      const float2*, float)
#define DFFT_FUSE_BOTH_WAYS(K, PREFIX, MAXR, OUT)                           \
  K(PREFIX, true, MAXR, OUT);                                              \
  K(PREFIX, false, MAXR, OUT)
#define DFFT_FUSE_DECODE_K(PREFIX, KERNEL, OUT, CODEC, FWD, MAXR)          \
  PREFIX template __global__ void KERNEL<CODEC, FWD, MAXR>(                \
      const void*, const float*, OUT, long long, long long, radix::Plan,   \
      int, radix::Smem, int, const float2*, float)
#define DFFT_FUSE_DECODE_ROWS_K(PREFIX, CODEC, FWD, MAXR)                   \
  PREFIX template __global__ void decode_rows_kernel<CODEC, FWD, MAXR>(    \
      const void*, const float*, float2*, long long, radix::Plan, int,     \
      radix::Smem, int, const float2*, float)

// The column pass into the encode's outputs, the decode column pass.
#define DFFT_FUSE_COLUMN_ENCODE(PREFIX, MAXR)                              \
  namespace radix {                                                        \
  DFFT_FUSE_BOTH_WAYS(DFFT_FUSE_COLS_K, PREFIX, MAXR, fuse::Bf16Out);      \
  DFFT_FUSE_BOTH_WAYS(DFFT_FUSE_COLS_K, PREFIX, MAXR, fuse::C64AmaxOut);   \
  }
#define DFFT_FUSE_COLUMN_DECODE(PREFIX, MAXR)                              \
  namespace fuse {                                                         \
  DFFT_FUSE_DECODE_K(PREFIX, decode_cols_kernel, float2*, 0, true, MAXR);  \
  DFFT_FUSE_DECODE_K(PREFIX, decode_cols_kernel, float2*, 0, false, MAXR); \
  DFFT_FUSE_DECODE_K(PREFIX, decode_cols_kernel, float2*, 1, true, MAXR);  \
  DFFT_FUSE_DECODE_K(PREFIX, decode_cols_kernel, float2*, 1, false, MAXR); \
  DFFT_FUSE_DECODE_K(PREFIX, decode_cols_kernel, float2*, 2, true, MAXR);  \
  DFFT_FUSE_DECODE_K(PREFIX, decode_cols_kernel, float2*, 2, false, MAXR); \
  }
// The row form: the encode's rows pass into each pack, the decode.
#define DFFT_FUSE_ROW_ENCODE(PREFIX, MAXR)                                 \
  namespace radix {                                                        \
  DFFT_FUSE_BOTH_WAYS(DFFT_FUSE_ROWS_K, PREFIX, MAXR,                      \
                      fuse::RowCodecOut<fuse::Bf16Pack>);                  \
  DFFT_FUSE_BOTH_WAYS(DFFT_FUSE_ROWS_K, PREFIX, MAXR,                      \
                      fuse::RowCodecOut<fuse::AmaxPack>);                  \
  }
#define DFFT_FUSE_ROW_DECODE(PREFIX, MAXR)                                 \
  namespace fuse {                                                         \
  DFFT_FUSE_DECODE_ROWS_K(PREFIX, 0, true, MAXR);                          \
  DFFT_FUSE_DECODE_ROWS_K(PREFIX, 0, false, MAXR);                         \
  DFFT_FUSE_DECODE_ROWS_K(PREFIX, 1, true, MAXR);                          \
  DFFT_FUSE_DECODE_ROWS_K(PREFIX, 1, false, MAXR);                         \
  DFFT_FUSE_DECODE_ROWS_K(PREFIX, 2, true, MAXR);                          \
  DFFT_FUSE_DECODE_ROWS_K(PREFIX, 2, false, MAXR);                         \
  }
// The two-pass route: the encode's second pass (column and row stores)
// into each pack, the decode's first pass.
#define DFFT_FUSE_TWO_PASS_ENCODE(PREFIX, MAXR)                            \
  namespace radix {                                                        \
  DFFT_FUSE_BOTH_WAYS(DFFT_FUSE_COLS_K, PREFIX, MAXR,                      \
                      fuse::ReorderCodecOut<fuse::Bf16Pack>);              \
  DFFT_FUSE_BOTH_WAYS(DFFT_FUSE_COLS_K, PREFIX, MAXR,                      \
                      fuse::ReorderCodecOut<fuse::AmaxPack>);              \
  DFFT_FUSE_BOTH_WAYS(DFFT_FUSE_ROWS_K, PREFIX, MAXR,                      \
                      fuse::TransposeCodecOut<fuse::Bf16Pack>);            \
  DFFT_FUSE_BOTH_WAYS(DFFT_FUSE_ROWS_K, PREFIX, MAXR,                      \
                      fuse::TransposeCodecOut<fuse::AmaxPack>);            \
  }
#define DFFT_FUSE_TWO_PASS_DECODE(PREFIX, MAXR)                            \
  namespace fuse {                                                         \
  DFFT_FUSE_DECODE_K(PREFIX, decode_first_kernel, radix::TwiddleOut, 0,    \
                     true, MAXR);                                          \
  DFFT_FUSE_DECODE_K(PREFIX, decode_first_kernel, radix::TwiddleOut, 0,    \
                     false, MAXR);                                         \
  DFFT_FUSE_DECODE_K(PREFIX, decode_first_kernel, radix::TwiddleOut, 1,    \
                     true, MAXR);                                          \
  DFFT_FUSE_DECODE_K(PREFIX, decode_first_kernel, radix::TwiddleOut, 1,    \
                     false, MAXR);                                         \
  DFFT_FUSE_DECODE_K(PREFIX, decode_first_kernel, radix::TwiddleOut, 2,    \
                     true, MAXR);                                          \
  DFFT_FUSE_DECODE_K(PREFIX, decode_first_kernel, radix::TwiddleOut, 2,    \
                     false, MAXR);                                         \
  }
// Both smooth variants of a family.
#define DFFT_FUSE_SMOOTH(FAMILY, PREFIX)                                   \
  FAMILY(PREFIX, 8)                                                        \
  FAMILY(PREFIX, radix::kMaxHand)

#ifndef DFFT_FUSE_GENERIC_ENCODE_TU
DFFT_FUSE_COLUMN_ENCODE(extern, radix::kMaxPrime)
DFFT_FUSE_ROW_ENCODE(extern, radix::kMaxPrime)
#endif
#ifndef DFFT_FUSE_GENERIC_DECODE_TU
DFFT_FUSE_COLUMN_DECODE(extern, radix::kMaxPrime)
#endif
#ifndef DFFT_FUSE_ROWS_TU
DFFT_FUSE_SMOOTH(DFFT_FUSE_ROW_ENCODE, extern)
DFFT_FUSE_SMOOTH(DFFT_FUSE_ROW_DECODE, extern)
#endif
#ifndef DFFT_FUSE_GENERIC_ROW_DECODE_TU
DFFT_FUSE_ROW_DECODE(extern, radix::kMaxPrime)
#endif
#ifndef DFFT_FUSE_TWO_PASS_TU
DFFT_FUSE_SMOOTH(DFFT_FUSE_TWO_PASS_ENCODE, extern)
#endif
#ifndef DFFT_FUSE_TWO_PASS_DECODE_TU
DFFT_FUSE_SMOOTH(DFFT_FUSE_TWO_PASS_DECODE, extern)
#endif
#ifndef DFFT_FUSE_GENERIC_TWO_PASS_TU
DFFT_FUSE_TWO_PASS_ENCODE(extern, radix::kMaxPrime)
#endif
#ifndef DFFT_FUSE_GENERIC_TWO_PASS_DECODE_TU
DFFT_FUSE_TWO_PASS_DECODE(extern, radix::kMaxPrime)
#endif

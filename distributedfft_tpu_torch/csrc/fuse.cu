// Fused stage+codec kernels for Hopper (sm_90a): the port of the two
// Pallas mega-kernels of distributedfft_tpu/ops/pallas_fuse.py.
//
// Replaces (TPU kernel -> launcher here):
//   pallas_fuse.py:_make_encode_kernel (_encode_tiles)  -> dfft_fft_encode
//   pallas_fuse.py:_make_decode_kernel (_decode_tiles)  -> dfft_decode_fft
//
// Both work on the strided layout [lead, n, cols] with the DFT over the
// middle axis, so an axis-0, middle-axis or last-axis (cols = 1)
// transform needs no transposing copy. The wire payload keeps that layout
// with a trailing (re, im) pair: [lead, n, cols, 2]. Tiles cut the DFT
// axis into `tiles` segments of seg = n / tiles: the tile of an element
// is its OUTPUT index k for encode and its INPUT index j for decode
// (pallas_fuse.py:158-172, :207-210). The sidecar is [tiles, 2] f32: one
// power-of-two step per (tile, plane).
//
// Both kernels have two routes, chosen by the length alone
// (ops/cuda_fuse.py:fused_route). The radix route (dfft_fft_encode,
// dfft_decode_fft) takes every eligible length n <= 8192, the lengths
// the strided kernel takes by its radix route (four_step.cu): radix.cuh's
// column pass, the strided kernel's own, with the same plan, table,
// kernel variant and scale, a prime factor from 19 to 251 on the generic
// prime stage (its variants compiled in fuse_generic_encode.cu and
// fuse_generic_decode.cu, declared in fuse.cuh); only where a value comes
// from or goes to differs. The direct
// route (dfft_fft_encode_direct, dfft_decode_fft_direct) takes the
// eligible lengths past 8192, which the strided kernel takes by its
// two-pass route: it runs the four-step routine of four_step.cuh.
//
// fft_encode, radix route: the column pass (cols_kernel) with another
//   output in place of its complex64 store (the last stage's sink), so
//   each value is the one fft_axis0 would store, to the bit, and the
//   payload is the plain codec's on fft_axis0(x):
//   bf16        one launch: each (re, im) pair rounded to nearest even as
//               the last stage produces it (fuse.cuh: Bf16Out).
//   int8/split  three launches. The TPU kernel held the whole block in
//               VMEM for one grid step because the per-(tile, plane) amax
//               is a reduction over the block. Here launch A is the
//               column pass storing the c64 transform to device scratch
//               `y` (fft_axis0(x) itself) while each thread keeps running
//               maxima per tile in registers (fuse.cuh: C64AmaxOut); each
//               block merges them by one atomicMax per slot on the uint32
//               bits (valid because amax >= 0; the result does not depend
//               on the order of the blocks). Launch B turns the 2*tiles
//               amax slots into the sidecar's steps; launch C quantizes y
//               one tile's run of rows at a time: rintf (half to even) of
//               v / step, clamped to +-levels.
// fft_encode, direct route: the four-step routine, then the bf16 cast in
//   the same launch; or, quantized, launch A writes the c64 transform to
//   `y` and takes the amax, B and C as above.
// decode_fft, radix route: the column pass with another landing step: a
//   group's raw wire tile (2 bytes a value for int8, 4 for bf16 and
//   split) lands in shared memory by cp.async while the block works on
//   the group before, and the first stage unpacks each value as it reads
//   it (bf16 -> f32, or mantissa * the pow2 step of its input tile:
//   exact, the plain decode's value), so fused_decode_fft(parts) and
//   fft_axis0(decode(parts)) agree to the bit (fuse.cuh:
//   decode_cols_kernel). Direct route: unpack into shared memory or
//   device scratch, then the four-step routine.
//
// What bounds them on an H100: the decode's and the bf16 encode's radix
// routes do one column pass, which reads c64 or the wire once and writes
// the other once, as the strided kernel does, at ~80% of the copy rate
// (PERF.md). The quantized encode moves 8 + 8 + 8 + 2 or 4 bytes a value
// (x read, y written, y read, the wire written), twice the bound of one
// read and one write. Running the column pass a second time with the
// quantizer in its last stage, instead of storing y, moves fewer bytes
// (8 + 8 + 2 or 4) but measured slower on the H100: the column pass
// takes about a device copy's time even when it stores nothing, while
// launch C runs at the copy rate (PERF.md). The direct routes run the
// four-step sums (8*(n1+n2) flops per complex element, limited by
// shared-memory and L1 traffic); sequences longer than fit a block's
// shared memory run the four-step routine on device scratch.
//
// Every launcher returns cudaGetLastError() of its own launches.

#include "four_step.cuh"
#include "fuse.cuh"

namespace {

// The pow2 quantization step of `amax` in `levels` signed levels:
// 2^ceil(log2(amax / levels)), exponent clamped to [-126, 127], built from
// the exponent bits, 1.0 where amax == 0 (pallas_fuse.py:_pow2_step_block).
// log2 is evaluated as the JAX package's XLA evaluates it and as the plain
// codec (parallel/exchange.py:_pow2_step_levels) does: log(q) times f32
// 1/ln 2. Where q is within a few ulp of a power of two that expression
// can round to the integer, where an exact ceil (frexpf) would take the
// next power: the two steps differ by 2x there. A quantized round trip
// lands on exactly such q (amax = levels * 2^k up to fp32 noise), so only
// the same expression keeps the kernel's steps equal to the plain
// codec's and to the reference's.
__device__ __forceinline__ float pow2_step(float amax, float levels) {
  if (!(amax > 0.f)) return 1.0f;
  const float k = fminf(fmaxf(ceilf(logf(amax / levels) * 0x1.715476p+0f),
                              -126.f), 127.f);
  return __int_as_float(((int)k + 127) << 23);
}

// rint(v / step) clamped to +-levels: the plain codec's
// clamp(round(planes / step)), exact IEEE division (no fast math) by a
// power of two, rounding half to even.
__device__ __forceinline__ float quantize(float v, float step, float levels) {
  return fminf(fmaxf(rintf(v / step), -levels), levels);
}

// The int8 or int16 pair of a quantized value.
template <typename Q2>
__device__ __forceinline__ Q2 mantissas(float re, float im);
template <>
__device__ __forceinline__ char2 mantissas<char2>(float re, float im) {
  return make_char2((signed char)re, (signed char)im);
}
template <>
__device__ __forceinline__ short2 mantissas<short2>(float re, float im) {
  return make_short2((short)re, (short)im);
}

// Block geometry of the strided layout: block -> (lead index, first
// column, columns held).
struct Cols {
  long long base;
  int cnt;
};

__device__ __forceinline__ Cols block_cols(long long cols, int n, int seqs) {
  const long long nt = (cols + seqs - 1) / seqs;
  const long long l = blockIdx.x / nt;
  const long long c0 = (blockIdx.x % nt) * seqs;
  Cols c;
  c.base = l * n * cols + c0;
  c.cnt = (int)min((long long)seqs, cols - c0);
  return c;
}

// Launch A of fft_encode's direct route. MODE 0 (bf16): the transform,
// then the bf16 pair of each element into q. MODE 1 (int8/split): the
// transform into y, and the per-(tile, plane) amax into `amax` (uint32
// bits of |v|).
// scratch == nullptr: sequences in shared memory; otherwise the routine
// runs on device memory (scratch for its stage-1 result, y for output).
template <int MODE>
__global__ void __launch_bounds__(kThreads)
encode_fft_kernel(const float2* x, float2* y, float2* scratch,
                  __nv_bfloat162* q, unsigned* amax, long long cols, int n1,
                  int n2, int seqs, int tiles, const float2* w1,
                  const float2* tw, const float2* w2, float scale) {
  extern __shared__ float2 smem[];
  const int n = n1 * n2;
  const Cols blk = block_cols(cols, n, seqs);
  const int cnt = blk.cnt;
  const bool in_smem = scratch == nullptr;
  unsigned* bmax =
      reinterpret_cast<unsigned*>(smem + (in_smem ? 2LL * seqs * n : 0));
  if (MODE == 1)
    for (int i = threadIdx.x; i < 2 * tiles; i += blockDim.x) bmax[i] = 0u;
  const float2* out;
  long long sj;
  if (in_smem) {
    float2* a = smem;
    float2* b = smem + (long long)seqs * n;
    for (int i = threadIdx.x; i < cnt * n; i += blockDim.x) {
      const int s = i % cnt, j = i / cnt;
      a[s + j * seqs] = x[blk.base + (long long)j * cols + s];
    }
    __syncthreads();
    four_step<true>(a, b, a, 1, seqs, cnt, n1, n2, w1, tw, w2, scale);
    out = a;
    sj = seqs;
  } else {
    __syncthreads();
    four_step<true>(x + blk.base, scratch + blk.base, y + blk.base, 1, cols,
                    cnt, n1, n2, w1, tw, w2, scale);
    out = y + blk.base;
    sj = cols;
  }
  __syncthreads();
  if (MODE == 0) {
    for (int i = threadIdx.x; i < cnt * n; i += blockDim.x) {
      const int s = i % cnt, k = i / cnt;
      const float2 v = out[s + k * sj];
      q[blk.base + (long long)k * cols + s] = __floats2bfloat162_rn(v.x, v.y);
    }
    return;
  }
  // Each thread's items step through k in order, so it keeps a running
  // max and flushes it to shared memory when its tile changes.
  const int seg = n / tiles;
  int cur = -1;
  float mr = 0.f, mi = 0.f;
  for (int i = threadIdx.x; i < cnt * n; i += blockDim.x) {
    const int s = i % cnt, k = i / cnt;
    const float2 v = out[s + k * sj];
    if (in_smem) y[blk.base + (long long)k * cols + s] = v;
    const int t = k / seg;
    if (t != cur) {
      if (cur >= 0) {
        atomicMax(&bmax[2 * cur], __float_as_uint(mr));
        atomicMax(&bmax[2 * cur + 1], __float_as_uint(mi));
      }
      cur = t;
      mr = 0.f;
      mi = 0.f;
    }
    mr = fmaxf(mr, fabsf(v.x));
    mi = fmaxf(mi, fabsf(v.y));
  }
  if (cur >= 0) {
    atomicMax(&bmax[2 * cur], __float_as_uint(mr));
    atomicMax(&bmax[2 * cur + 1], __float_as_uint(mi));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * tiles; i += blockDim.x)
    if (bmax[i] != 0u) atomicMax(&amax[i], bmax[i]);
}

// Launch B of fft_encode (both routes): the [tiles, 2] sidecar of pow2
// steps from the amax slots, one thread per slot.
__global__ void __launch_bounds__(kThreads)
steps_kernel(const unsigned* amax, float* side, int slots, float levels) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < slots) side[i] = pow2_step(__uint_as_float(amax[i]), levels);
}

// Launch C of fft_encode (both routes): quantize y [lead, n, cols] into
// q [lead, n, cols, 2] (Q2: char2 for int8, short2 for int16) with the
// steps of each value's (tile, plane). The values of one (lead index,
// tile) are one contiguous run of `run` = (n / tiles) * cols values
// sharing one pair of steps: blockIdx.x picks the run (its tile found
// once), blockIdx.y and the threads stride over it. No value needs index
// arithmetic of its own, and a narrow array (the last axis, cols = 1)
// still fills its blocks. An elementwise pass at the copy rate.
template <typename Q2>
__global__ void __launch_bounds__(kThreads)
quantize_tiles(const float2* y, Q2* q, const float* side, long long run,
               int tiles, float levels) {
  const int t = (int)(blockIdx.x % tiles);
  const float sr = __ldg(&side[2 * t]), si = __ldg(&side[2 * t + 1]);
  const float2* yr = y + (long long)blockIdx.x * run;
  Q2* qr = q + (long long)blockIdx.x * run;
  for (long long c = (long long)blockIdx.y * blockDim.x + threadIdx.x;
       c < run; c += (long long)gridDim.y * blockDim.x) {
    const float2 v = yr[c];
    qr[c] = mantissas<Q2>(quantize(v.x, sr, levels),
                          quantize(v.y, si, levels));
  }
}

cudaError_t launch_quantize(const float2* y, void* q, const float* side,
                            long long lead, int n, long long cols, int tiles,
                            int codec, float levels, cudaStream_t st) {
  const long long runs = lead * tiles, run = (long long)(n / tiles) * cols;
  if (runs == 0 || run == 0) return cudaSuccess;
  const int threads =
      run >= kThreads ? kThreads : (int)((run + 31) / 32 * 32);
  const dim3 grid((unsigned)runs,
                  (unsigned)std::min<long long>(
                      (run + 4LL * threads - 1) / (4LL * threads), 65535));
  if (codec == 1)
    quantize_tiles<char2><<<grid, threads, 0, st>>>(y, (char2*)q, side, run,
                                                    tiles, levels);
  else
    quantize_tiles<short2><<<grid, threads, 0, st>>>(y, (short2*)q, side,
                                                     run, tiles, levels);
  return cudaGetLastError();
}

// decode_fft by the direct route: CODEC 0 bf16, 1 int8, 2 int16 (split).
// The unpacked block goes into shared memory, or into y itself when the
// sequences do not fit (the routine then runs in place on y with
// `scratch` for stage 1).
template <int CODEC>
__global__ void __launch_bounds__(kThreads)
decode_fft_kernel(const void* q, const float* side, float2* y,
                  float2* scratch, long long cols, int n1, int n2, int seqs,
                  int tiles, const float2* w1, const float2* tw,
                  const float2* w2, float scale) {
  extern __shared__ float2 smem[];
  const int n = n1 * n2;
  const int seg = n / tiles;
  const Cols blk = block_cols(cols, n, seqs);
  const int cnt = blk.cnt;
  const char* qb = static_cast<const char*>(q);
  if (scratch != nullptr) {
    for (int i = threadIdx.x; i < cnt * n; i += blockDim.x) {
      const int s = i % cnt, j = i / cnt;
      const long long e = blk.base + (long long)j * cols + s;
      y[e] = fuse::unpack<CODEC>(qb + e * fuse::pair_bytes(CODEC), side,
                                   j / seg);
    }
    __syncthreads();
    four_step<true>(y + blk.base, scratch + blk.base, y + blk.base, 1, cols,
                    cnt, n1, n2, w1, tw, w2, scale);
    return;
  }
  float2* a = smem;
  float2* b = smem + (long long)seqs * n;
  for (int i = threadIdx.x; i < cnt * n; i += blockDim.x) {
    const int s = i % cnt, j = i / cnt;
    a[s + j * seqs] = fuse::unpack<CODEC>(
        qb + (blk.base + (long long)j * cols + s) * fuse::pair_bytes(CODEC),
        side, j / seg);
  }
  __syncthreads();
  four_step<true>(a, b, a, 1, seqs, cnt, n1, n2, w1, tw, w2, scale);
  __syncthreads();
  for (int i = threadIdx.x; i < cnt * n; i += blockDim.x) {
    const int s = i % cnt, j = i / cnt;
    y[blk.base + (long long)j * cols + s] = a[s + j * seqs];
  }
}

using DecodeKernel = void (*)(const void*, const float*, float2*, long long,
                              long long, radix::Plan, int, radix::Smem, int,
                              const float2*, float);

// The decode kernel of a codec and direction that compiles the radices up
// to MAXR (8, kMaxHand or kMaxPrime: radix.cuh's stage_r).
template <int MAXR>
DecodeKernel decode_kernel(int codec, bool fwd) {
#define DFFT_DECODE(C)                                 \
  (fwd ? fuse::decode_cols_kernel<C, true, MAXR>       \
       : fuse::decode_cols_kernel<C, false, MAXR>)
  return codec == 0 ? DFFT_DECODE(0) : codec == 1 ? DFFT_DECODE(1)
                                                  : DFFT_DECODE(2);
#undef DFFT_DECODE
}

// The complex64 a landed wire tile of c columns takes, even so that the
// exchange buffers after it stay 16-byte aligned; never more than a c64
// tile (n*c), so that without prefetch the exchange buffer b can be it.
int wire_land(int n, int c, int pb) {
  const long long bytes = (long long)n * radix::wire_ld(c * pb, false);
  return (int)((bytes + 15) / 16 * 2);
}

int wire_cols(const radix::Plan& p, long long nz, int pb) {
  const int n = p.n;
  return radix::cols_per_group(
      p, nz, [=](int c) { return wire_land(n, c, pb); });
}

// The decode pass over [lead, n, nz] of one codec and direction; its
// kernel variant is the plan's (radix.cuh:Pass), the generic one
// (fuse_generic_decode.cu) for a prime factor over 17.
struct DecodePass : radix::Pass<DecodeKernel> {
  int tiles;
  DecodePass(const radix::Plan& p, bool fwd, int codec, long long nz,
             int tiles_)
      : Pass(p, wire_cols(p, nz, fuse::pair_bytes(codec)),
             p.n * wire_cols(p, nz, fuse::pair_bytes(codec)),
             wire_land(p.n, wire_cols(p, nz, fuse::pair_bytes(codec)),
                       fuse::pair_bytes(codec)),
             2 * (size_t)tiles_ * sizeof(float), decode_kernel<8>(codec, fwd),
             decode_kernel<radix::kMaxHand>(codec, fwd),
             decode_kernel<radix::kMaxPrime>(codec, fwd)),
        tiles(tiles_) {}
  cudaError_t operator()(const void* q, const float* side, float2* y,
                         long long lead, long long nz, const float2* tw,
                         float scale, cudaStream_t st) {
    const long long b = blocks(lead * ((nz + group - 1) / group));
    if (b > 0)
      kernel<<<(unsigned)b, radix::kThreads, shm, st>>>(
          q, side, y, lead, nz, plan, group, sm, tiles, tw, scale);
    return cudaGetLastError();
  }
};

template <typename K>
cudaError_t allow_smem(K kernel, size_t shm) {
  if (shm == 0) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shm);
}

}  // namespace

extern "C" {

// Wire-encode the DFT over the middle axis of x [lead, n, cols] (scaled
// by `scale`) into q [lead, n, cols, 2]: codec 0 bf16, 1 int8, 2 int16
// (split), `levels` signed levels. The radix route: n with the stage
// radices radices[0..stages-1] (host memory) and the stage twiddles tw
// (device memory), as dfft_fft_strided takes them. bf16: one launch.
// Codecs 1-2: `y` is a c64 scratch of x's size, `amax` a scratch of
// 2*tiles uint32 (zeroed here) and `side` the [tiles, 2] f32 sidecar
// out; three launches (transform into y with the amax, steps, quantize).
int dfft_fft_encode(const void* x, void* y, void* q, void* amax, void* side,
                    long long lead, long long cols, int n, int stages,
                    const int* radices, int tiles, int codec, float levels,
                    int forward, const void* tw, float scale, void* stream) {
  const radix::Plan plan = radix::make_plan(n, stages, radices);
  if (!radix::valid_plan(plan) || codec < 0 || codec > 2 || tiles < 1 ||
      n % tiles != 0)
    return (int)cudaErrorInvalidValue;
  const bool fwd = forward != 0;
  const float2* fx = (const float2*)x;
  const float2* ftw = (const float2*)tw;
  const cudaStream_t st = (cudaStream_t)stream;
  if (codec == 0) {
    radix::ColsPass<fuse::Bf16Out> pass(plan, fwd, cols);
    if (pass.err != cudaSuccess) return (int)pass.err;
    return (int)pass(fx, fuse::Bf16Out{(__nv_bfloat162*)q}, lead, cols, ftw,
                     scale, st);
  }
  const int slots = 2 * tiles;
  radix::ColsPass<fuse::C64AmaxOut> pass(plan, fwd, cols,
                                         slots * sizeof(unsigned));
  if (pass.err != cudaSuccess) return (int)pass.err;
  cudaError_t e = cudaMemsetAsync(amax, 0, slots * sizeof(unsigned), st);
  if (e != cudaSuccess) return (int)e;
  e = pass(
      fx, fuse::C64AmaxOut{(float2*)y, (unsigned*)amax, tiles, n / tiles},
      lead, cols, ftw, scale, st);
  if (e != cudaSuccess) return (int)e;
  steps_kernel<<<(slots + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      (const unsigned*)amax, (float*)side, slots, levels);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)launch_quantize((const float2*)y, q, (const float*)side, lead,
                              n, cols, tiles, codec, levels, st);
}

// The same by the direct route (the four-step routine; the eligible
// lengths past 8192): n = n1*n2, LUTs w1, tw, w2, `seqs` columns per
// block. For codecs 1-2, `y` is a c64
// scratch of x's size and `amax` as above. scratch == nullptr: sequences
// in shared memory (then `y` may be nullptr for bf16).
int dfft_fft_encode_direct(const void* x, void* y, void* scratch, void* q,
                           void* amax, void* side, long long lead,
                           long long cols, int n1, int n2, int seqs,
                           int tiles, int codec, float levels, const void* w1,
                           const void* tw, const void* w2, float scale,
                           void* stream) {
  const int n = n1 * n2;
  const long long blocks = lead * ((cols + seqs - 1) / seqs);
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t seq_shm =
      scratch == nullptr ? 2ull * seqs * n * sizeof(float2) : 0;
  const float2 *fx = (const float2*)x, *fw1 = (const float2*)w1,
               *ftw = (const float2*)tw, *fw2 = (const float2*)w2;
  float2 *fy = (float2*)y, *fs = (float2*)scratch;
  cudaError_t e;
  if (codec == 0) {
    e = allow_smem(encode_fft_kernel<0>, seq_shm);
    if (e != cudaSuccess) return (int)e;
    if (blocks > 0)
      encode_fft_kernel<0><<<(unsigned)blocks, kThreads, seq_shm, st>>>(
          fx, fy, fs, (__nv_bfloat162*)q, nullptr, cols, n1, n2, seqs, tiles,
          fw1, ftw, fw2, scale);
    return (int)cudaGetLastError();
  }
  const int slots = 2 * tiles;
  const size_t shm = seq_shm + slots * sizeof(unsigned);
  e = allow_smem(encode_fft_kernel<1>, shm);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemsetAsync(amax, 0, slots * sizeof(unsigned), st);
  if (e != cudaSuccess) return (int)e;
  if (blocks > 0)
    encode_fft_kernel<1><<<(unsigned)blocks, kThreads, shm, st>>>(
        fx, fy, fs, nullptr, (unsigned*)amax, cols, n1, n2, seqs, tiles, fw1,
        ftw, fw2, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  steps_kernel<<<(slots + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      (const unsigned*)amax, (float*)side, slots, levels);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)launch_quantize(fy, q, (const float*)side, lead, n, cols, tiles,
                              codec, levels, st);
}

// Decode q [lead, n, cols, 2] (codec 0 bf16, 1 int8, 2 int16; `side` the
// [tiles, 2] f32 steps, unused for bf16) and DFT the middle axis into y
// [lead, n, cols] c64, scaled by `scale`: the radix route, n with the
// stage radices radices[0..stages-1] (host memory) and the stage twiddles
// tw (device memory), as dfft_fft_strided takes them.
int dfft_decode_fft(const void* q, const void* side, void* y, long long lead,
                    long long cols, int n, int stages, const int* radices,
                    int tiles, int codec, int forward, const void* tw,
                    float scale, void* stream) {
  const radix::Plan plan = radix::make_plan(n, stages, radices);
  if (!radix::valid_plan(plan) || codec < 0 || codec > 2 || tiles < 1 ||
      n % tiles != 0)
    return (int)cudaErrorInvalidValue;
  DecodePass pass(plan, forward != 0, codec, cols, tiles);
  if (pass.err != cudaSuccess) return (int)pass.err;
  return (int)pass(q, (const float*)side, (float2*)y, lead, cols,
                   (const float2*)tw, scale, (cudaStream_t)stream);
}

// The same by the direct route (the eligible lengths past 8192): n =
// n1*n2, LUTs w1, tw, w2, `seqs` columns per block. scratch == nullptr: sequences in shared memory;
// otherwise a c64 scratch of y's size.
int dfft_decode_fft_direct(const void* q, const void* side, void* y,
                           void* scratch, long long lead, long long cols,
                           int n1, int n2, int seqs, int tiles, int codec,
                           const void* w1, const void* tw, const void* w2,
                           float scale, void* stream) {
  const int n = n1 * n2;
  const long long blocks = lead * ((cols + seqs - 1) / seqs);
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t shm = scratch == nullptr ? 2ull * seqs * n * sizeof(float2) : 0;
  const float* fside = (const float*)side;
  const float2 *fw1 = (const float2*)w1, *ftw = (const float2*)tw,
               *fw2 = (const float2*)w2;
  float2 *fy = (float2*)y, *fs = (float2*)scratch;
  cudaError_t e;
  if (codec == 0) {
    e = allow_smem(decode_fft_kernel<0>, shm);
    if (e != cudaSuccess) return (int)e;
    if (blocks > 0)
      decode_fft_kernel<0><<<(unsigned)blocks, kThreads, shm, st>>>(
          q, fside, fy, fs, cols, n1, n2, seqs, tiles, fw1, ftw, fw2, scale);
  } else if (codec == 1) {
    e = allow_smem(decode_fft_kernel<1>, shm);
    if (e != cudaSuccess) return (int)e;
    if (blocks > 0)
      decode_fft_kernel<1><<<(unsigned)blocks, kThreads, shm, st>>>(
          q, fside, fy, fs, cols, n1, n2, seqs, tiles, fw1, ftw, fw2, scale);
  } else {
    e = allow_smem(decode_fft_kernel<2>, shm);
    if (e != cudaSuccess) return (int)e;
    if (blocks > 0)
      decode_fft_kernel<2><<<(unsigned)blocks, kThreads, shm, st>>>(
          q, fside, fy, fs, cols, n1, n2, seqs, tiles, fw1, ftw, fw2, scale);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"

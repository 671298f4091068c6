// Fused stage+codec kernels for Hopper (sm_90a): the port of the two
// Pallas mega-kernels of distributedfft_tpu/ops/pallas_fuse.py.
//
// Replaces (TPU kernel -> launchers here):
//   pallas_fuse.py:_make_encode_kernel (_encode_tiles)  -> dfft_fft_encode,
//                                                          dfft_fft_encode_2p
//   pallas_fuse.py:_make_decode_kernel (_decode_tiles)  -> dfft_decode_fft,
//                                                          dfft_decode_fft_2p
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
// Each runs the passes of its unfused twin (the strided or row kernel of
// four_step.cu, then the plain codec; or the plain codec, then the
// kernel) with the same plans, tables, kernel variants and scale, by the
// same route (ops/cuda_fuse.py:fused_route is cuda_fft.route); only where
// a value comes from or goes to differs, so every fused output equals its
// twin's bit for bit. By route and column count:
//   radix, cols > 1   (n <= 8192) radix.cuh's column pass (cols_kernel,
//                     the strided kernel's), a prime factor from 19 to 251
//                     on the generic prime stage;
//   radix, cols = 1   the row form: radix.cuh's rows pass (rows_kernel,
//                     the row kernel's), as fft_last runs a last-axis site;
//   radix2            (8192 < n <= 65536) the two-pass route of
//                     four_step.cu: n = m1*m2, pass 1 the column pass of m1
//                     with the four-step twiddle in its store (TwiddleOut),
//                     pass 2 the pass of m2 with the reordering store
//                     (ReorderOut; at cols = 1 the rows pass with the
//                     transposed store, TransposeOut), through a c64
//                     scratch of the data's size.
// The generic-stage variants and the row form's and two-pass route's
// kernels are compiled in translation units of their own (fuse.cuh).
//
// fft_encode: the pass that stores the transform (the only one, or the
//   two-pass route's second) takes another output in place of its
//   complex64 store (the last stage's sink), so each value is the one
//   the twin would store, to the bit, and the payload is the plain
//   codec's on it:
//   bf16        each (re, im) pair rounded to nearest even as the last
//               stage produces it (fuse.cuh: Bf16Out, Bf16Pack).
//   int8/split  the TPU kernel held the whole block in VMEM for one grid
//               step because the per-(tile, plane) amax is a reduction
//               over the block. Here launch A is the pass storing the c64
//               transform to device scratch `y` (the twin's output
//               itself) while each thread keeps running maxima per tile
//               of the output index k in registers (fuse.cuh:
//               C64AmaxOut, AmaxPack; on the two-pass route k = k1 +
//               m1*k2, not the pass's own index); each block merges them
//               by one atomicMax per slot on the uint32 bits (valid
//               because amax >= 0; the result does not depend on the
//               order of the blocks). Launch B turns the 2*tiles amax
//               slots into the sidecar's steps; launch C quantizes y one
//               tile's run of rows at a time: rintf (half to even) of v /
//               step, clamped to +-levels.
// decode_fft: the pass that reads the input (the only one, or the
//   two-pass route's first) takes another landing step: a group's raw
//   wire (2 bytes a value for int8, 4 for bf16 and split) lands in shared
//   memory by cp.async while the block works on the group before, and the
//   first stage unpacks each value as it reads it (bf16 -> f32, or
//   mantissa * the pow2 step of its input tile j / seg: exact, the plain
//   decode's value; on the two-pass route j = j1*m2 + j2), so the decode
//   equals the twin's transform of decode(parts) to the bit (fuse.cuh:
//   decode_cols_kernel, decode_rows_kernel, decode_first_kernel); the
//   two-pass route's second pass is the strided kernel's own.
//
// What bounds them on an H100: bytes. The decode's and the bf16 encode's
// one-pass routes read c64 or the wire once and write the other once, as
// the strided and row kernels do; the two-pass route reads and writes
// twice (the scratch), as kernels 2 and 3 do past 8192. The quantized
// encode moves 8 + 8 + 8 + 2 or 4 bytes a value in its last pass and
// launch C (x read, y written, y read, the wire written), twice the bound
// of one read and one write. Running the pass a second time with the
// quantizer in its last stage, instead of storing y, moves fewer bytes
// (8 + 8 + 2 or 4) but measured slower on the H100: the column pass
// takes about a device copy's time even when it stores nothing, while
// launch C runs at the copy rate (PERF.md).
//
// Every launcher returns cudaGetLastError() of its own launches.

#include "fuse.cuh"

namespace {

// Threads of the steps and quantize launches.
constexpr int kThreads = 256;

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

// Launch B of fft_encode: the [tiles, 2] sidecar of pow2
// steps from the amax slots, one thread per slot.
__global__ void __launch_bounds__(kThreads)
steps_kernel(const unsigned* amax, float* side, int slots, float levels) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < slots) side[i] = pow2_step(__uint_as_float(amax[i]), levels);
}

// Launch C of fft_encode: quantize y [lead, n, cols] into
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

// An encode around its storing pass: store(pack, extra) runs the pass
// that stores the transform into a codec pack (fuse.cuh) whose
// begin(extra) takes `extra` bytes of shared memory. bf16: the pass into
// Bf16Pack{q}, one launch. Codecs 1-2: the amax slots zeroed, the pass
// into AmaxPack (y, the slots), then launches B and C.
template <typename Store>
cudaError_t encode(Store store, void* y, void* q, void* amax, void* side,
                   long long lead, int n, long long cols, int tiles,
                   int codec, float levels, cudaStream_t st) {
  if (codec == 0) return store(fuse::Bf16Pack{(__nv_bfloat162*)q}, 0);
  const int slots = 2 * tiles;
  cudaError_t e = cudaMemsetAsync(amax, 0, slots * sizeof(unsigned), st);
  if (e != cudaSuccess) return e;
  e = store(fuse::AmaxPack{(float2*)y, (unsigned*)amax, tiles, n / tiles},
            slots * sizeof(unsigned));
  if (e != cudaSuccess) return e;
  steps_kernel<<<(slots + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      (const unsigned*)amax, (float*)side, slots, levels);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_quantize((const float2*)y, q, (const float*)side, lead, n,
                         cols, tiles, codec, levels, st);
}

// The radix route's column pass over x [lead, n, cols] into a pack: its
// column output (fuse.cuh: Bf16Out, C64AmaxOut).
cudaError_t column_encode(const float2* x, fuse::Bf16Pack pack, size_t,
                          long long lead, long long cols,
                          const radix::Plan& plan, bool fwd,
                          const float2* tw, float scale, cudaStream_t st) {
  radix::ColsPass<fuse::Bf16Out> pass(plan, fwd, cols);
  if (pass.err != cudaSuccess) return pass.err;
  return pass(x, fuse::Bf16Out{pack.q}, lead, cols, tw, scale, st);
}
cudaError_t column_encode(const float2* x, fuse::AmaxPack pack, size_t extra,
                          long long lead, long long cols,
                          const radix::Plan& plan, bool fwd,
                          const float2* tw, float scale, cudaStream_t st) {
  radix::ColsPass<fuse::C64AmaxOut> pass(plan, fwd, cols, extra);
  if (pass.err != cudaSuccess) return pass.err;
  return pass(x, fuse::C64AmaxOut{pack}, lead, cols, tw, scale, st);
}

// The row form over x [batch, n] into a pack: the row kernel's rows pass
// (its group size) with fuse.cuh's RowCodecOut.
template <typename Pack>
cudaError_t row_encode(const float2* x, Pack pack, size_t extra,
                       long long batch, const radix::Plan& plan, bool fwd,
                       const float2* tw, float scale, cudaStream_t st) {
  using Out = fuse::RowCodecOut<Pack>;
  radix::RowsPass<Out> pass(plan, fwd, radix::rows_per_group(plan), extra);
  if (pass.err != cudaSuccess) return pass.err;
  return pass(x, Out{pack, plan.n}, batch, tw, scale, st);
}

// The two-pass route's second pass over the scratch s into a pack: the
// strided kernel's second pass (radix::two_pass_second) with fuse.cuh's
// ReorderCodecOut, or at cols = 1 TransposeCodecOut, in place of its
// complex64 store.
template <typename Pack>
cudaError_t two_pass_encode(const float2* s, Pack pack, size_t extra,
                            long long lead, long long cols, int m1,
                            const radix::Plan& p2, bool fwd,
                            const float2* tw2, float scale,
                            cudaStream_t st) {
  const int m2 = p2.n;
  if (cols == 1) {
    using Out = fuse::TransposeCodecOut<Pack>;
    auto bytes = [=](int seqs) {
      return radix::TransposeOut::bytes(m2, seqs) + extra;
    };
    const int g = radix::rows_per_group(p2, 16, bytes);
    radix::RowsPass<Out> pass(p2, fwd, g, bytes(g));
    if (pass.err != cudaSuccess) return pass.err;
    return pass(s, Out{pack, m1, m2, radix::odd_ld(g)}, lead * m1, tw2,
                scale, st);
  }
  using Out = fuse::ReorderCodecOut<Pack>;
  radix::ColsPass<Out> pass(p2, fwd, cols, extra, radix::two_pass_most(p2));
  if (pass.err != cudaSuccess) return pass.err;
  return pass(s, Out{pack, cols, m1, m2}, lead * m1, cols, tw2, scale, st);
}

// The kernel of a codec and direction (a fuse.cuh decode kernel template
// K) that compiles the radices up to MAXR (radix.cuh's stage_r).
#define DFFT_DECODE_KERNEL(K, MAXR)                                        \
  (codec == 0   ? (fwd ? K<0, true, MAXR> : K<0, false, MAXR>)             \
   : codec == 1 ? (fwd ? K<1, true, MAXR> : K<1, false, MAXR>)             \
                : (fwd ? K<2, true, MAXR> : K<2, false, MAXR>))

// The complex64 a landed wire tile of c columns takes, even so that the
// exchange buffers after it stay 16-byte aligned; never more than a c64
// tile (n*c), so that without prefetch the exchange buffer b can be it.
int wire_land(int n, int c, int pb) {
  const long long bytes = (long long)n * radix::wire_ld(c * pb, false);
  return (int)((bytes + 15) / 16 * 2);
}

int wire_cols(const radix::Plan& p, long long nz, int pb, int most = 16) {
  const int n = p.n;
  return radix::cols_per_group(
      p, nz, [=](int c) { return wire_land(n, c, pb); }, most);
}

template <typename Out>
using DecodeColsKernel = void (*)(const void*, const float*, Out, long long,
                                  long long, radix::Plan, int, radix::Smem,
                                  int, const float2*, float);

// A decode column pass over [lead, n, nz] of one codec into `Out`
// (float2*: fuse.cuh's decode_cols_kernel; TwiddleOut: the two-pass
// route's decode_first_kernel), groups of up to `most` columns;
// its kernel variant is the plan's (radix.cuh:Pass), the generic one for
// a prime factor over 17.
template <typename Out>
struct DecodePass : radix::Pass<DecodeColsKernel<Out>> {
  using Kernel = DecodeColsKernel<Out>;
  int tiles;
  DecodePass(const radix::Plan& p, int codec, long long nz, int tiles_,
             int most, Kernel k8, Kernel k17, Kernel kgen)
      : radix::Pass<Kernel>(
            p, wire_cols(p, nz, fuse::pair_bytes(codec), most),
            p.n * wire_cols(p, nz, fuse::pair_bytes(codec), most),
            wire_land(p.n, wire_cols(p, nz, fuse::pair_bytes(codec), most),
                      fuse::pair_bytes(codec)),
            2 * (size_t)tiles_ * sizeof(float), k8, k17, kgen),
        tiles(tiles_) {}
  cudaError_t operator()(const void* q, const float* side, Out out,
                         long long lead, long long nz, const float2* tw,
                         float scale, cudaStream_t st) {
    const int group = this->group;
    const long long b = this->blocks(lead * ((nz + group - 1) / group));
    const Kernel kernel = this->kernel;
    if (b > 0)
      kernel<<<(unsigned)b, radix::kThreads, this->shm, st>>>(
          q, side, out, lead, nz, this->plan, group, this->sm, tiles, tw,
          scale);
    return cudaGetLastError();
  }
};

DecodePass<float2*> column_decode(const radix::Plan& p, bool fwd, int codec,
                                  long long nz, int tiles) {
  return DecodePass<float2*>(
      p, codec, nz, tiles, 16, DFFT_DECODE_KERNEL(fuse::decode_cols_kernel, 8),
      DFFT_DECODE_KERNEL(fuse::decode_cols_kernel, radix::kMaxHand),
      DFFT_DECODE_KERNEL(fuse::decode_cols_kernel, radix::kMaxPrime));
}

DecodePass<radix::TwiddleOut> first_pass_decode(const radix::Plan& p1,
                                                bool fwd, int codec,
                                                long long nz, int tiles) {
  return DecodePass<radix::TwiddleOut>(
      p1, codec, nz, tiles, radix::two_pass_most(p1),
      DFFT_DECODE_KERNEL(fuse::decode_first_kernel, 8),
      DFFT_DECODE_KERNEL(fuse::decode_first_kernel, radix::kMaxHand),
      DFFT_DECODE_KERNEL(fuse::decode_first_kernel, radix::kMaxPrime));
}

using DecodeRowsKernel = void (*)(const void*, const float*, float2*,
                                  long long, radix::Plan, int, radix::Smem,
                                  int, const float2*, float);

// The complex64 a landed range of `rows` wire rows takes (fuse.cuh:
// wire_rows_bytes), even; never more than the exchange buffer of those
// rows, so that without prefetch b can be it.
int wire_rows_land(int n, int rows, int pb) {
  return (int)((fuse::wire_rows_bytes(rows, n * pb) + 15) / 16 * 2);
}

// The decode's row form over [batch, n] of one codec (fuse.cuh:
// decode_rows_kernel), the row kernel's group size.
struct DecodeRowsPass : radix::Pass<DecodeRowsKernel> {
  int tiles;
  DecodeRowsPass(const radix::Plan& p, bool fwd, int codec, int tiles_)
      : Pass(p, radix::rows_per_group(p),
             radix::rows_per_group(p) * radix::padded_ld(p.n),
             wire_rows_land(p.n, radix::rows_per_group(p),
                            fuse::pair_bytes(codec)),
             2 * (size_t)tiles_ * sizeof(float),
             DFFT_DECODE_KERNEL(fuse::decode_rows_kernel, 8),
             DFFT_DECODE_KERNEL(fuse::decode_rows_kernel, radix::kMaxHand),
             DFFT_DECODE_KERNEL(fuse::decode_rows_kernel, radix::kMaxPrime)),
        tiles(tiles_) {}
  cudaError_t operator()(const void* q, const float* side, float2* y,
                         long long batch, const float2* tw, float scale,
                         cudaStream_t st) {
    const long long b = blocks((batch + group - 1) / group);
    if (b > 0)
      kernel<<<(unsigned)b, radix::kThreads, shm, st>>>(
          q, side, y, batch, plan, group, sm, tiles, tw, scale);
    return cudaGetLastError();
  }
};

#undef DFFT_DECODE_KERNEL

bool valid_codec(int codec, int tiles, int n) {
  return codec >= 0 && codec <= 2 && tiles >= 1 && n % tiles == 0;
}

}  // namespace

extern "C" {

// Wire-encode the DFT over the middle axis of x [lead, n, cols] (scaled
// by `scale`) into q [lead, n, cols, 2]: codec 0 bf16, 1 int8, 2 int16
// (split), `levels` signed levels. The radix route: n with the stage
// radices radices[0..stages-1] (host memory) and the stage twiddles tw
// (device memory), as dfft_fft_strided takes them; the column pass, or
// at cols = 1 the row form (the row kernel's rows pass). bf16: one
// launch. Codecs 1-2: `y` is a c64 scratch of x's size, `amax` a scratch
// of 2*tiles uint32 (zeroed here) and `side` the [tiles, 2] f32 sidecar
// out; three launches (transform into y with the amax, steps, quantize).
int dfft_fft_encode(const void* x, void* y, void* q, void* amax, void* side,
                    long long lead, long long cols, int n, int stages,
                    const int* radices, int tiles, int codec, float levels,
                    int forward, const void* tw, float scale, void* stream) {
  const radix::Plan plan = radix::make_plan(n, stages, radices);
  if (!radix::valid_plan(plan) || !valid_codec(codec, tiles, n))
    return (int)cudaErrorInvalidValue;
  const bool fwd = forward != 0;
  const float2* fx = (const float2*)x;
  const float2* ftw = (const float2*)tw;
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)encode(
      [&](auto pack, size_t extra) {
        return cols == 1 ? row_encode(fx, pack, extra, lead, plan, fwd, ftw,
                                      scale, st)
                         : column_encode(fx, pack, extra, lead, cols, plan,
                                         fwd, ftw, scale, st);
      },
      y, q, amax, side, lead, n, cols, tiles, codec, levels, st);
}

// The same by the two-pass route (the eligible lengths past 8192): n =
// m1*m2, plans, tables tw1, tw2 and tt as dfft_fft_strided_2p takes
// them, `scratch` a c64 scratch of x's size (neither x nor y). Pass 1 of
// the strided kernel's two into scratch, then its pass 2 storing through
// the codec (bf16: the payload; codecs 1-2: y with the amax, then steps
// and quantize).
int dfft_fft_encode_2p(const void* x, void* y, void* scratch, void* q,
                       void* amax, void* side, long long lead,
                       long long cols, int tiles, int codec, float levels,
                       int m1, int stages1, const int* radices1, int m2,
                       int stages2, const int* radices2, int forward,
                       const void* tw1, const void* tw2, const void* tt,
                       float scale, void* stream) {
  const radix::Plan p1 = radix::make_plan(m1, stages1, radices1);
  const radix::Plan p2 = radix::make_plan(m2, stages2, radices2);
  const int n = m1 * m2;
  if (!radix::valid_plan(p1) || !radix::valid_plan(p2) ||
      !valid_codec(codec, tiles, n) || scratch == nullptr || scratch == x ||
      scratch == y || scratch == q)
    return (int)cudaErrorInvalidValue;
  const bool fwd = forward != 0;
  const float2* s = (const float2*)scratch;
  const float2* ftw2 = (const float2*)tw2;
  const cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t e = radix::two_pass_first(
      (const float2*)x, (float2*)scratch, lead, cols, p1, m2, fwd,
      (const float2*)tw1, (const float2*)tt, st);
  if (e != cudaSuccess) return (int)e;
  return (int)encode(
      [&](auto pack, size_t extra) {
        return two_pass_encode(s, pack, extra, lead, cols, m1, p2, fwd, ftw2,
                               scale, st);
      },
      y, q, amax, side, lead, n, cols, tiles, codec, levels, st);
}

// Decode q [lead, n, cols, 2] (codec 0 bf16, 1 int8, 2 int16; `side` the
// [tiles, 2] f32 steps, unused for bf16) and DFT the middle axis into y
// [lead, n, cols] c64, scaled by `scale`: the radix route, n with the
// stage radices radices[0..stages-1] (host memory) and the stage twiddles
// tw (device memory), as dfft_fft_strided takes them; the column pass,
// or at cols = 1 the row form.
int dfft_decode_fft(const void* q, const void* side, void* y, long long lead,
                    long long cols, int n, int stages, const int* radices,
                    int tiles, int codec, int forward, const void* tw,
                    float scale, void* stream) {
  const radix::Plan plan = radix::make_plan(n, stages, radices);
  if (!radix::valid_plan(plan) || !valid_codec(codec, tiles, n))
    return (int)cudaErrorInvalidValue;
  const bool fwd = forward != 0;
  if (cols == 1) {
    DecodeRowsPass pass(plan, fwd, codec, tiles);
    if (pass.err != cudaSuccess) return (int)pass.err;
    return (int)pass(q, (const float*)side, (float2*)y, lead,
                     (const float2*)tw, scale, (cudaStream_t)stream);
  }
  DecodePass<float2*> pass = column_decode(plan, fwd, codec, cols, tiles);
  if (pass.err != cudaSuccess) return (int)pass.err;
  return (int)pass(q, (const float*)side, (float2*)y, lead, cols,
                   (const float2*)tw, scale, (cudaStream_t)stream);
}

// The same by the two-pass route (the eligible lengths past 8192): plans,
// tables and `scratch` (a c64 scratch of y's size, not y) as
// dfft_fft_encode_2p takes them. Pass 1 reads the wire into scratch
// (the strided kernel's pass 1 with the wire reader), then the strided
// kernel's pass 2 into y.
int dfft_decode_fft_2p(const void* q, const void* side, void* y,
                       void* scratch, long long lead, long long cols,
                       int tiles, int codec, int m1, int stages1,
                       const int* radices1, int m2, int stages2,
                       const int* radices2, int forward, const void* tw1,
                       const void* tw2, const void* tt, float scale,
                       void* stream) {
  const radix::Plan p1 = radix::make_plan(m1, stages1, radices1);
  const radix::Plan p2 = radix::make_plan(m2, stages2, radices2);
  if (!radix::valid_plan(p1) || !radix::valid_plan(p2) ||
      !valid_codec(codec, tiles, m1 * m2) || scratch == nullptr ||
      scratch == y || scratch == q)
    return (int)cudaErrorInvalidValue;
  const bool fwd = forward != 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const long long nz = (long long)m2 * cols;
  DecodePass<radix::TwiddleOut> pass =
      first_pass_decode(p1, fwd, codec, nz, tiles);
  if (pass.err != cudaSuccess) return (int)pass.err;
  const cudaError_t e =
      pass(q, (const float*)side,
           radix::TwiddleOut{(float2*)scratch, (const float2*)tt, nz, cols,
                             m2},
           lead, nz, (const float2*)tw1, 1.0f, st);
  if (e != cudaSuccess) return (int)e;
  return (int)radix::two_pass_second((const float2*)scratch, (float2*)y,
                                     lead, cols, m1, p2, fwd,
                                     (const float2*)tw2, scale, st);
}

}  // extern "C"

// Radix-FFT device code of the row and plane kernels (four_step.cu:
// dfft_fft_rows, dfft_fft_plane): mixed-radix Stockham stages on whole
// sequences held in shared memory, butterflies in registers.
//
// The plan comes from the host (ops/radix.py): the stage radices, each a
// factor of n in {2, 3, 4, 5, 7, 8, 11, 13, 16, 17}, and the stage
// twiddle table, n - 1 complex64 built in float64. Stage k has radix R
// and ns = the product of the radices before it. Its butterfly j
// (0 <= j < n/R) reads x[j + m n/R] (m < R), multiplies element m by
// w_L^(p m) (L = ns R, p = j mod ns; table entry (ns-1) + (m-1) ns + p),
// runs an R-point DFT and writes output k to (j - p) R + p + k ns. After
// the last stage the sequence is in natural order (Stockham autosort: no
// bit reversal). Every product is an fp32 FMA: no tensor cores, no TF32.
//
// A persistent block walks groups of sequences: rows (each gets
// blockDim/seqs neighbouring threads) or neighbouring columns of a
// [planes, n, nz] array (neighbouring threads take neighbouring
// columns). A group's input lands in shared memory by 16-byte cp.async
// copies (rows: one contiguous range; columns: 64-128-byte row segments)
// while the block still runs the later stages of the group before. The
// first stage reads the landed copy; the stages exchange through two
// ping-pong buffers, rows padded by one element in 16 (s*ld + i + i/16)
// to spread the strided writes of the early stages over the banks,
// columns at i*C + s, conflict-free as they are; the last stage writes
// device memory straight from registers, times the inverse's scale: a
// warp stores 256 contiguous bytes (rows) or whole row segments
// (columns). Plans have at least two stages (n >= 64 > 17).

#pragma once

#include <cuda_runtime.h>

namespace radix {

constexpr int kThreads = 512;
constexpr int kMaxStages = 16;

struct Plan {
  int n;
  int stages;
  int radix[kMaxStages];
};

__device__ __forceinline__ float2 add(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 sub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 scl(float2 a, float s) {
  return make_float2(a.x * s, a.y * s);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x));
}
// a * (-i) forward, a * (+i) inverse: the quarter turn w_4 of the
// transform's direction.
template <bool FWD>
__device__ __forceinline__ float2 rot(float2 a) {
  return FWD ? make_float2(a.y, -a.x) : make_float2(-a.y, a.x);
}
// a * exp(-+i theta), given c = cos(theta), s = sin(theta).
template <bool FWD>
__device__ __forceinline__ float2 mulw(float2 a, float c, float s) {
  return FWD ? make_float2(fmaf(a.x, c, a.y * s), fmaf(a.y, c, -a.x * s))
             : make_float2(fmaf(a.x, c, -a.y * s), fmaf(a.y, c, a.x * s));
}

// ------------------------------------------------------------ butterflies
// In place on v[0..R-1]: v[k] <- sum_m v[m] w_R^(m k), natural order.

template <bool FWD>
__device__ __forceinline__ void bfly2(float2* v) {
  const float2 a = v[0], b = v[1];
  v[0] = add(a, b);
  v[1] = sub(a, b);
}

template <bool FWD>
__device__ __forceinline__ void bfly3(float2* v) {
  const float kS = 0.8660253882408142f;  // sin(2 pi / 3)
  const float2 t = add(v[1], v[2]);
  const float2 d = rot<FWD>(scl(sub(v[1], v[2]), kS));
  const float2 m = sub(v[0], scl(t, 0.5f));
  v[0] = add(v[0], t);
  v[1] = add(m, d);
  v[2] = sub(m, d);
}

template <bool FWD>
__device__ __forceinline__ void bfly4(float2* v) {
  const float2 s02 = add(v[0], v[2]), d02 = sub(v[0], v[2]);
  const float2 s13 = add(v[1], v[3]), d13 = rot<FWD>(sub(v[1], v[3]));
  v[0] = add(s02, s13);
  v[1] = add(d02, d13);
  v[2] = sub(s02, s13);
  v[3] = sub(d02, d13);
}

template <bool FWD>
__device__ __forceinline__ void bfly5(float2* v) {
  const float kC1 = 0.30901700258255005f, kC2 = -0.80901700258255f;
  const float kS1 = 0.9510565400123596f, kS2 = 0.5877852439880371f;
  const float2 a1 = add(v[1], v[4]), a2 = add(v[2], v[3]);
  const float2 b1 = sub(v[1], v[4]), b2 = sub(v[2], v[3]);
  const float2 x0 = v[0];
  const float2 c1 = add(x0, add(scl(a1, kC1), scl(a2, kC2)));
  const float2 c2 = add(x0, add(scl(a1, kC2), scl(a2, kC1)));
  const float2 s1 = rot<FWD>(add(scl(b1, kS1), scl(b2, kS2)));
  const float2 s2 = rot<FWD>(sub(scl(b1, kS2), scl(b2, kS1)));
  v[0] = add(x0, add(a1, a2));
  v[1] = add(c1, s1);
  v[4] = sub(c1, s1);
  v[2] = add(c2, s2);
  v[3] = sub(c2, s2);
}

// Radix 8 = two radix-4 DFTs (even and odd elements) joined by w_8^k.
template <bool FWD>
__device__ __forceinline__ void bfly8(float2* v) {
  const float kH = 0.7071067690849304f;  // sqrt(1/2)
  float2 e[4] = {v[0], v[2], v[4], v[6]};
  float2 o[4] = {v[1], v[3], v[5], v[7]};
  bfly4<FWD>(e);
  bfly4<FWD>(o);
  o[1] = mulw<FWD>(o[1], kH, kH);
  o[2] = rot<FWD>(o[2]);
  o[3] = mulw<FWD>(o[3], -kH, kH);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[k] = add(e[k], o[k]);
    v[k + 4] = sub(e[k], o[k]);
  }
}

// Radix 16 = two radix-8 DFTs joined by w_16^k.
template <bool FWD>
__device__ __forceinline__ void bfly16(float2* v) {
  // cos and sin of 2 pi k / 16
  const float kC[8] = {1.0f, 0.9238795042037964f, 0.7071067690849304f,
                       0.3826834261417389f, 0.0f, -0.3826834261417389f,
                       -0.7071067690849304f, -0.9238795042037964f};
  const float kS[8] = {0.0f, 0.3826834261417389f, 0.7071067690849304f,
                       0.9238795042037964f, 1.0f, 0.9238795042037964f,
                       0.7071067690849304f, 0.3826834261417389f};
  float2 e[8], o[8];
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    e[m] = v[2 * m];
    o[m] = v[2 * m + 1];
  }
  bfly8<FWD>(e);
  bfly8<FWD>(o);
#pragma unroll
  for (int k = 1; k < 8; ++k) {
    if (k == 4)
      o[k] = rot<FWD>(o[k]);
    else
      o[k] = mulw<FWD>(o[k], kC[k], kS[k]);
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    v[k] = add(e[k], o[k]);
    v[k + 8] = sub(e[k], o[k]);
  }
}

// cos and sin of 2 pi q / P, q < P, for the direct odd-prime DFT: P = 7
// at 0, 11 at 7, 13 at 18, 17 at 31 (float64 values rounded to fp32).
__constant__ float kOddCos[48] = {
    1.0f, 0.6234897971153259f, -0.22252093255519867f, -0.9009688496589661f,
    -0.9009688496589661f, -0.22252093255519867f, 0.6234897971153259f,
    1.0f, 0.8412535190582275f, 0.4154150187969208f, -0.1423148363828659f,
    -0.6548607349395752f, -0.9594929814338684f, -0.9594929814338684f,
    -0.6548607349395752f, -0.1423148363828659f, 0.4154150187969208f,
    0.8412535190582275f,
    1.0f, 0.8854560256004333f, 0.5680647492408752f, 0.1205366775393486f,
    -0.35460489988327026f, -0.7485107779502869f, -0.9709418416023254f,
    -0.9709418416023254f, -0.7485107779502869f, -0.35460489988327026f,
    0.1205366775393486f, 0.5680647492408752f, 0.8854560256004333f,
    1.0f, 0.9324722290039062f, 0.739008903503418f, 0.4457383453845978f,
    0.09226836264133453f, -0.2736629843711853f, -0.602634608745575f,
    -0.8502171635627747f, -0.9829730987548828f, -0.9829730987548828f,
    -0.8502171635627747f, -0.602634608745575f, -0.2736629843711853f,
    0.09226836264133453f, 0.4457383453845978f, 0.739008903503418f,
    0.9324722290039062f};
__constant__ float kOddSin[48] = {
    0.0f, 0.7818315029144287f, 0.9749279022216797f, 0.4338837265968323f,
    -0.4338837265968323f, -0.9749279022216797f, -0.7818315029144287f,
    0.0f, 0.5406408309936523f, 0.9096319675445557f, 0.9898214340209961f,
    0.7557495832443237f, 0.28173255920410156f, -0.28173255920410156f,
    -0.7557495832443237f, -0.9898214340209961f, -0.9096319675445557f,
    -0.5406408309936523f,
    0.0f, 0.4647231698036194f, 0.8229838609695435f, 0.9927088618278503f,
    0.9350162148475647f, 0.6631226539611816f, 0.23931565880775452f,
    -0.23931565880775452f, -0.6631226539611816f, -0.9350162148475647f,
    -0.9927088618278503f, -0.8229838609695435f, -0.4647231698036194f,
    0.0f, 0.3612416684627533f, 0.6736956238746643f, 0.8951632976531982f,
    0.9957341551780701f, 0.9618256688117981f, 0.7980172038078308f,
    0.5264321565628052f, 0.1837495118379593f, -0.1837495118379593f,
    -0.5264321565628052f, -0.7980172038078308f, -0.9618256688117981f,
    -0.9957341551780701f, -0.8951632976531982f, -0.6736956238746643f,
    -0.3612416684627533f};

template <int P>
constexpr int kOddAt = P == 7 ? 0 : P == 11 ? 7 : P == 13 ? 18 : 31;

// Direct P-point DFT, P an odd prime, in registers, by the symmetric
// pairs a_m = v[m] + v[P-m], b_m = v[m] - v[P-m]:
//   out[k], out[P-k] = v0 + sum_m a_m cos(2 pi m k/P)
//                      +- rot(sum_m b_m sin(2 pi m k/P)).
template <int P, bool FWD>
__device__ __forceinline__ void bfly_odd(float2* v) {
  constexpr int H = (P - 1) / 2;
  float2 a[H], b[H];
#pragma unroll
  for (int m = 1; m <= H; ++m) {
    a[m - 1] = add(v[m], v[P - m]);
    b[m - 1] = sub(v[m], v[P - m]);
  }
  const float2 x0 = v[0];
  float2 sum = x0;
#pragma unroll
  for (int m = 0; m < H; ++m) sum = add(sum, a[m]);
  float2 out[P];
  out[0] = sum;
#pragma unroll
  for (int k = 1; k <= H; ++k) {
    float2 c = x0, s = make_float2(0.f, 0.f);
#pragma unroll
    for (int m = 1; m <= H; ++m) {
      const int q = (m * k) % P;
      const float cq = kOddCos[kOddAt<P> + q], sq = kOddSin[kOddAt<P> + q];
      c = make_float2(fmaf(a[m - 1].x, cq, c.x), fmaf(a[m - 1].y, cq, c.y));
      s = make_float2(fmaf(b[m - 1].x, sq, s.x), fmaf(b[m - 1].y, sq, s.y));
    }
    s = rot<FWD>(s);
    out[k] = add(c, s);
    out[P - k] = sub(c, s);
  }
#pragma unroll
  for (int k = 0; k < P; ++k) v[k] = out[k];
}

template <int R, bool FWD>
__device__ __forceinline__ void butterfly(float2* v) {
  if constexpr (R == 2) bfly2<FWD>(v);
  else if constexpr (R == 3) bfly3<FWD>(v);
  else if constexpr (R == 4) bfly4<FWD>(v);
  else if constexpr (R == 5) bfly5<FWD>(v);
  else if constexpr (R == 8) bfly8<FWD>(v);
  else if constexpr (R == 16) bfly16<FWD>(v);
  else bfly_odd<R, FWD>(v);
}

// ------------------------------------------------------------------ stages

// Row stride of the padded exchange buffers: holds index n-1 + (n-1)/16,
// even so that both buffers stay 16-byte aligned.
__host__ __device__ __forceinline__ int padded_ld(int n) {
  const int ld = n + ((n - 1) >> 4) + 1;
  return ld + (ld & 1);
}

// Where element i of a sequence lives, from the sequence's base: G (the
// landed copy, or device memory) rows at i, columns at i*gstride; the
// exchange buffers rows at i + i/16 (padded), columns at i*sstride.
template <bool G, bool COL>
__device__ __forceinline__ int at(int i, int gstride, int sstride) {
  if (COL) return i * (G ? gstride : sstride);
  return G ? i : i + (i >> 4);
}

// One Stockham stage of radix R on one sequence: in -> out (its bases).
// IN_G: the first stage, reading the landed copy of its input (rows at
// i, columns at i*istride; ns = 1, no twiddles); OUT_G: the last,
// writing device memory (rows at i, columns at i*ostride) times `scale`.
template <int R, bool FWD, bool IN_G, bool OUT_G, bool COL>
__device__ void stage(const float2* __restrict__ in, float2* __restrict__ out,
                      int istride, int ostride, int sstride, int n, int ns,
                      int t, int step, const float2* tw, float scale) {
  const int q = n / R;
  for (int j = t; j < q; j += step) {
    const int p = IN_G ? 0 : j % ns;
    float2 v[R];
#pragma unroll
    for (int m = 0; m < R; ++m)
      v[m] = in[at<IN_G, COL>(j + m * q, istride, sstride)];
    if constexpr (!IN_G) {
#pragma unroll
      for (int m = 1; m < R; ++m) v[m] = cmul(v[m], tw[(m - 1) * ns + p]);
    }
    butterfly<R, FWD>(v);
    const int base = (j - p) * R + p;
#pragma unroll
    for (int k = 0; k < R; ++k)
      out[at<OUT_G, COL>(base + k * ns, ostride, sstride)] =
          OUT_G ? scl(v[k], scale) : v[k];
  }
}

// Which sequence of the group a thread works on, and its butterflies:
// j = t, t + step, ... of each stage.
struct Lane {
  int s, t, step;
};

template <bool COL>
__device__ __forceinline__ Lane lane(int seqs) {
  const int per = blockDim.x / seqs;
  if (COL) return Lane{(int)threadIdx.x % seqs, (int)threadIdx.x / seqs, per};
  return Lane{(int)threadIdx.x / per, (int)threadIdx.x % per, per};
}

// The stage of radix r. Radices above MAXR are not compiled in (MAXR = 8
// keeps the registers of plans of small radices few).
template <bool FWD, bool IN_G, bool OUT_G, bool COL, int MAXR>
__device__ __forceinline__ void stage_r(int r, const float2* in, float2* out,
                                        int istride, int ostride, int sstride,
                                        int n, int ns, Lane ln,
                                        const float2* tw, float scale) {
#define DFFT_STAGE(R)                                                      \
  stage<R, FWD, IN_G, OUT_G, COL>(in, out, istride, ostride, sstride, n, ns, \
                                  ln.t, ln.step, tw, scale)
  switch (r) {
    case 2: DFFT_STAGE(2); break;
    case 3: DFFT_STAGE(3); break;
    case 4: DFFT_STAGE(4); break;
    case 5: DFFT_STAGE(5); break;
    case 7: DFFT_STAGE(7); break;
    case 8: DFFT_STAGE(8); break;
    default:
      if constexpr (MAXR > 8) {
        switch (r) {
          case 11: DFFT_STAGE(11); break;
          case 13: DFFT_STAGE(13); break;
          case 16: DFFT_STAGE(16); break;
          case 17: DFFT_STAGE(17); break;
          default: break;  // the host plan never gives another radix
        }
      }
      break;
  }
#undef DFFT_STAGE
}

// Every stage of the plan on the group whose copy sits in p: the first
// stage reads p, the last writes the thread's sequence at dst in device
// memory (columns at i*ostride; times `scale`), the stages between
// exchange through a and b. `after_first` runs once p is free again.
// Must be called by every thread of the block; ends with __syncthreads.
template <bool FWD, bool COL, int MAXR, typename After>
__device__ void run_stages(const float2* p, float2* dst, int ostride, bool on,
                           Lane ln, int seqs, const Plan& plan, float2* a,
                           float2* b, const float2* tw, float scale,
                           After after_first) {
  const int n = plan.n, last = plan.stages - 1;
  const int off = COL ? ln.s : ln.s * padded_ld(n);
  const int pin = COL ? ln.s : ln.s * n;
  if (on)
    stage_r<FWD, true, false, COL, MAXR>(plan.radix[0], p + pin, a + off,
                                         seqs, 0, seqs, n, 1, ln, tw, 1.0f);
  __syncthreads();
  after_first();
  int ns = plan.radix[0];
  for (int k = 1; k < last; ++k) {
    if (on)
      stage_r<FWD, false, false, COL, MAXR>(plan.radix[k], a + off, b + off,
                                            0, 0, seqs, n, ns, ln,
                                            tw + (ns - 1), 1.0f);
    __syncthreads();
    float2* swap = a;
    a = b;
    b = swap;
    ns *= plan.radix[k];
  }
  if (on)
    stage_r<FWD, false, true, COL, MAXR>(plan.radix[last], a + off, dst, 0,
                                         ostride, seqs, n, ns, ln,
                                         tw + (ns - 1), scale);
  __syncthreads();
}

// ------------------------------------------------- device-memory traffic

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// 16 and 8 bytes from device to shared memory without registers
// (cp.async, sm_80+); they land after cp_async_wait.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::);
}

__device__ __forceinline__ bool aligned16(const void* a, const void* b) {
  return ((reinterpret_cast<size_t>(a) | reinterpret_cast<size_t>(b)) & 15) ==
         0;
}

// Start copying `elems` contiguous complex64 into shared memory; 16-byte
// copies when both ends allow.
__device__ __forceinline__ void load_range(float2* dst, const float2* src,
                                           int elems) {
  if (aligned16(dst, src) && (elems & 1) == 0) {
    for (int i = threadIdx.x; i < elems / 2; i += blockDim.x)
      cp_async16(dst + 2 * i, src + 2 * i);
  } else {
    for (int i = threadIdx.x; i < elems; i += blockDim.x)
      cp_async8(dst + i, src + i);
  }
}

// Start copying a [rows, cnt] tile of a row-major [rows, ld] array into
// shared memory at i*cols + s; 16-byte copies when the tile is full and
// its row segments are 16-byte aligned.
__device__ __forceinline__ void load_tile(float2* dst, const float2* src,
                                          int rows, int cnt, int cols,
                                          long long ld) {
  if (cnt == cols && (cols & 1) == 0 && (ld & 1) == 0 && aligned16(dst, src)) {
    const int pairs = cols / 2;
    for (int it = threadIdx.x; it < rows * pairs; it += blockDim.x) {
      const int i = it / pairs, h = it - i * pairs;
      cp_async16(dst + i * cols + 2 * h, src + i * ld + 2 * h);
    }
  } else {
    for (int it = threadIdx.x; it < rows * cnt; it += blockDim.x) {
      const int i = it / cnt, s = it - i * cnt;
      cp_async8(dst + i * cols + s, src + i * ld + s);
    }
  }
}

// ----------------------------------------------------------------- kernels
// Shared memory: the landing buffer p, the exchange buffers a and b
// (`buf` complex64 each; with nbuf = 2, b is p and nothing is
// prefetched), then the n - 1 twiddles, copied once per block. Blocks
// walk groups blockIdx.x, + gridDim.x, ...; with three buffers the copy
// of a block's next group lands in p while it runs the later stages of
// the current one.

__device__ __forceinline__ void load_twiddles(float2* dst, const float2* src,
                                              int n) {
  for (int i = threadIdx.x; i < n - 1; i += blockDim.x) dst[i] = src[i];
}

// The group loop of both kernels: load(g, p) starts the copy of group g
// into p, run(g, p, a, b, after_first) transforms and stores it.
template <typename Load, typename Run>
__device__ __forceinline__ void group_loop(float2* smem, int buf, int nbuf,
                                           long long groups, Load load,
                                           Run run) {
  float2* p = smem;
  float2* a = smem + buf;
  float2* b = nbuf == 3 ? a + buf : p;
  const bool prefetch = nbuf == 3;
  long long g = blockIdx.x;
  if (prefetch && g < groups) load(g, p);
  for (; g < groups; g += gridDim.x) {
    if (!prefetch) {
      __syncthreads();
      load(g, p);
    }
    cp_async_wait();
    __syncthreads();
    const long long next = g + gridDim.x;
    run(g, p, a, b, [&] {
      if (prefetch && next < groups) load(next, p);
    });
  }
}

// y[b, :] = DFT(x[b, :]) * scale over [batch, n], `seqs` rows per group.
template <bool FWD, int MAXR>
__global__ void __launch_bounds__(kThreads)
rows_kernel(const float2* x, float2* y, long long batch, Plan plan, int seqs,
            int buf, int nbuf, const float2* twg, float scale) {
  extern __shared__ float4 radix_smem[];
  float2* smem = reinterpret_cast<float2*>(radix_smem);
  float2* tw = smem + nbuf * buf;
  const int n = plan.n;
  load_twiddles(tw, twg, n);
  const Lane ln = lane<false>(seqs);
  const long long groups = (batch + seqs - 1) / seqs;
  auto count = [&](long long g) {
    return (int)(batch - g * seqs < seqs ? batch - g * seqs : seqs);
  };
  group_loop(
      smem, buf, nbuf, groups,
      [&](long long g, float2* dst) {
        load_range(dst, x + g * seqs * n, count(g) * n);
      },
      [&](long long g, float2* p, float2* a, float2* b, auto after) {
        const long long row = g * seqs + ln.s;
        run_stages<FWD, false, MAXR>(p, y + row * n, 1, row < batch, ln, seqs,
                                     plan, a, b, tw, scale, after);
      });
}

// y[b, :, c] = DFT(y[b, :, c]) * scale in place over [planes, n, nz]:
// the transform over the middle axis, `cols` neighbouring columns per
// group.
template <bool FWD, int MAXR>
__global__ void __launch_bounds__(kThreads)
cols_kernel(float2* y, long long planes, int nz, Plan plan, int cols,
            int buf, int nbuf, const float2* twg, float scale) {
  extern __shared__ float4 radix_smem[];
  float2* smem = reinterpret_cast<float2*>(radix_smem);
  float2* tw = smem + nbuf * buf;
  const int n = plan.n;
  load_twiddles(tw, twg, n);
  const Lane ln = lane<true>(cols);
  const int tiles = (nz + cols - 1) / cols;
  const long long groups = planes * tiles;
  auto where = [&](long long g, int* cnt) {
    const long long pl = g / tiles;
    const int c0 = (int)(g - pl * tiles) * cols;
    *cnt = nz - c0 < cols ? nz - c0 : cols;
    return y + pl * n * nz + c0;
  };
  group_loop(
      smem, buf, nbuf, groups,
      [&](long long g, float2* dst) {
        int cnt;
        const float2* src = where(g, &cnt);
        load_tile(dst, src, n, cnt, cols, nz);
      },
      [&](long long g, float2* p, float2* a, float2* b, auto after) {
        int cnt;
        float2* base = where(g, &cnt);
        run_stages<FWD, true, MAXR>(p, base + ln.s, nz, ln.s < cnt, ln, cols,
                                    plan, a, b, tw, scale, after);
      });
}

}  // namespace radix

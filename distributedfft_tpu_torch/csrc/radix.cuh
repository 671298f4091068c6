// Radix-FFT device code of the row, strided and plane kernels
// (four_step.cu: dfft_fft_rows, dfft_fft_strided, dfft_fft_plane, and
// the two-pass route's *_2p) and of the fused encode and decode kernels
// (fuse.cu): mixed-radix Stockham stages on whole sequences held in
// shared memory, butterflies in registers; and the host-side set-up of
// such a pass.
//
// The plan comes from the host (ops/radix.py): the stage radices, each a
// factor of n in {2, 3, 4, 5, 7, 8, 11, 13, 16, 17} (a butterfly in
// registers) or a prime from 19 to 251 (the generic prime stage, below),
// and the stage table: n - 1 twiddles, then the R roots w_R^q of each
// generic stage R in stage order, complex64 built in float64. Stage k
// has radix R and ns = the product of the radices before it. Its
// butterfly j (0 <= j < n/R) reads x[j + m n/R] (m < R), multiplies
// element m by w_L^(p m) (L = ns R, p = j mod ns; table entry (ns-1) +
// (m-1) ns + p), runs an R-point DFT and writes output k to (j - p) R + p
// + k ns. After the last stage the sequence is in natural order
// (Stockham autosort: no bit reversal). Every product is an fp32 FMA: no
// tensor cores, no TF32.
//
// A persistent block walks groups of sequences: rows (each gets
// blockDim/seqs neighbouring threads) or neighbouring columns of a
// [planes, n, nz] array (neighbouring threads take neighbouring
// columns). A group's input lands in shared memory by 16-byte cp.async
// copies (rows: one contiguous range; columns: 64-128-byte row segments)
// while the block still runs the later stages of the group before. The
// first stage reads the landed copy through the kernel's reader (the
// decode kernel lands raw wire bytes and unpacks each value there); the
// stages exchange through two
// ping-pong buffers, rows padded by one element in 16 (s*ld + i + i/16)
// to spread the strided writes of the early stages over the banks,
// columns at i*C + s, conflict-free as they are; the last stage hands
// each output, times the inverse's scale, straight from registers to
// the kernel's sink: a complex64 store to device memory (a warp stores
// 256 contiguous bytes for rows, whole row segments for columns), the
// same store while taking the encode's amax, the encode's bf16 pack, or
// the two-pass route's stores (four_step.cu: the twiddle product of its
// first pass, the reordering of its second). A plan of one stage (a
// two-pass factor that is a prime over 17, such as 241 of 8194 = 34 *
// 241) reads the landed copy and hands its outputs to the sink in that
// one stage.

#pragma once

#include <cuda_runtime.h>

#include <algorithm>
#include <mutex>
#include <vector>

namespace radix {

constexpr int kThreads = 512;
constexpr int kMaxStages = 16;
// Largest radix with a butterfly in registers: every larger stage is a
// prime from 19 to kMaxPrime on the generic stage.
constexpr int kMaxHand = 17;
constexpr int kMaxPrime = 251;
// Output pairs (k, R - k) one item of a generic stage sums at most
// (ops/radix.py: GENERIC_PAIRS).
constexpr int kPairs = 4;

struct Plan {
  int n;
  int stages;
  int table;  // complex64 of the stage table: twiddles, then roots
  int radix[kMaxStages];
};

// Items of a generic stage of radix r per butterfly: its (r - 1)/2 output
// pairs in chunks of at most kPairs.
__host__ __device__ __forceinline__ int generic_chunks(int r) {
  return ((r - 1) / 2 + kPairs - 1) / kPairs;
}

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

// Where element i of a sequence sits in the exchange buffers, from the
// sequence's base: rows at i + i/16 (padded), columns at i*sstride.
template <bool COL>
__device__ __forceinline__ int sat(int i, int sstride) {
  return COL ? i * sstride : i + (i >> 4);
}

// One Stockham stage of radix R on one sequence. FIRST: the first stage
// (ns = 1, no twiddles), reading element i as src(i) from the group's
// landed copy; otherwise src is the exchange buffer at the sequence's
// base. LAST: the last stage, handing output i, times `scale`, to
// sink(i, v); otherwise out is the exchange buffer (and sink unused).
template <int R, bool FWD, bool FIRST, bool LAST, bool COL, typename Src,
          typename Sink>
__device__ void stage(Src src, float2* __restrict__ out, Sink sink,
                      int sstride, int n, int ns, int t, int step,
                      const float2* tw, float scale) {
  const int q = n / R;
  for (int j = t; j < q; j += step) {
    const int p = FIRST ? 0 : j % ns;
    float2 v[R];
#pragma unroll
    for (int m = 0; m < R; ++m) {
      if constexpr (FIRST)
        v[m] = src(j + m * q);
      else
        v[m] = src[sat<COL>(j + m * q, sstride)];
    }
    if constexpr (!FIRST) {
#pragma unroll
      for (int m = 1; m < R; ++m) v[m] = cmul(v[m], tw[(m - 1) * ns + p]);
    }
    butterfly<R, FWD>(v);
    const int base = (j - p) * R + p;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int i = base + k * ns;
      if constexpr (LAST)
        sink(i, scl(v[k], scale));
      else
        out[sat<COL>(i, sstride)] = v[k];
    }
  }
}

// One Stockham stage of a prime radix r from 19 to 251 (a runtime value)
// on one sequence; FIRST, LAST, src, out, sink as stage's, and `roots`
// the stage's r roots w_r^q (q < r, the transform's direction in their
// sign) in shared memory. A butterfly of r points does not fit
// registers, so it runs from the exchange buffer (or the landed copy) as
// generic_chunks(r) items: item (c, j), c < chunks, j < n/r, reads the
// butterfly's r inputs, twiddling each as it reads it, forms a_m = v_m +
// v_{r-m} and b_m = v_m - v_{r-m} (m = 1 .. h, h = (r - 1)/2) and sums,
// for each pair k of its chunk (at most kPairs of them),
//   out[k], out[r-k] = v_0 + sum_m a_m Re w + i sum_m b_m Im w
//                      and  v_0 + sum_m a_m Re w - i sum_m b_m Im w,
// w = roots[m k mod r] (the index kept as a running sum, no division);
// chunk 0 also writes out[0] = v_0 + sum_m a_m. About 5 h flops per
// output, all fp32 FMAs. Neighbouring threads take neighbouring j of one
// chunk, so their reads are neighbouring elements (rows padded one in 16
// against the banks, columns at i*sstride + s), their roots one entry (a
// broadcast) and their writes neighbouring elements, or, in the last
// stage (ns = n/r, so j = p), neighbouring outputs for the sink.
template <bool FIRST, bool LAST, bool COL, typename Src, typename Sink>
__device__ void generic_stage(int r, Src src, float2* __restrict__ out,
                              Sink sink, int sstride, int n, int ns, int t,
                              int step, const float2* tw,
                              const float2* roots, float scale) {
  const int q = n / r, h = (r - 1) >> 1;
  const int chunks = generic_chunks(r);
  const int per = (h + chunks - 1) / chunks;
  for (int w = t; w < q * chunks; w += step) {
    const int c = w / q, j = w - c * q;
    const int p = FIRST ? 0 : j % ns;
    const int k0 = 1 + c * per, cnt = min(per, h + 1 - k0);
    auto in = [&](int m) -> float2 {
      if constexpr (FIRST) {
        return src(j + m * q);
      } else {
        const float2 v = src[sat<COL>(j + m * q, sstride)];
        return m == 0 ? v : cmul(v, tw[(m - 1) * ns + p]);
      }
    };
    const float2 x0 = in(0);
    float2 sum = x0, cs[kPairs], sn[kPairs];
    int e[kPairs];
#pragma unroll
    for (int u = 0; u < kPairs; ++u) {
      cs[u] = x0;
      sn[u] = make_float2(0.f, 0.f);
      e[u] = 0;
    }
    for (int m = 1; m <= h; ++m) {
      const float2 vm = in(m), vr = in(r - m);
      const float2 a = add(vm, vr), b = sub(vm, vr);
      sum = add(sum, a);
#pragma unroll
      for (int u = 0; u < kPairs; ++u) {
        int x = e[u] + k0 + u;  // k0 + u <= chunks * per < r
        x -= x >= r ? r : 0;
        e[u] = x;
        const float2 rt = roots[x];
        cs[u] = make_float2(fmaf(a.x, rt.x, cs[u].x), fmaf(a.y, rt.x, cs[u].y));
        sn[u] = make_float2(fmaf(b.x, rt.y, sn[u].x), fmaf(b.y, rt.y, sn[u].y));
      }
    }
    const int base = (j - p) * r + p;
    auto put = [&](int k, float2 v) {
      if constexpr (LAST)
        sink(base + k * ns, scl(v, scale));
      else
        out[sat<COL>(base + k * ns, sstride)] = v;
    };
    if (c == 0) put(0, sum);
#pragma unroll
    for (int u = 0; u < kPairs; ++u) {
      if (u < cnt) {
        const float2 is = make_float2(-sn[u].y, sn[u].x);  // i * sn
        put(k0 + u, add(cs[u], is));
        put(r - k0 - u, sub(cs[u], is));
      }
    }
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

// The stage of radix r (`roots`: a generic stage's). A kernel variant
// compiles the radices up to MAXR: 8 (it keeps the registers of plans of
// small radices few), kMaxHand (every hand-written radix) or kMaxPrime
// (those, and the generic stage for every other). Pass gives a variant
// only plans whose radices it compiles (max_radix), so a radix without
// a case is unreachable there; the variants without the generic stage
// compile exactly as they did before it existed.
template <bool FWD, bool FIRST, bool LAST, bool COL, int MAXR, typename Src,
          typename Sink>
__device__ __forceinline__ void stage_r(int r, Src src, float2* out,
                                        Sink sink, int sstride, int n, int ns,
                                        Lane ln, const float2* tw,
                                        const float2* roots, float scale) {
#define DFFT_STAGE(R)                                                   \
  stage<R, FWD, FIRST, LAST, COL>(src, out, sink, sstride, n, ns, ln.t, \
                                  ln.step, tw, scale)
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
          default:
            if constexpr (MAXR > kMaxHand)
              generic_stage<FIRST, LAST, COL>(r, src, out, sink, sstride, n,
                                              ns, ln.t, ln.step, tw, roots,
                                              scale);
            else
              __builtin_unreachable();
            break;
        }
      } else {
        __builtin_unreachable();
      }
      break;
  }
#undef DFFT_STAGE
}

// The sink of the stages before the last, which store to the exchange
// buffers.
struct NoSink {
  __device__ void operator()(int, float2) const {}
};

// Every stage of the plan on the thread's sequence of the group: the
// first stage reads element i as first(i) (from the landed copy), the
// last hands output i, times `scale`, to sink(i, v), the stages between
// exchange through a and b; a plan of one stage (a generic prime:
// valid_plan admits no other, and Pass gives it the MAXR = kMaxPrime
// variant) does both in that stage. `after_first` runs once
// the landed copy is free again. Must be called by every thread of the
// block; the last stage is followed by a __syncthreads.
template <bool FWD, bool COL, int MAXR, typename First, typename Sink,
          typename After>
__device__ void run_stages(First first, Sink sink, bool on, Lane ln, int seqs,
                           const Plan& plan, float2* a, float2* b,
                           const float2* tw, float scale, After after_first) {
  const int n = plan.n, last = plan.stages - 1;
  const int off = COL ? ln.s : ln.s * padded_ld(n);
  const float2* roots = tw + (n - 1);  // the generic stages', in order
  auto next_roots = [&](int r) {
    if (r > kMaxHand) roots += r;
  };
  if constexpr (MAXR > kMaxHand) {
    if (last == 0) {
      if (on)
        generic_stage<true, true, COL>(plan.radix[0], first, nullptr, sink,
                                       seqs, n, 1, ln.t, ln.step, tw, roots,
                                       scale);
      __syncthreads();
      after_first();
      return;
    }
  }
  if (on)
    stage_r<FWD, true, false, COL, MAXR>(plan.radix[0], first, a + off,
                                         NoSink{}, seqs, n, 1, ln, tw, roots,
                                         1.0f);
  __syncthreads();
  after_first();
  next_roots(plan.radix[0]);
  int ns = plan.radix[0];
  for (int k = 1; k < last; ++k) {
    if (on)
      stage_r<FWD, false, false, COL, MAXR>(
          plan.radix[k], static_cast<const float2*>(a + off), b + off,
          NoSink{}, seqs, n, ns, ln, tw + (ns - 1), roots, 1.0f);
    __syncthreads();
    float2* swap = a;
    a = b;
    b = swap;
    next_roots(plan.radix[k]);
    ns *= plan.radix[k];
  }
  if (on)
    stage_r<FWD, false, true, COL, MAXR>(
        plan.radix[last], static_cast<const float2*>(a + off), nullptr, sink,
        seqs, n, ns, ln, tw + (ns - 1), roots, scale);
  __syncthreads();
}

// The sink of a pass that stores complex64: output i of the sequence
// whose first element is at dst goes to dst[i * stride].
__device__ __forceinline__ auto store_c64(float2* dst, long long stride) {
  return [=](int i, float2 v) { dst[i * stride] = v; };
}

// ------------------------------------------------- device-memory traffic

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// 16, 8 and 4 bytes from device to shared memory without registers
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
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
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
      cp_async16(dst + i * cols + 2 * h, src + (long long)i * ld + 2 * h);
    }
  } else {
    for (int it = threadIdx.x; it < rows * cnt; it += blockDim.x) {
      const int i = it / cnt, s = it - i * cnt;
      cp_async8(dst + i * cols + s, src + (long long)i * ld + s);
    }
  }
}

// Shared-memory bytes per landed row of a wire tile whose full row
// segment is `bytes` long: the segment itself when it lands by 16-byte
// copies (`fast`), else the 4-byte-aligned span that covers it wherever
// it starts (a 2-byte int8 pair may start at 2 mod 4).
__host__ __device__ __forceinline__ int wire_ld(int bytes, bool fast) {
  return fast ? bytes : ((bytes + 3) & ~3) + 4;
}

// Start copying a wire tile, `rows` row segments of `cnt` bytes (a full
// one is `bytes` long) `ld` bytes apart in device memory, into shared
// memory at i*wire_ld(bytes, fast). fast: 16-byte copies of whole, 16-byte
// aligned segments. Otherwise 4-byte copies of each segment's covering
// span, the segment then starting at (src + i*ld) & 3 within its row:
// cp.async copies 4, 8 or 16 bytes, never the 2 of an int8 pair, and
// every word it reads holds a byte of the tile.
__device__ __forceinline__ void load_wire_tile(char* dst, const char* src,
                                               int rows, int cnt, int bytes,
                                               long long ld, bool fast) {
  if (fast) {
    const int chunks = bytes / 16;
    for (int it = threadIdx.x; it < rows * chunks; it += blockDim.x) {
      const int i = it / chunks, h = it - i * chunks;
      cp_async16(dst + i * bytes + 16 * h, src + i * ld + 16 * h);
    }
    return;
  }
  const int w = wire_ld(bytes, false), words = (cnt + 6) / 4;
  for (int it = threadIdx.x; it < rows * words; it += blockDim.x) {
    const int i = it / words, k = it - i * words;
    const char* row = src + i * ld;
    const int o = (int)(reinterpret_cast<size_t>(row) & 3);
    if (4 * k < o + cnt) cp_async4(dst + i * w + 4 * k, row - o + 4 * k);
  }
}

// ----------------------------------------------------------------- kernels
// Shared memory, in complex64: the landing buffer p (`pbuf`), the
// exchange buffers a and b (`buf` each), then the stage table (plan.table:
// the n - 1 twiddles and the generic stages' roots), copied once per
// block, then whatever else a kernel keeps (the decode's steps).
// With prefetch the copy of a block's next group lands in p while it runs
// the later stages of the current one; without (when three buffers do
// not fit), b is p and pbuf == buf. Blocks walk groups blockIdx.x, +
// gridDim.x, ...

struct Smem {
  int pbuf, buf, prefetch;
  __host__ __device__ int twiddles() const {
    return pbuf + (prefetch ? 2 : 1) * buf;
  }
};

// Copy the plan's stage table (plan.table complex64) into shared memory.
__device__ __forceinline__ void load_twiddles(float2* dst, const float2* src,
                                              const Plan& plan) {
  for (int i = threadIdx.x; i < plan.table; i += blockDim.x) dst[i] = src[i];
}

// The group loop of every radix kernel: load(g, p) starts the copy of
// group g into p, run(g, p, a, b, after_first) transforms and stores it.
template <typename Load, typename Run>
__device__ __forceinline__ void group_loop(float2* smem, Smem sm,
                                           long long groups, Load load,
                                           Run run) {
  float2* p = smem;
  float2* a = smem + sm.pbuf;
  float2* b = sm.prefetch ? a + sm.buf : p;
  long long g = blockIdx.x;
  if (sm.prefetch && g < groups) load(g, p);
  for (; g < groups; g += gridDim.x) {
    if (!sm.prefetch) {
      __syncthreads();
      load(g, p);
    }
    cp_async_wait();
    __syncthreads();
    const long long next = g + gridDim.x;
    run(g, p, a, b, [&] {
      if (sm.prefetch && next < groups) load(next, p);
    });
  }
}

// The output of a rows pass: begin(extra) and end() as a column pass's
// (below); row(r, s) is the sink of row r, the group's row s; flush(r0,
// cnt) runs once the group's rows r0 .. r0 + cnt - 1 have all been
// handed to their sinks (after a __syncthreads). Each is called by every
// thread.
struct RowOut {  // y[r*n + i] = v
  float2* y;
  int n;
  __device__ void begin(void*) {}
  __device__ auto row(long long r, int) { return store_c64(y + r * n, 1); }
  __device__ void flush(long long, int) {}
  __device__ void end() {}
};

// Odd row stride of the transposed store's staging buffer: a half warp
// writing 16 neighbouring outputs of one row hits 16 bank pairs.
__host__ __device__ __forceinline__ int odd_ld(int len) { return len | 1; }

// The second pass of the two-pass row route (four_step.cu:
// dfft_fft_rows_2p): row r = b*m1 + k1 of the [batch*m1, m2] scratch is
// sequence k1 of batch row b, and its output k2 goes to y[b*n + k1 +
// m1*k2]. The last stage writes the group's rows (seqs >= 16 of them,
// consecutive k1) into shared memory at k2*ld + s; flush then stores each
// k2's run of the group's rows: >= 128 contiguous bytes.
struct TransposeOut {
  float2* y;
  int m1, m2, ld;  // ld = odd_ld(rows per group)
  float2* stage;
  static size_t bytes(int m2, int seqs) {
    return (size_t)m2 * odd_ld(seqs) * sizeof(float2);
  }
  __device__ void begin(void* extra) { stage = static_cast<float2*>(extra); }
  __device__ auto row(long long, int s) {
    float2* d = stage + s;
    const int step = ld;
    return [=](int i, float2 v) { d[i * step] = v; };
  }
  __device__ void flush(long long r0, int cnt) {
    // thread -> the group's row s, k2 = k0, k0 + per, ...: neighbouring
    // threads store neighbouring k1
    const int per = blockDim.x / cnt, s = threadIdx.x % cnt;
    const int k0 = threadIdx.x / cnt;
    if (k0 >= per) return;
    const long long b0 = r0 / m1;
    const int k1 = (int)(r0 - b0 * m1) + s, q = k1 / m1;
    float2* d = y + (b0 + q) * m1 * m2 + (k1 - q * m1);
    for (int k2 = k0; k2 < m2; k2 += per)
      d[(long long)m1 * k2] = stage[k2 * ld + s];
  }
  __device__ void end() {}
};

// DFT(x[b, :]) * scale over [batch, n], `seqs` rows per group, each row
// going to `out`.
template <bool FWD, int MAXR, typename Out>
__global__ void __launch_bounds__(kThreads)
rows_kernel(const float2* x, Out out, long long batch, Plan plan, int seqs,
            Smem sm, const float2* twg, float scale) {
  extern __shared__ float4 radix_smem[];
  float2* smem = reinterpret_cast<float2*>(radix_smem);
  float2* tw = smem + sm.twiddles();
  const int n = plan.n;
  load_twiddles(tw, twg, plan);
  out.begin(tw + plan.table);
  const Lane ln = lane<false>(seqs);
  const long long groups = (batch + seqs - 1) / seqs;
  auto count = [&](long long g) {
    return (int)(batch - g * seqs < seqs ? batch - g * seqs : seqs);
  };
  group_loop(
      smem, sm, groups,
      [&](long long g, float2* dst) {
        load_range(dst, x + g * seqs * n, count(g) * n);
      },
      [&](long long g, float2* p, float2* a, float2* b, auto after) {
        const long long row = g * seqs + ln.s;
        const float2* in = p + ln.s * n;
        run_stages<FWD, false, MAXR>([=](int i) { return in[i]; },
                                     out.row(row, ln.s), row < batch, ln,
                                     seqs, plan, a, b, tw, scale, after);
        out.flush(g * seqs, count(g));
      });
  out.end();
}

// The output of a column pass: what its last stage does with each value.
// begin(extra) sets up the block (extra: the shared memory after the
// twiddles, as many bytes as the pass was given); column(e, stride) is
// the sink of the column whose element 0 is at offset e, element i at
// e + i*stride; end() runs once the block has walked all its groups.
// Each is called by every thread of the block.
struct C64Out {  // y[e + i*stride] = v
  float2* y;
  __device__ void begin(void*) {}
  __device__ auto column(long long e, long long stride) {
    return store_c64(y + e, stride);
  }
  __device__ void end() {}
};

// The first pass of the two-pass route (four_step.cu: dfft_fft_rows_2p,
// dfft_fft_strided_2p), a column pass of length m1 over [lead, m1, nz],
// nz = m2*cols: column e of a row holds j2 = e / cols, and output k1
// goes to y[e + k1*nz] times the twiddle w_n^(k1*j2) = T[j2, k1], read
// from tt, the host's table T transposed ([m1, m2], complex64 built in
// float64, n entries that every lead block reads: they stay in L2).
// Neighbouring columns hold the same j2 or, when cols = 1, neighbouring
// ones, so a warp's reads of one k1 are one broadcast or one coalesced
// run.
struct TwiddleOut {
  float2* y;
  const float2* tt;
  long long nz, cols;
  int m2;
  __device__ void begin(void*) {}
  __device__ auto column(long long e, long long stride) {
    const float2* w = tt + (e % nz) / cols;
    const int m = m2;
    float2* d = y + e;
    return [=](int i, float2 v) {
      d[i * stride] = cmul(v, __ldg(w + i * m));
    };
  }
  __device__ void end() {}
};

// The second pass of the two-pass strided route, a column pass of length
// m2 over the [lead*m1, m2, cols] scratch: block l*m1 + k1 holds sequence
// k1 of lead block l, and output k2 of its column c goes to y[l, k1 +
// m1*k2, c] (a warp still stores whole runs of neighbouring columns).
struct ReorderOut {
  float2* y;
  long long cols;
  int m1, m2;
  __device__ void begin(void*) {}
  __device__ auto column(long long e, long long) {
    const long long span = (long long)m2 * cols;
    const long long blk = e / span, c = e - blk * span;
    const long long l = blk / m1, k1 = blk - l * m1;
    float2* d = y + (l * m1 * m2 + k1) * cols + c;
    return store_c64(d, (long long)m1 * cols);
  }
  __device__ void end() {}
};

// DFT(x[l, :, c]) * scale over [lead, n, nz], the transform over the
// middle axis, `cols` neighbouring columns per group, each output going
// to `out`. With C64Out{y}, y may be x (each group reads and writes only
// its own tile).
template <bool FWD, int MAXR, typename Out>
__global__ void __launch_bounds__(kThreads)
cols_kernel(const float2* x, Out out, long long lead, long long nz,
            Plan plan, int cols, Smem sm, const float2* twg, float scale) {
  extern __shared__ float4 radix_smem[];
  float2* smem = reinterpret_cast<float2*>(radix_smem);
  float2* tw = smem + sm.twiddles();
  const int n = plan.n;
  load_twiddles(tw, twg, plan);
  out.begin(tw + plan.table);
  const Lane ln = lane<true>(cols);
  const long long tiles = (nz + cols - 1) / cols;
  const long long groups = lead * tiles;
  // offset of the group's first element; cnt: its columns
  auto where = [&](long long g, int* cnt) {
    const long long l = g / tiles, c0 = (g - l * tiles) * cols;
    *cnt = (int)(nz - c0 < cols ? nz - c0 : cols);
    return l * n * nz + c0;
  };
  group_loop(
      smem, sm, groups,
      [&](long long g, float2* dst) {
        int cnt;
        const long long e0 = where(g, &cnt);
        load_tile(dst, x + e0, n, cnt, cols, nz);
      },
      [&](long long g, float2* p, float2* a, float2* b, auto after) {
        int cnt;
        const long long e0 = where(g, &cnt);
        const float2* in = p + ln.s;
        run_stages<FWD, true, MAXR>([=](int i) { return in[i * cols]; },
                                    out.column(e0 + ln.s, nz), ln.s < cnt,
                                    ln, cols, plan, a, b, tw, scale, after);
      });
  out.end();
}

// The generic-stage variants (MAXR = kMaxPrime) of the kernels for the
// outputs four_step.cu launches them with are compiled in generic.cu, a
// translation unit of their own that nvcc builds in parallel with the
// others; every other file only declares them (fuse.cuh does the same
// for the fused kernels' families, each compiled in a fuse_*.cu unit).
#define DFFT_GENERIC_ROWS(FWD, OUT)                                         \
  template __global__ void rows_kernel<FWD, kMaxPrime, OUT>(               \
      const float2*, OUT, long long, Plan, int, Smem, const float2*, float)
#define DFFT_GENERIC_COLS(FWD, OUT)                                         \
  template __global__ void cols_kernel<FWD, kMaxPrime, OUT>(               \
      const float2*, OUT, long long, long long, Plan, int, Smem,           \
      const float2*, float)
#define DFFT_GENERIC_KERNELS(PREFIX)                                        \
  PREFIX DFFT_GENERIC_ROWS(true, RowOut);                                   \
  PREFIX DFFT_GENERIC_ROWS(false, RowOut);                                  \
  PREFIX DFFT_GENERIC_ROWS(true, TransposeOut);                             \
  PREFIX DFFT_GENERIC_ROWS(false, TransposeOut);                            \
  PREFIX DFFT_GENERIC_COLS(true, C64Out);                                   \
  PREFIX DFFT_GENERIC_COLS(false, C64Out);                                  \
  PREFIX DFFT_GENERIC_COLS(true, TwiddleOut);                               \
  PREFIX DFFT_GENERIC_COLS(false, TwiddleOut);                              \
  PREFIX DFFT_GENERIC_COLS(true, ReorderOut);                               \
  PREFIX DFFT_GENERIC_COLS(false, ReorderOut)
#ifndef DFFT_GENERIC_TU
DFFT_GENERIC_KERNELS(extern);
#endif

// ------------------------------------------------------------- host side
// The set-up of a radix pass, shared by the launchers of four_step.cu and
// fuse.cu.

// Shared memory a radix block may take: two row blocks of 512 threads,
// or one column block of 16 columns of 512 points, fit one SM. A
// sequence longer than that allows runs one per block (up to the 227 KB
// maximum, n = 8192), without prefetch when three buffers do not fit.
constexpr size_t kRadixSmem = 200 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;

// The plan of radices[0..stages-1] (host memory) for length n, its
// table the n - 1 twiddles and the roots of each generic stage.
inline Plan make_plan(int n, int stages, const int* radices) {
  Plan p{};
  p.n = n;
  p.stages = stages;
  p.table = n - 1;
  for (int k = 0; k < stages && k < kMaxStages; ++k) {
    p.radix[k] = radices[k];
    if (radices[k] > kMaxHand) p.table += radices[k];
  }
  return p;
}

// A plan the kernels run: 1 to kMaxStages stages whose radices multiply
// out to n, each a hand-written radix or an odd radix from 19 to
// kMaxPrime (the generic stage), and one stage only when it is generic.
inline bool valid_plan(const Plan& p) {
  if (p.stages < 1 || p.stages > kMaxStages) return false;
  long long prod = 1;
  for (int k = 0; k < p.stages; ++k) {
    const int r = p.radix[k];
    const bool hand = r == 2 || r == 3 || r == 4 || r == 5 || r == 7 ||
                      r == 8 || r == 11 || r == 13 || r == 16 || r == 17;
    if (!hand && (r <= kMaxHand || r > kMaxPrime || r % 2 == 0)) return false;
    prod *= r;
  }
  return prod == p.n && (p.stages > 1 || p.radix[0] > kMaxHand);
}

inline int max_radix(const Plan& p) {
  int r = 2;
  for (int k = 0; k < p.stages; ++k) r = std::max(r, p.radix[k]);
  return r;
}

// The fewest items any stage of the plan gives one sequence: n/R
// butterflies, each generic_chunks(R) items on a generic stage.
inline int min_items(const Plan& p) {
  int least = p.n;
  for (int k = 0; k < p.stages; ++k) {
    const int r = p.radix[k];
    least = std::min(least, p.n / r * (r > kMaxHand ? generic_chunks(r) : 1));
  }
  return least;
}

// Bytes of the layout sm for a plan of `table` table entries: buffers,
// table and `extra`.
inline size_t smem_bytes(int table, const Smem& sm, size_t extra) {
  return ((size_t)sm.twiddles() + table) * sizeof(float2) + extra;
}

// The layout with a landing buffer of `land` complex64 and prefetch, or,
// when that does not fit the card, without prefetch.
inline Smem layout(int table, int buf, int land, size_t extra) {
  const Smem pre{land, buf, 1};
  if (smem_bytes(table, pre, extra) <= kMaxSmem) return pre;
  return Smem{buf, buf, 0};
}

inline size_t no_extra(int) { return 0; }

// Rows per group: enough that the stage with the fewest items gives
// every thread one, and at least `least` (a power of two), as far as
// kRadixSmem allows with prefetch and extra(seqs) bytes of the output's
// after the table.
template <typename Extra = size_t (*)(int)>
int rows_per_group(const Plan& p, int least = 1, Extra extra = no_extra) {
  int seqs = least;
  while ((long long)seqs * min_items(p) < kThreads) seqs *= 2;
  while (seqs > least) {
    const int buf = seqs * padded_ld(p.n);
    if (smem_bytes(p.table, Smem{buf, buf, 1}, extra(seqs)) <= kRadixSmem)
      break;
    seqs /= 2;
  }
  return seqs;
}

// Columns per group: `most` (16: 128-byte row segments of complex64) down
// to 1, no more than the next power of two of `nz` (a narrow array leaves
// no lane idle), and the most that fit kRadixSmem with prefetch. land(c):
// the complex64 the landing copy of c columns takes.
template <typename Land>
int cols_per_group(const Plan& p, long long nz, Land land, int most = 16) {
  int c = most;
  while (c > 1 && c / 2 >= nz) c /= 2;
  while (c > 1 &&
         smem_bytes(p.table, Smem{land(c), p.n * c, 1}, 0) > kRadixSmem)
    c /= 2;
  return c;
}

// Resident blocks of a persistent launch with `shm` bytes of shared
// memory: as many as fit the card at once. Found once per (device,
// kernel, shm) and kept, so that a call costs the host only its launch.
// Every kernel's shared-memory limit is raised to the card's maximum
// (one value for every shm, so no later call lowers it under an earlier
// one's need).
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, size_t shm, long long* blocks) {
  struct Entry {
    int dev;
    const void* kernel;
    size_t shm;
    long long blocks;
  };
  static std::mutex mu;
  static std::vector<Entry> known;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  for (const Entry& k : known)
    if (k.dev == dev && k.kernel == (const void*)kernel && k.shm == shm) {
      *blocks = k.blocks;
      return cudaSuccess;
    }
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kMaxSmem);
  if (e != cudaSuccess) return e;
  int sms = 0, per_sm = 0;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, shm)) != cudaSuccess)
    return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = (long long)per_sm * sms;
  known.push_back(Entry{dev, (const void*)kernel, shm, *blocks});
  return cudaSuccess;
}

// One radix pass, set up once and launched per call: its group size
// (rows or columns), shared-memory layout, kernel variant (the one that
// compiles the plan's largest radix: k8, k17 or kgen, the generic
// stage's) and resident blocks. buf: complex64 of each exchange buffer; land: of the
// landing buffer with prefetch; extra: bytes after the table.
template <typename Kernel>
struct Pass {
  Plan plan;
  int group;
  Smem sm;
  size_t shm;
  Kernel kernel;
  long long cap = 0;
  cudaError_t err;

  Pass(const Plan& p, int group_, int buf, int land, size_t extra, Kernel k8,
       Kernel k17, Kernel kgen)
      : plan(p), group(group_), sm(layout(p.table, buf, land, extra)),
        shm(smem_bytes(p.table, sm, extra)),
        kernel(max_radix(p) <= 8          ? k8
               : max_radix(p) <= kMaxHand ? k17
                                          : kgen) {
    err = resident_blocks(kernel, shm, &cap);
  }

  long long blocks(long long groups) const { return std::min(cap, groups); }
};

template <typename Out>
using RowsKernel = void (*)(const float2*, Out, long long, Plan, int, Smem,
                            const float2*, float);
template <typename Out>
using ColsKernel = void (*)(const float2*, Out, long long, long long, Plan,
                            int, Smem, const float2*, float);

// The rows pass over [batch, n] from x into `out` (RowOut: x -> y);
// `group` rows per group (rows_per_group), `extra`: the bytes of shared
// memory Out::begin takes.
template <typename Out = RowOut>
struct RowsPass : Pass<RowsKernel<Out>> {
  RowsPass(const Plan& p, bool fwd, int group, size_t extra)
      : Pass<RowsKernel<Out>>(
            p, group, group * padded_ld(p.n), group * padded_ld(p.n), extra,
            fwd ? rows_kernel<true, 8, Out> : rows_kernel<false, 8, Out>,
            fwd ? rows_kernel<true, kMaxHand, Out>
                : rows_kernel<false, kMaxHand, Out>,
            fwd ? rows_kernel<true, kMaxPrime, Out>
                : rows_kernel<false, kMaxPrime, Out>) {}
  RowsPass(const Plan& p, bool fwd) : RowsPass(p, fwd, rows_per_group(p), 0) {}
  cudaError_t operator()(const float2* x, Out out, long long batch,
                         const float2* tw, float scale, cudaStream_t st) {
    const int group = this->group;
    const long long b = this->blocks((batch + group - 1) / group);
    const RowsKernel<Out> kernel = this->kernel;
    if (b > 0)
      kernel<<<(unsigned)b, kThreads, this->shm, st>>>(
          x, out, batch, this->plan, group, this->sm, tw, scale);
    return cudaGetLastError();
  }
};

inline int c64_cols(const Plan& p, long long nz, int most = 16) {
  const int n = p.n;
  return cols_per_group(p, nz, [n](int c) { return n * c; }, most);
}

// The columns pass over [lead, n, nz] from x into `out` (C64Out: x -> y,
// y may be x); `extra`: the bytes of shared memory Out::begin takes;
// groups of up to `most` columns (c64_cols).
template <typename Out = C64Out>
struct ColsPass : Pass<ColsKernel<Out>> {
  ColsPass(const Plan& p, bool fwd, long long nz, size_t extra = 0,
           int most = 16)
      : Pass<ColsKernel<Out>>(
            p, c64_cols(p, nz, most), p.n * c64_cols(p, nz, most),
            p.n * c64_cols(p, nz, most), extra,
            fwd ? cols_kernel<true, 8, Out> : cols_kernel<false, 8, Out>,
            fwd ? cols_kernel<true, kMaxHand, Out>
                : cols_kernel<false, kMaxHand, Out>,
            fwd ? cols_kernel<true, kMaxPrime, Out>
                : cols_kernel<false, kMaxPrime, Out>) {}
  cudaError_t operator()(const float2* x, Out out, long long lead,
                         long long nz, const float2* tw, float scale,
                         cudaStream_t st) {
    const int group = this->group;
    const long long b = this->blocks(lead * ((nz + group - 1) / group));
    const ColsKernel<Out> kernel = this->kernel;
    if (b > 0)
      kernel<<<(unsigned)b, kThreads, this->shm, st>>>(
          x, out, lead, nz, this->plan, group, this->sm, tw, scale);
    return cudaGetLastError();
  }
};

// ------------------------------------------------------ the two-pass route
// n = m1*m2 (four_step.cu). Its two passes are defined in four_step.cu
// and shared with the fused launchers of fuse.cu, which read the wire in
// the first pass (decode) or store through the codec in the second
// (encode) and run the other pass as it is.

// Most columns per group of a two-pass column pass.
constexpr int kTwoPassMostCols = 64;

// Columns per group of a two-pass column pass at most: a factor's
// sequence is short (33 to 256 points), so a group of 16 columns leaves
// most of the block's threads without an item; enough columns that the
// stage with the fewest items gives every thread one, from 16 up to
// kTwoPassMostCols (ColsPass keeps as many as fit shared memory).
inline int two_pass_most(const Plan& p) {
  int most = 16;
  while (most < kTwoPassMostCols &&
         (long long)most * min_items(p) < kThreads)
    most *= 2;
  return most;
}

// Pass 1: the length-m1 column pass over x as [lead, m1, m2*cols] into s,
// each output times its twiddle from tt (T transposed, [m1, m2]).
cudaError_t two_pass_first(const float2* x, float2* s, long long lead,
                           long long cols, const Plan& p1, int m2, bool fwd,
                           const float2* tw1, const float2* tt,
                           cudaStream_t st);

// Pass 2: the length-m2 pass over the scratch s into y, output (k1, k2)
// at k1 + m1*k2 times `scale`: the column pass over [lead*m1, m2, cols]
// (ReorderOut), or at cols = 1 the rows pass over [lead*m1, m2] with the
// transposed store (TransposeOut).
cudaError_t two_pass_second(const float2* s, float2* y, long long lead,
                            long long cols, int m1, const Plan& p2, bool fwd,
                            const float2* tw2, float scale, cudaStream_t st);

}  // namespace radix

// The four-step DFT device routine shared by the kernels of four_step.cu
// and fuse.cu (see four_step.cu for the math and the design).
//
// A length-n axis, n = n1*n2 with both factors <= 256, is viewed as
// A[j1, j2] (j = j1*n2 + j2) and
//   G[j2, k1] = sum_j1 A[j1, j2] W1[j1, k1]      stage 1
//   H[j2, k1] = G[j2, k1] T[j2, k1]              twiddle
//   Z[k1, k2] = sum_j2 H[j2, k1] W2[j2, k2]      stage 2
//   X[k1 + n1*k2] = Z[k1, k2]                    natural output order.
// The sums are direct fp32 FMAs: no tensor cores, no TF32.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// One four-step DFT of `cnt` sequences. Element j of sequence s lives at
// p[s*ss + j*sj] for each of in / tmp / out (generic pointers: shared or
// device memory). SEQ_FAST gives neighbouring threads neighbouring
// sequences (column layout, ss == 1); otherwise neighbouring k1.
// Must be called by every thread of the block; in == out is allowed.
template <bool SEQ_FAST>
__device__ void four_step(const float2* in, float2* tmp, float2* out,
                          long long ss, long long sj, int cnt, int n1, int n2,
                          const float2* __restrict__ w1,
                          const float2* __restrict__ tw,
                          const float2* __restrict__ w2, float scale) {
  const int n = n1 * n2;
  const int items = cnt * n;
  // Stage 1 and twiddle: item -> (s, j2, k1), written at j2*n1 + k1.
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    int s, j2, k1;
    if (SEQ_FAST) {
      s = it % cnt;
      const int r = it / cnt;
      k1 = r % n1;
      j2 = r / n1;
    } else {
      k1 = it % n1;
      const int r = it / n1;
      j2 = r % n2;
      s = r / n2;
    }
    const float2* a = in + s * ss + (long long)j2 * sj;
    const long long step = (long long)n2 * sj;
    float re = 0.f, im = 0.f;
    for (int j1 = 0; j1 < n1; ++j1) {
      const float2 v = a[j1 * step];
      const float2 w = __ldg(&w1[j1 * n1 + k1]);
      re = fmaf(v.x, w.x, re);
      re = fmaf(-v.y, w.y, re);
      im = fmaf(v.x, w.y, im);
      im = fmaf(v.y, w.x, im);
    }
    const float2 t = __ldg(&tw[j2 * n1 + k1]);
    tmp[s * ss + (long long)(j2 * n1 + k1) * sj] =
        cmul(make_float2(re, im), t);
  }
  __syncthreads();
  // Stage 2: item -> (s, k2, k1), written at k1 + n1*k2.
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    int s, k1, k2;
    if (SEQ_FAST) {
      s = it % cnt;
      const int r = it / cnt;
      k1 = r % n1;
      k2 = r / n1;
    } else {
      k1 = it % n1;
      const int r = it / n1;
      k2 = r % n2;
      s = r / n2;
    }
    const float2* h = tmp + s * ss + (long long)k1 * sj;
    const long long step = (long long)n1 * sj;
    float re = 0.f, im = 0.f;
    for (int j2 = 0; j2 < n2; ++j2) {
      const float2 v = h[j2 * step];
      const float2 w = __ldg(&w2[j2 * n2 + k2]);
      re = fmaf(v.x, w.x, re);
      re = fmaf(-v.y, w.y, re);
      im = fmaf(v.x, w.y, im);
      im = fmaf(v.y, w.x, im);
    }
    out[s * ss + (long long)(k1 + n1 * k2) * sj] =
        make_float2(re * scale, im * scale);
  }
}

}  // namespace

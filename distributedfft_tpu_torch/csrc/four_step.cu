// Four-step DFT kernels for Hopper (sm_90a): the port of the three
// four-step Pallas kernels of distributedfft_tpu/ops/pallas_fft.py.
//
// Replaces (TPU kernel -> launcher here):
//   pallas_fft.py:_make_kernel          (1D rows)       -> dfft_fft_rows
//   pallas_fft.py:_make_kernel_strided  (leading axis)  -> dfft_fft_strided
//   pallas_fft.py:_make_kernel2d        (fused plane)   -> dfft_fft_plane
//
// Math (pallas_fft.py:_four_step_pass): a length-n axis, n = n1*n2 with
// both factors <= 256, is viewed as A[j1, j2] (j = j1*n2 + j2) and
//   G[j2, k1] = sum_j1 A[j1, j2] W1[j1, k1]      stage 1
//   H[j2, k1] = G[j2, k1] T[j2, k1]              twiddle
//   Z[k1, k2] = sum_j2 H[j2, k1] W2[j2, k2]      stage 2
//   X[k1 + n1*k2] = Z[k1, k2]                    natural output order.
// The sums are direct fp32 FMAs in this file: no tensor cores, no TF32
// (the TPU kernel contracts at `highest` precision), no library call.
// The LUTs W1, T, W2 are complex64, built on the host in float64.
//
// What bounds it on an H100: at n = 512 a transform does 8*(n1+n2) = 384
// flops per complex element against 16 bytes of device traffic (one read,
// one write), 24 flops/byte; the card's fp32 balance is 67e12/3.35e12 =
// 20 flops/byte, so the direct sums sit just past the memory bound. In
// this first version the limit is the SM's L1/shared-memory bandwidth:
// every complex multiply-add (4 FMAs) loads its operand from shared
// memory and its LUT entry through L1, 16 bytes against the SM's 128
// bytes per clock, a quarter of the FMA rate. What the design does about
// device memory: each block holds whole sequences in shared memory, so
// device memory is read once and written once per pass; loads and stores
// are coalesced (the strided kernel gives neighbouring threads
// neighbouring columns). Register blocking of the sums, butterflies
// inside each factor, and clusters that hold a whole plane in
// distributed shared memory are later work.
//
// Shared memory: a block takes S sequences of length n and needs 2*S*n
// complex64 (input/output buffer plus the stage-1 result). When even one
// sequence does not fit (n above ~6000), the same routine runs with its
// three buffers in device memory: the input, a caller-allocated scratch
// the size of the data, and the output. __syncthreads orders the block's
// device-memory writes as it does shared ones, and each block reads only
// the region it writes, so every launcher may also run in place (y == x).
//
// The fused plane is two launches: rows over Z into y, then the strided
// kernel over Y on y in place. A 512x512 plane (2 MiB) does not fit a
// block's 227 KB, where the TPU kernel kept it whole in VMEM, so the
// intermediate makes one round trip through device memory: the plane
// costs two passes where the TPU kernel took one.
//
// Every launcher returns cudaGetLastError() of its own launches.

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
// Must be called by every thread of the block.
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

// [batch, n] rows, `seqs` rows per block. scratch == nullptr: in shared
// memory; otherwise through device scratch of batch*n.
__global__ void __launch_bounds__(kThreads)
rows_kernel(const float2* x, float2* y, float2* scratch, long long batch,
            int n1, int n2, int seqs, const float2* w1, const float2* tw,
            const float2* w2, float scale) {
  extern __shared__ float2 smem[];
  const int n = n1 * n2;
  const long long r0 = (long long)blockIdx.x * seqs;
  const int cnt = (int)min((long long)seqs, batch - r0);
  const long long base = r0 * n;
  if (scratch != nullptr) {
    four_step<false>(x + base, scratch + base, y + base, n, 1, cnt, n1, n2,
                     w1, tw, w2, scale);
    return;
  }
  float2* a = smem;
  float2* b = smem + (long long)seqs * n;
  const int elems = cnt * n;
  for (int i = threadIdx.x; i < elems; i += blockDim.x) a[i] = x[base + i];
  __syncthreads();
  four_step<false>(a, b, a, n, 1, cnt, n1, n2, w1, tw, w2, scale);
  __syncthreads();
  for (int i = threadIdx.x; i < elems; i += blockDim.x) y[base + i] = a[i];
}

// [lead, n, cols]: the DFT runs over the middle axis of each lead block,
// `seqs` neighbouring columns per block. scratch as in rows_kernel.
__global__ void __launch_bounds__(kThreads)
strided_kernel(const float2* x, float2* y, float2* scratch, long long lead,
               long long cols, int n1, int n2, int seqs, const float2* w1,
               const float2* tw, const float2* w2, float scale) {
  extern __shared__ float2 smem[];
  const int n = n1 * n2;
  const long long tiles = (cols + seqs - 1) / seqs;
  const long long l = blockIdx.x / tiles;
  const long long c0 = (blockIdx.x % tiles) * seqs;
  const int cnt = (int)min((long long)seqs, cols - c0);
  const long long base = l * n * cols + c0;
  if (scratch != nullptr) {
    four_step<true>(x + base, scratch + base, y + base, 1, cols, cnt, n1, n2,
                    w1, tw, w2, scale);
    return;
  }
  float2* a = smem;
  float2* b = smem + (long long)seqs * n;
  const int elems = cnt * n;
  for (int i = threadIdx.x; i < elems; i += blockDim.x) {
    const int s = i % cnt, j = i / cnt;
    a[s + j * seqs] = x[base + (long long)j * cols + s];
  }
  __syncthreads();
  four_step<true>(a, b, a, 1, seqs, cnt, n1, n2, w1, tw, w2, scale);
  __syncthreads();
  for (int i = threadIdx.x; i < elems; i += blockDim.x) {
    const int s = i % cnt, j = i / cnt;
    y[base + (long long)j * cols + s] = a[s + j * seqs];
  }
}

cudaError_t launch_rows(const float2* x, float2* y, float2* scratch,
                        long long batch, int n1, int n2, int seqs,
                        const float2* w1, const float2* tw, const float2* w2,
                        float scale, cudaStream_t stream) {
  const long long blocks = (batch + seqs - 1) / seqs;
  size_t shm = 0;
  if (scratch == nullptr) {
    shm = 2ull * seqs * n1 * n2 * sizeof(float2);
    cudaError_t e = cudaFuncSetAttribute(
        rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shm);
    if (e != cudaSuccess) return e;
  }
  if (blocks > 0)
    rows_kernel<<<(unsigned)blocks, kThreads, shm, stream>>>(
        x, y, scratch, batch, n1, n2, seqs, w1, tw, w2, scale);
  return cudaGetLastError();
}

cudaError_t launch_strided(const float2* x, float2* y, float2* scratch,
                           long long lead, long long cols, int n1, int n2,
                           int seqs, const float2* w1, const float2* tw,
                           const float2* w2, float scale,
                           cudaStream_t stream) {
  const long long blocks = lead * ((cols + seqs - 1) / seqs);
  size_t shm = 0;
  if (scratch == nullptr) {
    shm = 2ull * seqs * n1 * n2 * sizeof(float2);
    cudaError_t e = cudaFuncSetAttribute(
        strided_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shm);
    if (e != cudaSuccess) return e;
  }
  if (blocks > 0)
    strided_kernel<<<(unsigned)blocks, kThreads, shm, stream>>>(
        x, y, scratch, lead, cols, n1, n2, seqs, w1, tw, w2, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// y[b, :] = DFT(x[b, :]) * scale for b < batch; n = n1*n2.
int dfft_fft_rows(const void* x, void* y, void* scratch, long long batch,
                  int n1, int n2, int seqs, const void* w1, const void* tw,
                  const void* w2, float scale, void* stream) {
  return (int)launch_rows(
      (const float2*)x, (float2*)y, (float2*)scratch, batch, n1, n2, seqs,
      (const float2*)w1, (const float2*)tw, (const float2*)w2, scale,
      (cudaStream_t)stream);
}

// y[l, :, c] = DFT(x[l, :, c]) * scale over [lead, n, cols]; n = n1*n2.
int dfft_fft_strided(const void* x, void* y, void* scratch, long long lead,
                     long long cols, int n1, int n2, int seqs, const void* w1,
                     const void* tw, const void* w2, float scale,
                     void* stream) {
  return (int)launch_strided(
      (const float2*)x, (float2*)y, (float2*)scratch, lead, cols, n1, n2,
      seqs, (const float2*)w1, (const float2*)tw, (const float2*)w2, scale,
      (cudaStream_t)stream);
}

// 2D DFT over the last two axes of [batch, ny, nz]: rows over Z into y,
// then the strided pass over Y on y in place, scaled by `scale`.
// ny = y1*y2, nz = z1*z2; each pass has its own block size and scratch
// (nullptr = shared memory).
int dfft_fft_plane(const void* x, void* y, void* scratch, long long batch,
                   int y1, int y2, int z1, int z2, int seqs_z, int seqs_y,
                   int z_in_smem, int y_in_smem, const void* wy1,
                   const void* ty, const void* wy2, const void* wz1,
                   const void* tz, const void* wz2, float scale,
                   void* stream) {
  const long long ny = (long long)y1 * y2, nz = (long long)z1 * z2;
  float2* s = (float2*)scratch;
  cudaError_t e = launch_rows(
      (const float2*)x, (float2*)y, z_in_smem ? nullptr : s, batch * ny, z1,
      z2, seqs_z, (const float2*)wz1, (const float2*)tz, (const float2*)wz2,
      1.0f, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  e = launch_strided((const float2*)y, (float2*)y, y_in_smem ? nullptr : s,
                     batch, nz, y1, y2, seqs_y, (const float2*)wy1,
                     (const float2*)ty, (const float2*)wy2, scale,
                     (cudaStream_t)stream);
  return (int)e;
}

}  // extern "C"

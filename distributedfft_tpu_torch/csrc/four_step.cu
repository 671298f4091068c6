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
// The sums are direct fp32 FMAs in the device routine `four_step`
// (four_step.cuh, shared with fuse.cu): no tensor cores, no TF32 (the TPU
// kernel contracts at `highest` precision), no library call.
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

#include "four_step.cuh"

namespace {

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

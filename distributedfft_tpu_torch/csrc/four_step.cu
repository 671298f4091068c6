// The row, strided and plane DFT kernels for Hopper (sm_90a): the port of
// the three Pallas kernels of distributedfft_tpu/ops/pallas_fft.py.
//
// Replaces (TPU kernel -> launcher here):
//   pallas_fft.py:_make_kernel          (1D rows)       -> dfft_fft_rows
//   pallas_fft.py:_make_kernel_strided  (leading axis)  -> dfft_fft_strided
//   pallas_fft.py:_make_kernel2d        (fused plane)   -> dfft_fft_plane
//
// Three routes. The radix route (dfft_fft_rows, dfft_fft_strided,
// dfft_fft_plane; device code and pass set-up in radix.cuh) takes, with
// the stage plan and table the host gives it (ops/radix.py), every
// kernel-eligible length n <= 8192 for the row and strided kernels (a
// prime factor from 19 to 251 runs radix.cuh's generic prime stage),
// and for the plane the lengths whose prime factors are all <= 17. The
// two-pass radix route (dfft_fft_rows_2p, dfft_fft_strided_2p) takes the
// row and strided kernels' eligible lengths 8192 < n <= 65536: two radix
// passes, below. The plane's other eligible lengths take the direct
// route (dfft_fft_plane_direct): the four-step sums below.
//
// What bounds the radix route on an H100: bytes, 16 per element per pass
// (one complex64 read, one written; 3.35 TB/s). A mixed-radix Stockham
// transform does 33 flops per element at n = 512 (ops/radix.py:
// plan_flops), about two per byte, far under the card's fp32 balance of
// 20 flops per byte. So the design keeps everything but the one read and
// one write on the SM and keeps device memory busy: persistent blocks
// of 512 threads walk groups of whole sequences (rows, or 8-16
// neighbouring columns: 64-128-byte row segments); a group's input lands
// in shared memory by 16-byte cp.async copies while the block still works
// on the group before; every stage runs its butterflies in registers and
// exchanges through shared memory (padded against bank conflicts); the
// last stage writes device memory straight from registers, the inverse's
// 1/n applied there. The twiddles are read from shared memory, copied
// once per block.
//
// A prime factor from 19 to 251 (radix.cuh: generic_stage) is a stage
// whose butterfly does not fit registers: it runs from the exchange
// buffer, each thread summing a few output pairs (k, R - k) of one
// butterfly against the R roots in shared memory, about 5 (R - 1)/2
// flops an output (~625 at 251), still under the fp32 balance for R up
// to ~70 and about at it past that. It lives in a kernel variant of its
// own (MAXR = kMaxPrime), so the variants of the smooth lengths compile
// and run as they did before it. It replaces the direct route's
// four-step sums for kernels 2 and 3 (8*(n1+n2) flops a point, through
// device scratch past ~6000 points: 31 ms at [1,9728,512], PERF.md).
//
// The strided kernel is the column pass of that routine over [lead, n,
// cols] (x -> y): each group is 16 neighbouring columns of one lead
// block, fewer only where cols is narrower. The plane is two passes of
// it: rows over Z (x -> y), then columns over Y in place on y. A 512 x 512 plane (2 MiB) does not fit
// one block's 227 KB, where the TPU kernel kept it whole in VMEM, so the
// intermediate makes a round trip. The launcher can walk the batch in
// chunks of planes so that the round trip stays in the 50 MB L2
// (ops/radix.py:plane_chunk); on the H100 the chunked form measured
// slower than one pass over the whole batch (its launches are each under
// one wave of blocks; PERF.md), so fft2_last passes the whole batch.
//
// The direct route of the plane (pallas_fft.py:_four_step_pass; its row
// and strided passes are rows_kernel and strided_kernel): a length-n axis,
// n = n1*n2 with both factors <= 256, is viewed as A[j1, j2]
// (j = j1*n2 + j2) and
//   G[j2, k1] = sum_j1 A[j1, j2] W1[j1, k1]      stage 1
//   H[j2, k1] = G[j2, k1] T[j2, k1]              twiddle
//   Z[k1, k2] = sum_j2 H[j2, k1] W2[j2, k2]      stage 2
//   X[k1 + n1*k2] = Z[k1, k2]                    natural output order.
// The sums are direct fp32 FMAs in the device routine `four_step`
// (four_step.cuh, shared with fuse.cu): no tensor cores, no TF32 (the TPU
// kernel contracts at `highest` precision), no library call. The LUTs
// W1, T, W2 are complex64, built on the host in float64. It does
// 8*(n1+n2) flops per element (384 at n = 512), each complex
// multiply-add loading its operand from shared memory and its LUT entry
// through L1, so it runs at the SM's L1/shared-memory bandwidth, several
// times its memory bound. Each block holds whole sequences in shared
// memory, so device memory is read once and written once per pass.
//
// The two-pass route: n = m1*m2 (the same split, m1 <= m2 <= 256, each
// factor a radix plan, one stage when it is a prime over 17, as 241 of
// 8194 = 34 * 241), j = j1*m2 + j2 and k = k1 + m1*k2. A whole
// sequence no longer fits one block's shared memory with its exchange
// buffers, so the transform is the four-step split run as two radix
// passes through a scratch the size of the data, each pass one read and
// one write of device memory (the route's bound is twice the one-pass
// bound), every operand of the butterflies in registers or shared memory:
//   pass 1: the length-m1 column pass over j1 of x as [lead, m1,
//     m2*cols] (rows: [batch, m1, m2], cols = 1); its sink (radix.cuh:
//     TwiddleOut) multiplies output (k1, j2) by T[j2, k1] = w_n^(k1*j2),
//     the direct route's own float64-built table (given transposed), and
//     stores to the scratch in place of j1;
//   pass 2: the length-m2 pass over j2, storing (k1, k2) at k1 + m1*k2
//     (times the inverse's scale): for the strided kernel the column
//     pass over [lead*m1, m2, cols] (radix.cuh: ReorderOut, a warp still
//     stores runs of neighbouring columns), for the row kernel the rows
//     pass over [batch*m1, m2], whose store is a transpose through shared
//     memory (radix.cuh: TransposeOut: each k2 stores a run of >= 16
//     consecutive k1, >= 128 bytes). A strided call with cols = 1 is the
//     row kernel's. The reordering crosses groups, so the route cannot run
//     in place.
//
// Shared memory of the direct route: a block takes S sequences of length
// n and needs 2*S*n complex64. When even one sequence does not fit (n
// above ~6000), the same routine runs with its three buffers in device
// memory: the input, a caller-allocated scratch the size of the data,
// and the output. __syncthreads orders the block's device-memory writes
// as it does shared ones, and each block reads only the region it
// writes, so the plane's strided pass runs in place (y == x).
//
// Every launcher returns cudaGetLastError() of its own launches.

#include "four_step.cuh"
#include "radix.cuh"

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

// Most columns per group of a two-pass column pass.
constexpr int kTwoPassMostCols = 64;

// Columns per group of a two-pass column pass at most: a factor's
// sequence is short (33 to 256 points), so a group of 16 columns leaves
// most of the block's threads without an item; enough columns that the
// stage with the fewest items gives every thread one, from 16 up to
// kTwoPassMostCols (ColsPass keeps as many as fit shared memory).
int two_pass_most(const radix::Plan& p) {
  int most = 16;
  while (most < kTwoPassMostCols &&
         (long long)most * radix::min_items(p) < radix::kThreads)
    most *= 2;
  return most;
}

// Pass 1 of the two-pass route: the length-m1 column pass over x as
// [lead, m1, m2*cols] into s, each output times its twiddle from tt
// (T transposed, [m1, m2]).
cudaError_t two_pass_first(const float2* x, float2* s, long long lead,
                           long long cols, const radix::Plan& p1, int m2,
                           bool fwd, const float2* tw1, const float2* tt,
                           cudaStream_t st) {
  const long long nz = (long long)m2 * cols;
  radix::ColsPass<radix::TwiddleOut> pass(p1, fwd, nz, 0, two_pass_most(p1));
  if (pass.err != cudaSuccess) return pass.err;
  return pass(x, radix::TwiddleOut{s, tt, nz, cols, m2}, lead, nz, tw1, 1.0f,
              st);
}

// The two-pass route over [batch, n] rows: pass 1 into s, then the rows
// pass over [batch*m1, m2] with the transposed store into y.
cudaError_t two_pass_rows(const float2* x, float2* y, float2* s,
                          long long batch, const radix::Plan& p1,
                          const radix::Plan& p2, bool fwd, const float2* tw1,
                          const float2* tw2, const float2* tt, float scale,
                          cudaStream_t st) {
  cudaError_t e = two_pass_first(x, s, batch, 1, p1, p2.n, fwd, tw1, tt, st);
  if (e != cudaSuccess) return e;
  const int m1 = p1.n, m2 = p2.n;
  auto extra = [m2](int seqs) { return radix::TransposeOut::bytes(m2, seqs); };
  const int g = radix::rows_per_group(p2, 16, extra);
  radix::RowsPass<radix::TransposeOut> pass(p2, fwd, g, extra(g));
  if (pass.err != cudaSuccess) return pass.err;
  return pass(s, radix::TransposeOut{y, m1, m2, radix::odd_ld(g)},
              batch * m1, tw2, scale, st);
}

// The two-pass launchers' checks: valid plans, and a scratch apart from
// x and y, y apart from x.
bool valid_two_pass(const radix::Plan& p1, const radix::Plan& p2,
                    const void* x, const void* y, const void* scratch) {
  return radix::valid_plan(p1) && radix::valid_plan(p2) &&
         scratch != nullptr && scratch != x && scratch != y && x != y;
}

}  // namespace

extern "C" {

// y[b, :] = DFT(x[b, :]) * scale for b < batch, the radix route: n has
// the stage radices radices[0..stages-1] (host memory) and the stage
// table tw (device memory: n - 1 twiddles, then the roots of each generic
// stage; ops/radix.py:table_np).
int dfft_fft_rows(const void* x, void* y, long long batch, int n,
                  int stages, const int* radices, int forward,
                  const void* tw, float scale, void* stream) {
  const radix::Plan plan = radix::make_plan(n, stages, radices);
  if (!radix::valid_plan(plan)) return (int)cudaErrorInvalidValue;
  radix::RowsPass<> rows(plan, forward != 0);
  if (rows.err != cudaSuccess) return (int)rows.err;
  return (int)rows((const float2*)x, radix::RowOut{(float2*)y, n}, batch,
                   (const float2*)tw, scale, (cudaStream_t)stream);
}

// The same by the two-pass route: n = m1*m2, each factor with its stage
// radices (host memory) and tables tw1, tw2 (device memory), tt the
// four-step twiddle table T transposed, [m1, m2] (device memory: tt[k1*m2
// + j2] = w_n^(k1*j2)), scratch of batch*n complex64
// (neither x nor y; y is not x).
int dfft_fft_rows_2p(const void* x, void* y, void* scratch, long long batch,
                     int m1, int stages1, const int* radices1, int m2,
                     int stages2, const int* radices2, int forward,
                     const void* tw1, const void* tw2, const void* tt,
                     float scale, void* stream) {
  const radix::Plan p1 = radix::make_plan(m1, stages1, radices1);
  const radix::Plan p2 = radix::make_plan(m2, stages2, radices2);
  if (!valid_two_pass(p1, p2, x, y, scratch))
    return (int)cudaErrorInvalidValue;
  return (int)two_pass_rows(
      (const float2*)x, (float2*)y, (float2*)scratch, batch, p1, p2,
      forward != 0, (const float2*)tw1, (const float2*)tw2,
      (const float2*)tt, scale, (cudaStream_t)stream);
}

// y[l, :, c] = DFT(x[l, :, c]) * scale over [lead, n, cols], the radix
// route (radix.cuh's column routine; plan and table as dfft_fft_rows
// takes them). y may be x.
int dfft_fft_strided(const void* x, void* y, long long lead, long long cols,
                     int n, int stages, const int* radices, int forward,
                     const void* tw, float scale, void* stream) {
  const radix::Plan plan = radix::make_plan(n, stages, radices);
  if (!radix::valid_plan(plan)) return (int)cudaErrorInvalidValue;
  radix::ColsPass<> pass(plan, forward != 0, cols);
  if (pass.err != cudaSuccess) return (int)pass.err;
  return (int)pass((const float2*)x, radix::C64Out{(float2*)y}, lead, cols,
                   (const float2*)tw, scale, (cudaStream_t)stream);
}

// The same by the two-pass route: plans, twiddles, tt and scratch as
// dfft_fft_rows_2p takes them.
int dfft_fft_strided_2p(const void* x, void* y, void* scratch,
                        long long lead, long long cols, int m1, int stages1,
                        const int* radices1, int m2, int stages2,
                        const int* radices2, int forward, const void* tw1,
                        const void* tw2, const void* tt, float scale,
                        void* stream) {
  const radix::Plan p1 = radix::make_plan(m1, stages1, radices1);
  const radix::Plan p2 = radix::make_plan(m2, stages2, radices2);
  if (!valid_two_pass(p1, p2, x, y, scratch))
    return (int)cudaErrorInvalidValue;
  const bool fwd = forward != 0;
  const float2* fx = (const float2*)x;
  float2* fy = (float2*)y;
  float2* fs = (float2*)scratch;
  const float2* ftw1 = (const float2*)tw1;
  const float2* ftw2 = (const float2*)tw2;
  const float2* ftt = (const float2*)tt;
  const cudaStream_t st = (cudaStream_t)stream;
  if (cols == 1)
    return (int)two_pass_rows(fx, fy, fs, lead, p1, p2, fwd, ftw1, ftw2, ftt,
                              scale, st);
  cudaError_t e = two_pass_first(fx, fs, lead, cols, p1, m2, fwd, ftw1, ftt,
                                 st);
  if (e != cudaSuccess) return (int)e;
  radix::ColsPass<radix::ReorderOut> pass(p2, fwd, cols, 0,
                                          two_pass_most(p2));
  if (pass.err != cudaSuccess) return (int)pass.err;
  return (int)pass(fs, radix::ReorderOut{fy, cols, m1, m2}, lead * m1, cols,
                   ftw2, scale, st);
}

// 2D DFT over the last two axes of [batch, ny, nz], the radix route, in
// chunks of `chunk` planes: rows over Z into y, then columns over Y on y
// in place, scaled by `scale`. Each axis has its stage radices (host
// memory) and table (device memory).
int dfft_fft_plane(const void* x, void* y, long long batch, int ny,
                   int y_stages, const int* y_radices, int nz, int z_stages,
                   const int* z_radices, int forward, const void* twy,
                   const void* twz, long long chunk, float scale,
                   void* stream) {
  const radix::Plan py = radix::make_plan(ny, y_stages, y_radices);
  const radix::Plan pz = radix::make_plan(nz, z_stages, z_radices);
  if (!radix::valid_plan(py) || !radix::valid_plan(pz) || chunk < 1)
    return (int)cudaErrorInvalidValue;
  radix::RowsPass<> rows(pz, forward != 0);
  if (rows.err != cudaSuccess) return (int)rows.err;
  radix::ColsPass<> cols(py, forward != 0, nz);
  if (cols.err != cudaSuccess) return (int)cols.err;
  const long long plane = (long long)ny * nz;
  const cudaStream_t st = (cudaStream_t)stream;
  for (long long b0 = 0; b0 < batch; b0 += chunk) {
    const long long cnt = std::min(chunk, batch - b0);
    const float2* xs = (const float2*)x + b0 * plane;
    float2* ys = (float2*)y + b0 * plane;
    cudaError_t e = rows(xs, radix::RowOut{ys, nz}, cnt * ny,
                         (const float2*)twz, 1.0f, st);
    if (e != cudaSuccess) return (int)e;
    e = cols(ys, radix::C64Out{ys}, cnt, nz, (const float2*)twy, scale, st);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

// The same by the direct route: rows over Z into y, then the strided pass
// over Y on y in place. ny = y1*y2, nz = z1*z2; each pass has its own
// block size and scratch (nullptr = shared memory).
int dfft_fft_plane_direct(const void* x, void* y, void* scratch,
                          long long batch, int y1, int y2, int z1, int z2,
                          int seqs_z, int seqs_y, int z_in_smem,
                          int y_in_smem, const void* wy1, const void* ty,
                          const void* wy2, const void* wz1, const void* tz,
                          const void* wz2, float scale, void* stream) {
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

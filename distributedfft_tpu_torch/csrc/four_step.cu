// The row, strided and plane DFT kernels for Hopper (sm_90a): the port of
// the three Pallas kernels of distributedfft_tpu/ops/pallas_fft.py.
//
// Replaces (TPU kernel -> launcher here):
//   pallas_fft.py:_make_kernel          (1D rows)       -> dfft_fft_rows
//   pallas_fft.py:_make_kernel_strided  (leading axis)  -> dfft_fft_strided
//   pallas_fft.py:_make_kernel2d        (fused plane)   -> dfft_fft_plane
//
// Two routes. The radix route (dfft_fft_rows, dfft_fft_strided,
// dfft_fft_plane; device code and pass set-up in radix.cuh) takes, with
// the stage plan and table the host gives it (ops/radix.py), every
// kernel-eligible length n <= 8192 (a prime factor from 19 to 251 runs
// radix.cuh's generic prime stage), and so every eligible plane, whose
// axes are at most 8192 long. The two-pass radix route
// (dfft_fft_rows_2p, dfft_fft_strided_2p) takes the row and strided
// kernels' eligible lengths 8192 < n <= 65536: two radix passes, below.
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
// own (MAXR = kMaxPrime, compiled in generic.cu), so the variants of the
// smooth lengths compile and run as they did before it. The four-step
// sums it replaces cost 8*(n1+n2) flops a point, through device scratch
// past ~6000 points (31 ms at [1,9728,512], PERF.md).
//
// The strided kernel is the column pass of that routine over [lead, n,
// cols] (x -> y): each group is 16 neighbouring columns of one lead
// block, fewer only where cols is narrower. The plane is two passes of
// it: rows over Z (x -> y), then columns over Y in place on y, each pass
// the variant its axis's plan needs. A 512 x 512 plane (2 MiB) does not
// fit one block's 227 KB, where the TPU kernel kept it whole in VMEM, so
// the intermediate makes a round trip. The launcher can walk the batch in
// chunks of planes so that the round trip stays in the 50 MB L2
// (ops/radix.py:plane_chunk); on the H100 the chunked form measured
// slower than one pass over the whole batch (its launches are each under
// one wave of blocks; PERF.md), so fft2_last passes the whole batch.
//
// The two-pass route: n = m1*m2 (the four-step split of
// ops/cuda_fft.py:split_for, m1 <= m2 <= 256, each factor a radix plan,
// one stage when it is a prime over 17, as 241 of 8194 = 34 * 241), j =
// j1*m2 + j2 and k = k1 + m1*k2. A whole sequence no longer fits one
// block's shared memory with its exchange buffers, so the transform is
// the four-step split run as two radix passes through a scratch the size
// of the data, each pass one read and one write of device memory (the
// route's bound is twice the one-pass bound), every operand of the
// butterflies in registers or shared memory:
//   pass 1: the length-m1 column pass over j1 of x as [lead, m1,
//     m2*cols] (rows: [batch, m1, m2], cols = 1); its sink (radix.cuh:
//     TwiddleOut) multiplies output (k1, j2) by T[j2, k1] = w_n^(k1*j2),
//     the four-step twiddle table built in float64 (given transposed),
//     and stores to the scratch in place of j1;
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
// Every launcher returns cudaGetLastError() of its own launches.

#include "radix.cuh"

namespace radix {

cudaError_t two_pass_first(const float2* x, float2* s, long long lead,
                           long long cols, const Plan& p1, int m2, bool fwd,
                           const float2* tw1, const float2* tt,
                           cudaStream_t st) {
  const long long nz = (long long)m2 * cols;
  ColsPass<TwiddleOut> pass(p1, fwd, nz, 0, two_pass_most(p1));
  if (pass.err != cudaSuccess) return pass.err;
  return pass(x, TwiddleOut{s, tt, nz, cols, m2}, lead, nz, tw1, 1.0f, st);
}

cudaError_t two_pass_second(const float2* s, float2* y, long long lead,
                            long long cols, int m1, const Plan& p2, bool fwd,
                            const float2* tw2, float scale, cudaStream_t st) {
  const int m2 = p2.n;
  if (cols == 1) {
    auto extra = [m2](int seqs) { return TransposeOut::bytes(m2, seqs); };
    const int g = rows_per_group(p2, 16, extra);
    RowsPass<TransposeOut> pass(p2, fwd, g, extra(g));
    if (pass.err != cudaSuccess) return pass.err;
    return pass(s, TransposeOut{y, m1, m2, odd_ld(g)}, lead * m1, tw2, scale,
                st);
  }
  ColsPass<ReorderOut> pass(p2, fwd, cols, 0, two_pass_most(p2));
  if (pass.err != cudaSuccess) return pass.err;
  return pass(s, ReorderOut{y, cols, m1, m2}, lead * m1, cols, tw2, scale,
              st);
}

}  // namespace radix

namespace {

// The two-pass route over [lead, n, cols] (cols = 1: rows): pass 1 into
// s, then pass 2 into y.
cudaError_t two_pass(const float2* x, float2* y, float2* s, long long lead,
                     long long cols, const radix::Plan& p1,
                     const radix::Plan& p2, bool fwd, const float2* tw1,
                     const float2* tw2, const float2* tt, float scale,
                     cudaStream_t st) {
  cudaError_t e = radix::two_pass_first(x, s, lead, cols, p1, p2.n, fwd, tw1,
                                        tt, st);
  if (e != cudaSuccess) return e;
  return radix::two_pass_second(s, y, lead, cols, p1.n, p2, fwd, tw2, scale,
                                st);
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
  return (int)two_pass((const float2*)x, (float2*)y, (float2*)scratch, batch,
                       1, p1, p2, forward != 0, (const float2*)tw1,
                       (const float2*)tw2, (const float2*)tt, scale,
                       (cudaStream_t)stream);
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
  return (int)two_pass((const float2*)x, (float2*)y, (float2*)scratch, lead,
                       cols, p1, p2, forward != 0, (const float2*)tw1,
                       (const float2*)tw2, (const float2*)tt, scale,
                       (cudaStream_t)stream);
}

// 2D DFT over the last two axes of [batch, ny, nz], the radix route, in
// chunks of `chunk` planes: rows over Z into y, then columns over Y on y
// in place, scaled by `scale`. Each axis has its stage radices (host
// memory) and table (device memory: the twiddles, then the roots of each
// generic stage, as dfft_fft_rows takes them); each pass takes the kernel
// variant of its axis's plan (radix.cuh:Pass).
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

}  // extern "C"

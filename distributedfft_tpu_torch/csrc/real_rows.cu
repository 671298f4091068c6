// The real-to-complex and complex-to-real rows passes for Hopper (sm_90a):
// the packed-real trick of ops/realfft.py (r2c_via_half_complex,
// c2r_via_half_complex) in one radix pass each way.
//
// A real row of even length n = 2h is the complex row z[m] = x[2m] + i
// x[2m+1] of length h, read in place: the [rows, n] float32 array is the
// [rows, h] complex64 one, with no pack copy. Its DFT Z = FFT_h(z) gives
// the n/2 + 1 outputs of the real DFT by the untangle
//
//   X[k] = (Z[k] + Z*[h-k])/2 - (i/2) w[k] (Z[k] - Z*[h-k]),  Z[h] = Z[0],
//
// k = 0..h, w[k] = e^{-2 pi i k/n}, and the inverse packs the hermitian
// half Y back into Z[k] = E + iO with E = (Y[k] + Y*[h-k])/2 and O =
// (Y[k] - Y*[h-k]) conj(w[k]) / 2, runs the inverse length-h transform
// (scale 1/h) and stores z as the real row (the inverse's 1/n in all).
// w is the host's table of ops/realfft.py:twiddle (h + 1 complex64
// built in float64, device memory, read through the read-only cache).
//
// Launchers:
//   dfft_r2c_rows: real [batch, 2h] -> [batch, h + 1] complex64
//   dfft_c2r_rows: [batch, h + 1] complex64 -> real [batch, 2h]
//
// It replaces no TPU kernel: the JAX package runs the untangle as XLA
// ops around its row kernel, and the port ran it as some ten PyTorch
// passes and copies around kernel 3, three quarters of an R2C pair's
// device time at 512^3 (PERF.md). What bounds it on an H100: bytes, one
// read of the input and one write of the output (3.35 TB/s); the
// untangle adds a few flops an element to the radix stages' ~30, far
// under the card's fp32 balance.
//
// Each is one rows pass of radix.cuh (radix::run_stages over groups of
// whole rows, persistent blocks, cp.async landing with prefetch), so each
// reads its input once and writes its output once:
// - R2C: the landed copy of z is the first stage's input as it is; the
//   last stage's sink writes each row's Z into the exchange buffer the
//   last stage does not read (staged as TransposeOut stages its rows,
//   but in memory the pass already has, so staging costs no shared
//   memory); once the group's rows are all there, the flush untangles
//   them a pair (k, h-k) an item and stores each row's h + 1 outputs.
// - C2R: a group's rows of h + 1 values land as one contiguous range;
//   the first stage's reader forms Z[i] from Y[i], Y[h-i] and conj(w[i])
//   as it reads each element; the last stage stores z straight from
//   registers into the real output seen as complex64.
//
// Every variant (MAXR 8, 17 and the generic prime stage's 251) of both
// kernels is compiled here, in a translation unit of its own, so that
// the other units' kernels compile as they did. Each launcher returns
// cudaGetLastError() of its launch.

#include "radix.cuh"

namespace radix {

// The kernels' shared signature: input, output, rows, the length-h plan,
// rows per group, layout, stage table, untangle twiddles w, scale.
using RealKernel = void (*)(const float2*, float2*, long long, Plan, int,
                            Smem, const float2*, const float2*, float);

// X[b, k], k = 0..h, of the real rows x[b, :] (as [batch, h] complex64)
// into y [batch, h + 1]; `scale` unused (the forward is unnormalized).
template <int MAXR>
__global__ void __launch_bounds__(kThreads)
r2c_rows_kernel(const float2* x, float2* y, long long batch, Plan plan,
                int seqs, Smem sm, const float2* twg, const float2* wt,
                float) {
  extern __shared__ float4 radix_smem[];
  float2* smem = reinterpret_cast<float2*>(radix_smem);
  float2* tw = smem + sm.twiddles();
  const int h = plan.n, m = h + 1, ld = padded_ld(h);
  load_twiddles(tw, twg, plan);
  const Lane ln = lane<false>(seqs);
  const long long groups = (batch + seqs - 1) / seqs;
  // the last stage reads a after an even number of stages, else b
  // (run_stages swaps them after each stage between the first and the
  // last): its sink writes the other
  const bool stage_in_b = (plan.stages & 1) == 0;
  auto count = [&](long long g) {
    return (int)(batch - g * seqs < seqs ? batch - g * seqs : seqs);
  };
  group_loop(
      smem, sm, groups,
      [&](long long g, float2* dst) {
        load_range(dst, x + g * seqs * h, count(g) * h);
      },
      [&](long long g, float2* p, float2* a, float2* b, auto after) {
        const long long row = g * seqs + ln.s;
        const float2* in = p + ln.s * h;
        float2* z = stage_in_b ? b : a;
        float2* zs = z + ln.s * ld;
        run_stages<true, false, MAXR>(
            [=](int i) { return in[i]; },
            [=](int i, float2 v) { zs[i + (i >> 4)] = v; }, row < batch, ln,
            seqs, plan, a, b, tw, 1.0f, after);
        const int cnt = count(g);
        float2* out = y + g * seqs * m;
        // the untangle of the group's rows: item e is the pair (k, h-k)
        // of row s, k <= h/2, whose X[k] and X[h-k] both read Z[k] and
        // Z[h-k]; neighbouring threads take neighbouring k, so a warp's
        // stores are two runs, one up and one down a row
        const int pairs = (h >> 1) + 1;
        for (int e = threadIdx.x; e < cnt * pairs; e += blockDim.x) {
          const int s = e / pairs, k = e - s * pairs;
          const float2* zr = z + s * ld;
          float2* o = out + s * m;
          const int k2 = h - k, k2m = k == 0 ? 0 : k2;  // Z[h] = Z[0]
          const float2 u = zr[k + (k >> 4)], v = zr[k2m + (k2m >> 4)];
          // X[k] from u = Z[k], v = Z[h-k]; X[h-k] the same with u, v
          // swapped
          const float2 sum = make_float2(u.x + v.x, u.y - v.y);  // u + v*
          const float2 dif = make_float2(u.x - v.x, u.y + v.y);  // u - v*
          const float2 wd = cmul(__ldg(wt + k), dif);
          o[k] = make_float2(0.5f * (sum.x + wd.y), 0.5f * (sum.y - wd.x));
          if (k2 != k) {
            const float2 sum2 = make_float2(v.x + u.x, v.y - u.y);
            const float2 dif2 = make_float2(v.x - u.x, v.y + u.y);
            const float2 wd2 = cmul(__ldg(wt + k2), dif2);
            o[k2] = make_float2(0.5f * (sum2.x + wd2.y),
                                0.5f * (sum2.y - wd2.x));
          }
        }
      });
}

// The real rows x[b, :] (as [batch, h] complex64) of the hermitian halves
// y [batch, h + 1], the inverse length-h transform times `scale`.
template <int MAXR>
__global__ void __launch_bounds__(kThreads)
c2r_rows_kernel(const float2* y, float2* x, long long batch, Plan plan,
                int seqs, Smem sm, const float2* twg, const float2* wt,
                float scale) {
  extern __shared__ float4 radix_smem[];
  float2* smem = reinterpret_cast<float2*>(radix_smem);
  float2* tw = smem + sm.twiddles();
  const int h = plan.n, m = h + 1;
  load_twiddles(tw, twg, plan);
  const Lane ln = lane<false>(seqs);
  const long long groups = (batch + seqs - 1) / seqs;
  auto count = [&](long long g) {
    return (int)(batch - g * seqs < seqs ? batch - g * seqs : seqs);
  };
  group_loop(
      smem, sm, groups,
      [&](long long g, float2* dst) {
        load_range(dst, y + g * seqs * m, count(g) * m);
      },
      [&](long long g, float2* p, float2* a, float2* b, auto after) {
        const long long row = g * seqs + ln.s;
        const float2* in = p + ln.s * m;
        auto packed = [=](int i) {  // Z[i] = E + iO
          const float2 u = in[i], v = in[h - i];
          const float2 e = make_float2(0.5f * (u.x + v.x), 0.5f * (u.y - v.y));
          const float2 d = make_float2(0.5f * (u.x - v.x), 0.5f * (u.y + v.y));
          const float2 w = __ldg(wt + i);
          const float2 o = cmul(d, make_float2(w.x, -w.y));
          return make_float2(e.x - o.y, e.y + o.x);
        };
        run_stages<false, false, MAXR>(packed, store_c64(x + row * h, 1),
                                       row < batch, ln, seqs, plan, a, b, tw,
                                       scale, after);
      });
}

}  // namespace radix

namespace {

using radix::Plan;

// One rows pass of kernel family k8 / k17 / kgen over `batch` rows of
// length-h plan p, the layout the plain rows pass's (the C2R landing of
// h + 1 values a row fits its buffer of padded_ld(h)). Rows per group:
// enough that the stage with the fewest items gives every thread one, as
// far as the whole of a block's shared memory (kMaxSmem) allows with
// prefetch, where the plain rows pass stops at kRadixSmem: at h = 256
// (16.16) that is 32 rows where it takes 16 and leaves half the threads
// idle in every stage. One block a SM: the radix-16 variants take
// 112-126 registers a thread, so a second never fits. At [262144, 256]
// the plain pass's 16 rows ran the R2C pass in 0.537 ms and the C2R in
// 0.450; 32 rows run them in 0.440 and 0.380 (H100 80GB HBM3, 700 W;
// PERF.md §6). The rule is radix::rows_per_group's with another cap;
// giving that a cap argument, and calling it here, is left to a change
// that may rebuild the C2C kernels (ROADMAP.md, Queue 2 item 3).
cudaError_t real_pass(radix::RealKernel k8, radix::RealKernel k17,
                      radix::RealKernel kgen, const float2* in, float2* out,
                      long long batch, const Plan& p, const float2* tw,
                      const float2* wt, float scale, cudaStream_t st) {
  int group = 1;
  while ((long long)group * radix::min_items(p) < radix::kThreads) group *= 2;
  while (group > 1) {
    const int b = group * radix::padded_ld(p.n);
    if (radix::smem_bytes(p.table, radix::Smem{b, b, 1}, 0) <= radix::kMaxSmem)
      break;
    group /= 2;
  }
  const int buf = group * radix::padded_ld(p.n);
  radix::Pass<radix::RealKernel> pass(p, group, buf, buf, 0, k8, k17, kgen);
  if (pass.err != cudaSuccess) return pass.err;
  const long long blocks = pass.blocks((batch + group - 1) / group);
  if (blocks > 0)
    pass.kernel<<<(unsigned)blocks, radix::kThreads, pass.shm, st>>>(
        in, out, batch, pass.plan, group, pass.sm, tw, wt, scale);
  return cudaGetLastError();
}

// The launchers' checks: a plan the kernels run, distinct, 8-byte aligned
// input and output, both tables.
bool valid_real(const Plan& p, long long batch, const void* in,
                const void* out, const void* tw, const void* wt) {
  return radix::valid_plan(p) && batch >= 0 && in != nullptr &&
         out != nullptr && in != out && tw != nullptr && wt != nullptr &&
         ((reinterpret_cast<size_t>(in) | reinterpret_cast<size_t>(out)) &
          7) == 0;
}

}  // namespace

extern "C" {

// y[b, k] = sum_j x[b, j] e^{-2 pi i jk/n}, k = 0..h, for the real rows
// x [batch, n = 2h] float32 into y [batch, h + 1] complex64: h has the
// stage radices radices[0..stages-1] (host memory) and the forward stage
// table tw (device memory, ops/radix.py:table_np); wt holds w[k] =
// e^{-2 pi i k/n}, k = 0..h (device memory, ops/realfft.py:twiddle).
int dfft_r2c_rows(const void* x, void* y, long long batch, int h, int stages,
                  const int* radices, const void* tw, const void* wt,
                  void* stream) {
  const Plan plan = radix::make_plan(h, stages, radices);
  if (!valid_real(plan, batch, x, y, tw, wt))
    return (int)cudaErrorInvalidValue;
  using radix::r2c_rows_kernel;
  return (int)real_pass(r2c_rows_kernel<8>, r2c_rows_kernel<radix::kMaxHand>,
                        r2c_rows_kernel<radix::kMaxPrime>, (const float2*)x,
                        (float2*)y, batch, plan, (const float2*)tw,
                        (const float2*)wt, 1.0f, (cudaStream_t)stream);
}

// The inverse: the real rows x [batch, 2h] float32 of the hermitian halves
// y [batch, h + 1] complex64, times `scale` (1/h: numpy's irfft), with
// the inverse stage table tw and wt as dfft_r2c_rows takes them.
int dfft_c2r_rows(const void* y, void* x, long long batch, int h, int stages,
                  const int* radices, const void* tw, const void* wt,
                  float scale, void* stream) {
  const Plan plan = radix::make_plan(h, stages, radices);
  if (!valid_real(plan, batch, y, x, tw, wt))
    return (int)cudaErrorInvalidValue;
  using radix::c2r_rows_kernel;
  return (int)real_pass(c2r_rows_kernel<8>, c2r_rows_kernel<radix::kMaxHand>,
                        c2r_rows_kernel<radix::kMaxPrime>, (const float2*)y,
                        (float2*)x, batch, plan, (const float2*)tw,
                        (const float2*)wt, scale, (cudaStream_t)stream);
}

}  // extern "C"

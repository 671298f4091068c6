// The two-level long-axis route for Hopper (sm_90a): the port of
// distributedfft_tpu/ops/pallas_fft.py:_fft_last_big, which chains the
// strided kernel (_make_kernel_strided), an XLA-level twiddle, the row
// kernel (_make_kernel) and an XLA-level transpose.
//
// Replaces (TPU path -> launcher here):
//   pallas_fft.py:_fft_last_big  (two levels of kernels 2 and 3)
//                                -> dfft_fft_two_level
//
// A length n past one kernel's reach (ops/cuda_fft.py:outer_split
// decides which) runs as a chain of radix passes of radix.cuh's column
// and rows kernels, each pass one read and one write of device memory,
// nothing between them: n = f1 * ... * fk * L (ops/cuda_fft.py:
// two_level_passes: each fi <= 256, L <= 8192). This is the recursive
// four-step. With F the product of the earlier passes' lengths and N =
// n / F the length still to transform, the data is [batch, F, N] and
// block (b, K) holds the sequence of batch row b whose earlier output
// keys compose to K = k1 + f1*(k2 + f2*(...)). Pass i (a column pass,
// TwoLevelColsOut) runs the length-fi DFT over j = j_i * (N/fi) + c of
// every block, i.e. over the [batch*F, fi, N/fi] array, and stores
// output (k, c) of block K in block K + F*k (ReorderOut's store with m1
// = F, m2 = fi: a warp still stores runs of neighbouring columns) times
// w_N^(k*c), the twiddle of the step that follows. The last pass
// (TwoLevelRowsOut) runs the length-L DFT over the [batch*F, L] rows and
// stores (K, k) at K + F*k of its batch row: the transpose to natural
// order, times the inverse's scale.
//
// What bounds it on an H100: bytes, 16 per element per pass (3.35
// TB/s); the bound of the route is the pass count times one read and one
// write. So each pass is a radix pass as the two-pass route's are
// (four_step.cu): groups of 16-64 neighbouring columns of a short factor
// (runs of >= 128 bytes), every operand in registers or shared memory,
// and the twiddle and reorder in the store instead of a pass of their
// own. The twiddle is never read from a table the size of the data:
// w_N^p, p = k*c < N, is T_hi[p >> s] * T_lo[p & (2^s - 1)] (complex64
// tables built in float64, ops/cuda_fft.py:twiddle_tables_np, about
// sqrt(N) entries each, s <= 11): T_lo in the pass's shared memory, T_hi
// through the read-only cache (neighbouring columns read one or two
// entries), for the first output of each butterfly of the last stage;
// its other outputs take one product each (TwoLevelColsOut). The rows
// pass's store is staged through shared memory as TransposeOut's when 16
// rows of L fit a block with their staging (L up to ~550): each k then
// stores a run of >= 16 consecutive K, >= 128 bytes. A longer L holds
// one or two rows a block, so its outputs go straight from registers, 8
// bytes each at a stride of F elements, several times slower than a
// staged pass (PERF.md): two_level_passes picks a staged last pass
// wherever the length has one. The passes ping-pong between y and
// one scratch the size of the data, the last writing y: the reorder
// crosses groups, so no pass runs in place. Offsets are 64-bit (batch *
// n may pass 2^31).
//
// Every kernel variant of the route (MAXR 8, 17 and the generic prime
// stage's 251, both directions) is compiled here, in a translation unit
// of its own, so that the other units' kernels compile as they did.
// dfft_fft_two_level returns cudaGetLastError() of its own launches.

#include "radix.cuh"

namespace radix {

// Most passes of one route; most bits of the low twiddle table.
constexpr int kMaxPasses = 16;
constexpr int kMaxTwiddleBits = 12;

// A column pass of the two-level route over the [lead, m2, cols] blocks
// of the data (lead = batch*m1, block l = b*m1 + K): output k of column c
// of block l goes to (b*m1*m2 + K + m1*k)*cols + c, times w_N^(k*c) with
// N = m2*cols (p = k*c < N: the product needs no reduction, and is
// exact in 64 bits). The last stage hands a thread the outputs k = j,
// j + step, ..., j + (R - 1)*step of each butterfly in that order (step
// = m2 / R, R its radix), so the sink forms w_N^(j*c) from the two
// tables and each next twiddle as the one before times w_N^(step*c),
// looked up once per column; an output out of that order (a generic
// stage's pairs) takes the tables again. R - 1 <= 16 products in fp32:
// within ~1e-6 of the tables' value.
struct TwoLevelColsOut {
  float2* y;
  const float2* hi;    // T_hi, device memory
  const float2* lo_g;  // T_lo, device memory: copied to lo by begin
  long long cols;
  int m1, m2, bits, step;
  float2* lo;
  static size_t bytes(int bits) { return sizeof(float2) << bits; }
  __device__ void begin(void* extra) {
    lo = static_cast<float2*>(extra);
    for (int i = threadIdx.x; i < (1 << bits); i += blockDim.x)
      lo[i] = __ldg(lo_g + i);
  }
  __device__ auto column(long long e, long long) {
    const long long span = (long long)m2 * cols;
    const long long blk = e / span, c = e - blk * span;
    const long long b = blk / m1, k1 = blk - b * m1;
    float2* d = y + (b * m1 * m2 + k1) * cols + c;
    const long long stride = (long long)m1 * cols;
    const float2* h = hi;
    const float2* t = lo;
    const int s = bits, st = step;
    const unsigned long long mask = (1ull << s) - 1, cu = c;
    auto w = [=](unsigned long long p) {
      return cmul(__ldg(h + (p >> s)), t[p & mask]);
    };
    const float2 ws = w(st * cu);
    int last = -(1 << 30);
    float2 cur = make_float2(1.f, 0.f);
    return [=](int i, float2 v) mutable {
      cur = i == last + st ? cmul(cur, ws) : w(i * cu);
      last = i;
      d[i * stride] = cmul(v, cur);
    };
  }
  __device__ void end() {}
};

// The last pass of the two-level route, a rows pass over [batch*m1, m2]:
// row r = b*m1 + K, output k to y[b*m1*m2 + K + m1*k]. ld > 0: staged as
// TransposeOut's (ld = odd_ld(rows per group), the last stage writing
// the group's rows at k*ld + s, flush storing each k's run of the
// group's rows); ld = 0: each output stored from registers.
struct TwoLevelRowsOut {
  float2* y;
  long long m1;
  int m2, ld;
  float2* stage;
  __device__ void begin(void* extra) { stage = static_cast<float2*>(extra); }
  __device__ auto row(long long r, int s) {
    float2* d = stage + s;
    long long step = ld;
    if (ld == 0) {
      const long long b = r / m1;
      d = y + b * m1 * m2 + (r - b * m1);
      step = m1;
    }
    return [=](int i, float2 v) { d[i * step] = v; };
  }
  __device__ void flush(long long r0, int cnt) {
    if (ld == 0) return;
    // thread -> the group's row s, k = k0, k0 + per, ...: neighbouring
    // threads store neighbouring K
    const int per = blockDim.x / cnt, s = threadIdx.x % cnt;
    const int k0 = threadIdx.x / cnt;
    if (k0 >= per) return;
    const long long b0 = r0 / m1;
    const long long k1 = r0 - b0 * m1 + s, q = k1 / m1;
    float2* d = y + (b0 + q) * m1 * m2 + (k1 - q * m1);
    for (int k = k0; k < m2; k += per) d[m1 * k] = stage[k * ld + s];
  }
  __device__ void end() {}
};

}  // namespace radix

namespace {

using radix::Plan;

// One column pass: length p.n over x as [lead, p.n, cols] into y.
cudaError_t cols_pass(const float2* x, float2* y, long long lead,
                      long long cols, const Plan& p, int m1, bool fwd,
                      const float2* tw, const float2* hi, const float2* lo,
                      int bits, cudaStream_t st) {
  using Out = radix::TwoLevelColsOut;
  radix::ColsPass<Out> pass(p, fwd, cols, Out::bytes(bits),
                            radix::two_pass_most(p));
  if (pass.err != cudaSuccess) return pass.err;
  const int step = p.n / p.radix[p.stages - 1];
  return pass(x, Out{y, hi, lo, cols, m1, p.n, bits, step, nullptr}, lead,
              cols, tw, 1.0f, st);
}

// The last pass: length p.n over s as [rows, p.n] into y, row r = b*m1 +
// K. 16 rows a group, staged, when they fit the card with their staging;
// else the rows that fit (radix::rows_per_group), stored from registers.
cudaError_t rows_pass(const float2* s, float2* y, long long rows,
                      long long m1, const Plan& p, bool fwd, const float2* tw,
                      float scale, cudaStream_t st) {
  using Out = radix::TwoLevelRowsOut;
  const int len = p.n;
  auto extra = [len](int seqs) {
    return radix::TransposeOut::bytes(len, seqs);
  };
  const int buf16 = 16 * radix::padded_ld(len);
  if (radix::smem_bytes(p.table, radix::Smem{buf16, buf16, 0}, extra(16)) <=
      radix::kMaxSmem) {
    const int g = radix::rows_per_group(p, 16, extra);
    radix::RowsPass<Out> pass(p, fwd, g, extra(g));
    if (pass.err != cudaSuccess) return pass.err;
    return pass(s, Out{y, m1, len, radix::odd_ld(g), nullptr}, rows, tw,
                scale, st);
  }
  radix::RowsPass<Out> pass(p, fwd, radix::rows_per_group(p), 0);
  if (pass.err != cudaSuccess) return pass.err;
  return pass(s, Out{y, m1, len, 0, nullptr}, rows, tw, scale, st);
}

}  // namespace

extern "C" {

// y[b, :] = DFT(x[b, :]) * scale for b < batch by the two-level route:
// n = lengths[0] * ... * lengths[passes-1], passes 0 .. passes-2 column
// passes, the last a rows pass. Pass i has stages[i] radices (the
// radices concatenated pass by pass, host memory), its stage table
// tables[i] and, for a column pass, the twiddle tables tw_hi[i], tw_lo[i]
// of w_N^p (N the product of lengths[i..], 2^tw_bits[i] entries in
// tw_lo) (device memory). scratch holds batch*n complex64 (neither x nor
// y; y is not x).
int dfft_fft_two_level(const void* x, void* y, void* scratch, long long batch,
                       int passes, const int* lengths, const int* stages,
                       const int* radices, int forward,
                       const void* const* tables, const void* const* tw_hi,
                       const void* const* tw_lo, const int* tw_bits,
                       float scale, void* stream) {
  if (passes < 2 || passes > radix::kMaxPasses || batch < 0 ||
      scratch == nullptr || scratch == x || scratch == y || x == y)
    return (int)cudaErrorInvalidValue;
  Plan plans[radix::kMaxPasses];
  for (int i = 0, at = 0; i < passes; at += stages[i], ++i) {
    if (stages[i] < 1 || stages[i] > radix::kMaxStages)
      return (int)cudaErrorInvalidValue;
    plans[i] = radix::make_plan(lengths[i], stages[i], radices + at);
    if (!radix::valid_plan(plans[i]) || tables[i] == nullptr)
      return (int)cudaErrorInvalidValue;
    if (i < passes - 1 &&
        (tw_bits[i] < 1 || tw_bits[i] > radix::kMaxTwiddleBits ||
         tw_hi[i] == nullptr || tw_lo[i] == nullptr))
      return (int)cudaErrorInvalidValue;
  }
  long long n = 1;
  for (int i = 0; i < passes; ++i) n *= lengths[i];
  if (n >= 1LL << 31) return (int)cudaErrorInvalidValue;
  const bool fwd = forward != 0;
  const cudaStream_t st = (cudaStream_t)stream;
  // pass i writes y when passes - 1 - i is even, else the scratch, so
  // that the last writes y and none reads what it writes
  const float2* in = (const float2*)x;
  long long f = 1, cols = n;
  for (int i = 0; i < passes - 1; ++i) {
    float2* out = (passes - 1 - i) % 2 == 0 ? (float2*)y : (float2*)scratch;
    cols /= lengths[i];
    const cudaError_t e =
        cols_pass(in, out, batch * f, cols, plans[i], (int)f, fwd,
                  (const float2*)tables[i], (const float2*)tw_hi[i],
                  (const float2*)tw_lo[i], tw_bits[i], st);
    if (e != cudaSuccess) return (int)e;
    in = out;
    f *= lengths[i];
  }
  return (int)rows_pass(in, (float2*)y, batch * f, f, plans[passes - 1], fwd,
                        (const float2*)tables[passes - 1], scale, st);
}

}  // extern "C"

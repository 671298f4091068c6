// dfft_native — the host runtime library of distributedfft_tpu_torch.
//
// The C++ runtime layer around the card's plans: the plan-time scheduler
// that splits one FFT axis into bounded passes (the FFTScheduler role,
// templateFFT/src/templateFFT.cpp:3941-4100, bounded by shared memory
// there and by the caller's factor limit here), the processor-grid
// geometry searches (make_procgrid / proc_setup_min_surface,
// heffte_geometry.h:303,589), the uneven-slab exchange count/offset tables
// (TransInfo construction, 3dmpifft_opt/include/fft_mpi_3d_api.cpp:84-133),
// a low-overhead thread-safe trace-event recorder (the heffte_trace.h
// RAII event log, :48-127), and the transform-time C ABI (heffte_c.h)
// whose callbacks the Python side installs.
//
// Planning and observability code only: no CUDA call. The card's work
// belongs to the PyTorch plans and their CUDA kernels (csrc/*.cu). Built
// with g++ at first use by distributedfft_tpu_torch/native.py into
// distributedfft_tpu_torch/_build/ (-Bsymbolic: the library's own calls,
// such as dfft_c_selftest -> dfft_plan_c2c_3d, stay inside it even when
// another library of the same ABI is loaded in the process). Python
// keeps a mirror of every planning function, and the tests hold the two
// equal. The ABI (names, signatures, kind and op codes, version 3) is
// that of the JAX package's native/dfft_native.cpp, so a C or Fortran
// driver written against one links against the other.

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- version

int dfft_abi_version() { return 3; }

// ------------------------------------------------------------- scheduler
//
// Factor n into at most max_passes factors, each <= max_factor, balanced so
// the largest factor is as small as possible (stages closest to square
// balance the passes). Returns the number of passes and writes the
// factors (descending) into splits_out, or returns:
//   -1  if n has a prime factor > max_factor (caller switches to Bluestein)
//   -2  if n needs more than max_passes factors of size <= max_factor

static void prime_factors(long long n, std::vector<long long>& out) {
  for (long long p = 2; p * p <= n; ++p) {
    while (n % p == 0) {
      out.push_back(p);
      n /= p;
    }
  }
  if (n > 1) out.push_back(n);
}

int dfft_schedule_axis(long long n, long long max_factor, int max_passes,
                       long long* splits_out) {
  if (n < 1 || max_factor < 2 || max_passes < 1) return -3;
  if (n == 1) {
    splits_out[0] = 1;
    return 1;
  }
  std::vector<long long> primes;
  prime_factors(n, primes);
  for (long long p : primes)
    if (p > max_factor) return -1;

  // Find the smallest pass count that can work at all.
  for (int passes = 1; passes <= max_passes; ++passes) {
    // Feasibility: product must fit in passes factors of <= max_factor.
    // Greedy first-fit-decreasing into `passes` bins (product-balanced).
    std::sort(primes.begin(), primes.end(), std::greater<long long>());
    std::vector<long long> bins(passes, 1);
    bool ok = true;
    for (long long p : primes) {
      // Place into the fullest bin that still fits (keeps factors large and
      // count small), else the emptiest.
      int best = -1;
      for (int b = 0; b < passes; ++b)
        if (bins[b] * p <= max_factor && (best < 0 || bins[b] > bins[best]))
          best = b;
      if (best < 0) {
        ok = false;
        break;
      }
      bins[best] *= p;
    }
    if (!ok) continue;
    // Rebalance pass: repeatedly move a prime from the largest bin to the
    // smallest when that reduces the max factor (keeps stages square-ish).
    for (int iter = 0; iter < 64; ++iter) {
      std::sort(bins.begin(), bins.end(), std::greater<long long>());
      if (bins.back() == 1 && bins.size() > 1) {
        bins.pop_back();  // unused pass
        continue;
      }
      std::vector<long long> f;
      prime_factors(bins.front(), f);
      std::sort(f.begin(), f.end());
      bool moved = false;
      for (long long p : f) {
        long long big = bins.front() / p, small = bins.back() * p;
        if (small <= max_factor &&
            std::max(big, small) < bins.front()) {
          bins.front() = big;
          bins.back() = small;
          moved = true;
          break;
        }
      }
      if (!moved) break;
    }
    std::sort(bins.begin(), bins.end(), std::greater<long long>());
    for (size_t i = 0; i < bins.size(); ++i) splits_out[i] = bins[i];
    return static_cast<int>(bins.size());
  }
  return -2;
}

// -------------------------------------------------------------- geometry

void dfft_procgrid2(long long p, long long* a, long long* b) {
  long long ba = 1, bb = p;
  for (long long x = 1; x * x <= p; ++x)
    if (p % x == 0) {
      ba = x;
      bb = p / x;
    }
  *a = ba;
  *b = bb;
}

void dfft_min_surface_grid(long long nx, long long ny, long long nz,
                           long long p, long long* out3) {
  double best = -1.0;
  for (long long a = 1; a <= p; ++a) {
    if (p % a) continue;
    long long q = p / a;
    for (long long b = 1; b <= q; ++b) {
      if (q % b) continue;
      long long c = q / b;
      double sx = double(nx) / a, sy = double(ny) / b, sz = double(nz) / c;
      double cost = sx * sy + sy * sz + sx * sz;
      if (best < 0.0 || cost < best) {
        best = cost;
        out3[0] = a;
        out3[1] = b;
        out3[2] = c;
      }
    }
  }
}

// 2D pencil grid (rows over axis 0, cols over axis 1) minimizing the input
// z-pencil box surface — the pencil-planner analog of the min-surface
// search above; consulted by logic_plan3d when building a mesh from a
// device count. Ties prefer more rows (the most-square heritage
// orientation). Kept in float lockstep with
// geometry.pencil_grid_min_surface.
void dfft_pencil_grid(long long n0, long long n1, long long n2, long long p,
                      long long* out2) {
  double best = -1.0;
  long long br = 1, bc = p;
  for (long long r = 1; r <= p; ++r) {
    if (p % r) continue;
    long long c = p / r;
    double sx = double(n0) / r, sy = double(n1) / c;
    double cost = sx * sy + sy * double(n2) + sx * double(n2);
    if (best < 0.0 || cost < best || (cost == best && r > br)) {
      best = cost;
      br = r;
      bc = c;
    }
  }
  out2[0] = br;
  out2[1] = bc;
}

// Balanced bounded divisor pair: (n1, n2) with n1 <= n2 <= max_factor and
// n1 maximal (closest to sqrt(n)) — the split rule of the four-step
// kernels and the matmul executor's recursion (the per-axis split
// decision of the reference's FFTScheduler, templateFFT.cpp:3941-4100).
// Returns 0 on success; -1 when no such pair exists (prime n, or n too
// large for the bound).
int dfft_balanced_split(long long n, long long max_factor, long long* out2) {
  for (long long d = (long long)std::sqrt((double)n) + 1; d >= 2; --d) {
    if (d > n) continue;
    if (n % d) continue;
    long long other = n / d;
    if (d > other) continue;  // keep n1 <= n2
    if (other > max_factor) return -1;  // even the most balanced n2 too big
    out2[0] = d;
    out2[1] = other;
    return 0;
  }
  return -1;
}

// -------------------------------------------------------- exchange tables
//
// Uneven-slab redistribution bookkeeping: device r holds X-rows
// [r*c0, min(n0,(r+1)*c0)) with c0 = ceil(n0/p) and after the global
// transpose holds Y-columns [r*c1, min(n1,(r+1)*c1)). The element counts
// each peer pair exchanges are the count tables the reference builds per
// plan (sendCounts/recvCounts/offsets incl. the asymmetric last device,
// fft_mpi_3d_api.cpp:84-133). The port's alltoallv transport exchanges
// these true slices; the padded transports ship ceil-sized blocks, and
// the tables size the true payloads for plan_info and the cost models.

static inline long long owned(long long n, long long chunk, long long r) {
  long long lo = r * chunk;
  if (lo >= n) return 0;
  return std::min(n, lo + chunk) - lo;
}

void dfft_exchange_table(long long n0, long long n1, long long n2,
                         long long p, long long rank,
                         long long* send_counts, long long* send_offsets,
                         long long* recv_counts, long long* recv_offsets) {
  long long c0 = (n0 + p - 1) / p, c1 = (n1 + p - 1) / p;
  long long my_rows = owned(n0, c0, rank);
  long long my_cols = owned(n1, c1, rank);
  long long soff = 0, roff = 0;
  for (long long j = 0; j < p; ++j) {
    long long sc = my_rows * owned(n1, c1, j) * n2;
    long long rc = owned(n0, c0, j) * my_cols * n2;
    send_counts[j] = sc;
    send_offsets[j] = soff;
    recv_counts[j] = rc;
    recv_offsets[j] = roff;
    soff += sc;
    roff += rc;
  }
}

// ----------------------------------------------------------------- trace
//
// Steady-clock event recorder: begin/end pairs by id, dump to a per-process
// log in the same "start  duration  name" shape as the Python tracer (which
// mirrors heffte_trace.h's finalize format).

namespace {
struct TraceEvent {
  std::string name;
  double start;
  double stop;  // < 0 while open
};
std::vector<TraceEvent> g_events;
std::mutex g_mu;
bool g_on = false;

double now_s() {
  using clk = std::chrono::steady_clock;
  return std::chrono::duration<double>(clk::now().time_since_epoch()).count();
}
}  // namespace

void dfft_trace_init() {
  std::lock_guard<std::mutex> lk(g_mu);
  g_events.clear();
  g_on = true;
}

long long dfft_trace_begin(const char* name) {
  std::lock_guard<std::mutex> lk(g_mu);
  if (!g_on) return -1;
  g_events.push_back({name ? name : "", now_s(), -1.0});
  return static_cast<long long>(g_events.size()) - 1;
}

void dfft_trace_end(long long id) {
  std::lock_guard<std::mutex> lk(g_mu);
  if (!g_on || id < 0 || id >= (long long)g_events.size()) return;
  g_events[id].stop = now_s();
}

long long dfft_trace_count() {
  std::lock_guard<std::mutex> lk(g_mu);
  return static_cast<long long>(g_events.size());
}

// ------------------------------------------------------------------ C API
// Transform-time C entries — the heffte_c surface
// (heffte_c.h:52-179: heffte_plan_create / heffte_forward / heffte_backward
// / heffte_plan_destroy) re-designed for a Python-hosted runtime. The
// card's plans live in PyTorch; rather than embedding an interpreter, the
// .so holds a function-pointer table that the Python side installs at
// init (distributedfft_tpu_torch.capi.install_c_api — the inverse of
// heffte.py's ctypes-over-libheffte direction). Any C/C++/Fortran code in
// a Python-hosted process can then plan, execute, and destroy transforms
// through the plain C ABI below; buffers are interleaved complex64
// (float re, float im), C-order [nx][ny][nz], full world per call.

typedef long long (*dfft_plan_cb)(long long nx, long long ny, long long nz,
                                  int direction);
typedef int (*dfft_exec_cb)(long long plan_id, const float* in, float* out);
typedef void (*dfft_destroy_cb)(long long plan_id);

// Callback slots are atomics: install/reinstall (e.g. switching the
// plans' world) may race a concurrent native reader, and the Python-side
// lock cannot cover C threads already inside dfft_execute_c2c. Atomics
// rule out torn installs; a reinstall while an execute is in flight is
// still the caller's quiescence problem (the old callback may run one
// more time), which install_c_api documents.
static std::atomic<dfft_plan_cb> g_plan_cb{0};
static std::atomic<dfft_exec_cb> g_exec_cb{0};
static std::atomic<dfft_destroy_cb> g_destroy_cb{0};

void dfft_c_api_install(dfft_plan_cb p, dfft_exec_cb e, dfft_destroy_cb d) {
  g_plan_cb.store(p, std::memory_order_release);
  g_exec_cb.store(e, std::memory_order_release);
  g_destroy_cb.store(d, std::memory_order_release);
}

int dfft_c_api_ready() {
  return (g_plan_cb.load(std::memory_order_acquire) &&
          g_exec_cb.load(std::memory_order_acquire) &&
          g_destroy_cb.load(std::memory_order_acquire))
             ? 1
             : 0;
}

// direction: -1 forward / +1 backward (FFTW sign convention, matching
// distributedfft_tpu_torch.FORWARD/BACKWARD). Returns a plan handle >= 0, or
// -1 when the bridge is not installed / planning failed.
long long dfft_plan_c2c_3d(long long nx, long long ny, long long nz,
                           int direction) {
  dfft_plan_cb cb = g_plan_cb.load(std::memory_order_acquire);
  if (!cb) return -1;
  return cb(nx, ny, nz, direction);
}

// Executes the planned transform: 0 on success.
int dfft_execute_c2c(long long plan, const float* in, float* out) {
  dfft_exec_cb cb = g_exec_cb.load(std::memory_order_acquire);
  if (!cb) return 1;
  return cb(plan, in, out);
}

void dfft_destroy_plan_c(long long plan) {
  dfft_destroy_cb cb = g_destroy_cb.load(std::memory_order_acquire);
  if (cb) cb(plan);
}

// Self-test driven entirely from compiled C: ramp data (the reference
// driver's init, fftSpeed3d_c2c.cpp:61-63), forward + backward through
// the C ABI, returns the relative roundtrip max error (negative on any
// failure). The proof that a C caller owns the full transform lifecycle.
double dfft_c_selftest(long long nx, long long ny, long long nz) {
  if (!dfft_c_api_ready()) return -1.0;
  long long n = nx * ny * nz;
  if (n <= 0) return -2.0;
  float* x = (float*)std::malloc(sizeof(float) * 2 * n);
  float* y = (float*)std::malloc(sizeof(float) * 2 * n);
  float* z = (float*)std::malloc(sizeof(float) * 2 * n);
  if (!x || !y || !z) {
    std::free(x); std::free(y); std::free(z);
    return -3.0;
  }
  for (long long i = 0; i < n; ++i) {
    x[2 * i] = (float)(i % 97) * 1e-2f;      // re
    x[2 * i + 1] = (float)(i % 89) * -1e-2f; // im
  }
  double err = -4.0;
  long long fwd = dfft_plan_c2c_3d(nx, ny, nz, -1);
  long long bwd = dfft_plan_c2c_3d(nx, ny, nz, +1);
  if (fwd >= 0 && bwd >= 0 && dfft_execute_c2c(fwd, x, y) == 0 &&
      dfft_execute_c2c(bwd, y, z) == 0) {
    double mx = 0.0, me = 0.0;
    for (long long i = 0; i < 2 * n; ++i) {
      double ax = x[i] < 0 ? -x[i] : x[i];
      double d = (double)z[i] - (double)x[i];
      if (d < 0) d = -d;
      if (ax > mx) mx = ax;
      if (d > me) me = d;
    }
    err = mx > 0 ? me / mx : me;
  }
  if (fwd >= 0) dfft_destroy_plan_c(fwd);
  if (bwd >= 0) dfft_destroy_plan_c(bwd);
  std::free(x); std::free(y); std::free(z);
  return err;
}

// ------------------------------------------------------ typed C API (v2)
// The full heffte_c type matrix (heffte_c.h:63,141-179): float r2c/c2r
// plans with a selectable halved axis (heffte r2c_direction), and DOUBLE
// transforms — z2z (complex<->complex) and d2z/z2d (real<->complex) —
// carried by the dd (double-double) tier, the port's (hi, lo) float pairs
// (ops/ddfft.py). Plus plan-resident device buffers
// (upload / execute_resident / download) so a C driver can repeat-execute
// without a host round-trip per call — the reference benchmark pattern
// (warm + timed loop, fftSpeed3d_c2c.cpp:94-98).
//
// Dispatch rides two generic callbacks the Python runtime installs; the
// typed entry points below are the stable C surface.

// kind: 0 = c2c complex64, 1 = r2c float32/complex64,
//       2 = z2z double (dd tier), 3 = d2z double real (dd tier)
typedef long long (*dfft_plan2_cb)(int kind, long long nx, long long ny,
                                   long long nz, int direction, int axis);
// op: 0 = execute host->host, 1 = upload resident input,
//     2 = execute resident, 3 = download resident output
typedef int (*dfft_exec2_cb)(long long plan, int op, const void* in,
                             void* out);

static std::atomic<dfft_plan2_cb> g_plan2_cb{0};
static std::atomic<dfft_exec2_cb> g_exec2_cb{0};

void dfft_c_api_install_typed(dfft_plan2_cb p, dfft_exec2_cb e) {
  g_plan2_cb.store(p, std::memory_order_release);
  g_exec2_cb.store(e, std::memory_order_release);
}

int dfft_c_api_typed_ready() {
  return (g_plan2_cb.load(std::memory_order_acquire) &&
          g_exec2_cb.load(std::memory_order_acquire))
             ? 1
             : 0;
}

static long long dfft_plan2(int kind, long long nx, long long ny,
                            long long nz, int direction, int axis) {
  dfft_plan2_cb cb = g_plan2_cb.load(std::memory_order_acquire);
  if (!cb) return -1;
  return cb(kind, nx, ny, nz, direction, axis);
}

static int dfft_exec2(long long plan, int op, const void* in, void* out) {
  dfft_exec2_cb cb = g_exec2_cb.load(std::memory_order_acquire);
  if (!cb) return 1;
  return cb(plan, op, in, out);
}

// r2c/c2r, float tier. direction -1 = r2c forward (real in, interleaved
// complex64 half-spectrum out: axis extent naxis/2+1), +1 = c2r inverse.
// r2c_axis in {0,1,2} is heFFTe's r2c_direction.
long long dfft_plan_r2c_3d(long long nx, long long ny, long long nz,
                           int direction, int r2c_axis) {
  return dfft_plan2(1, nx, ny, nz, direction, r2c_axis);
}
int dfft_execute_r2c(long long plan, const float* in, float* out) {
  return dfft_exec2(plan, 0, in, out);
}
int dfft_execute_c2r(long long plan, const float* in, float* out) {
  return dfft_exec2(plan, 0, in, out);
}

// Double tier (dd): buffers are plain C doubles — interleaved complex
// for z2z, real for the d2z input / z2d output. The bridge splits each
// value into the (hi, lo) float32 dd pair on upload and recombines on
// download; accuracy rides the 1e-11 double gate (test_common.h:138).
long long dfft_plan_z2z_3d(long long nx, long long ny, long long nz,
                           int direction) {
  return dfft_plan2(2, nx, ny, nz, direction, 2);
}
int dfft_execute_z2z(long long plan, const double* in, double* out) {
  return dfft_exec2(plan, 0, in, out);
}
long long dfft_plan_d2z_3d(long long nx, long long ny, long long nz,
                           int direction, int r2c_axis) {
  return dfft_plan2(3, nx, ny, nz, direction, r2c_axis);
}
int dfft_execute_d2z(long long plan, const double* in, double* out) {
  return dfft_exec2(plan, 0, in, out);
}
int dfft_execute_z2d(long long plan, const double* in, double* out) {
  return dfft_exec2(plan, 0, in, out);
}

// Plan-resident device buffers (any plan kind): upload once, execute any
// number of times device-side, download once.
int dfft_upload(long long plan, const void* in) {
  return dfft_exec2(plan, 1, in, 0);
}
int dfft_execute_resident(long long plan) {
  return dfft_exec2(plan, 2, 0, 0);
}
int dfft_download(long long plan, void* out) {
  return dfft_exec2(plan, 3, 0, out);
}

// --- C-driven selftests for the typed surface (the proof each typed
// entry carries a real transform end to end from compiled C).

// r2c float: ramp real world, r2c forward then c2r inverse, relative
// roundtrip max error (negative = failure).
double dfft_c_selftest_r2c(long long nx, long long ny, long long nz,
                           int r2c_axis) {
  if (!dfft_c_api_typed_ready()) return -1.0;
  long long n = nx * ny * nz;
  if (n <= 0 || r2c_axis < 0 || r2c_axis > 2) return -2.0;
  long long dims[3] = {nx, ny, nz};
  long long hdims[3] = {nx, ny, nz};
  hdims[r2c_axis] = dims[r2c_axis] / 2 + 1;
  long long nh = hdims[0] * hdims[1] * hdims[2];
  float* x = (float*)std::malloc(sizeof(float) * n);
  float* y = (float*)std::malloc(sizeof(float) * 2 * nh);
  float* z = (float*)std::malloc(sizeof(float) * n);
  if (!x || !y || !z) {
    std::free(x); std::free(y); std::free(z);
    return -3.0;
  }
  for (long long i = 0; i < n; ++i) x[i] = (float)(i % 101) * 1e-2f;
  double err = -4.0;
  long long fwd = dfft_plan_r2c_3d(nx, ny, nz, -1, r2c_axis);
  long long bwd = dfft_plan_r2c_3d(nx, ny, nz, +1, r2c_axis);
  if (fwd >= 0 && bwd >= 0 && dfft_execute_r2c(fwd, x, y) == 0 &&
      dfft_execute_c2r(bwd, y, z) == 0) {
    double mx = 0.0, me = 0.0;
    for (long long i = 0; i < n; ++i) {
      double ax = x[i] < 0 ? -x[i] : x[i];
      double d = (double)z[i] - (double)x[i];
      if (d < 0) d = -d;
      if (ax > mx) mx = ax;
      if (d > me) me = d;
    }
    err = mx > 0 ? me / mx : me;
  }
  if (fwd >= 0) dfft_destroy_plan_c(fwd);
  if (bwd >= 0) dfft_destroy_plan_c(bwd);
  std::free(x); std::free(y); std::free(z);
  return err;
}

// Double z2z roundtrip through the dd tier — the 1e-11 double-gate
// proof from compiled C.
double dfft_c_selftest_z2z(long long nx, long long ny, long long nz) {
  if (!dfft_c_api_typed_ready()) return -1.0;
  long long n = nx * ny * nz;
  if (n <= 0) return -2.0;
  double* x = (double*)std::malloc(sizeof(double) * 2 * n);
  double* y = (double*)std::malloc(sizeof(double) * 2 * n);
  double* z = (double*)std::malloc(sizeof(double) * 2 * n);
  if (!x || !y || !z) {
    std::free(x); std::free(y); std::free(z);
    return -3.0;
  }
  for (long long i = 0; i < n; ++i) {
    x[2 * i] = (double)(i % 97) * 1e-2 + 1e-9 * (double)(i % 7);
    x[2 * i + 1] = (double)(i % 89) * -1e-2;
  }
  double err = -4.0;
  long long fwd = dfft_plan_z2z_3d(nx, ny, nz, -1);
  long long bwd = dfft_plan_z2z_3d(nx, ny, nz, +1);
  if (fwd >= 0 && bwd >= 0 && dfft_execute_z2z(fwd, x, y) == 0 &&
      dfft_execute_z2z(bwd, y, z) == 0) {
    double mx = 0.0, me = 0.0;
    for (long long i = 0; i < 2 * n; ++i) {
      double ax = x[i] < 0 ? -x[i] : x[i];
      double d = z[i] - x[i];
      if (d < 0) d = -d;
      if (ax > mx) mx = ax;
      if (d > me) me = d;
    }
    err = mx > 0 ? me / mx : me;
  }
  if (fwd >= 0) dfft_destroy_plan_c(fwd);
  if (bwd >= 0) dfft_destroy_plan_c(bwd);
  std::free(x); std::free(y); std::free(z);
  return err;
}

// Resident-buffer lifecycle from C: upload once, execute `repeats`
// times device-side, download once; inverse likewise; returns the
// roundtrip error (proves repeat execution without per-call host trips).
double dfft_c_selftest_resident(long long nx, long long ny, long long nz,
                                int repeats) {
  if (!dfft_c_api_ready() || !dfft_c_api_typed_ready()) return -1.0;
  long long n = nx * ny * nz;
  if (n <= 0 || repeats < 1) return -2.0;
  float* x = (float*)std::malloc(sizeof(float) * 2 * n);
  float* y = (float*)std::malloc(sizeof(float) * 2 * n);
  float* z = (float*)std::malloc(sizeof(float) * 2 * n);
  if (!x || !y || !z) {
    std::free(x); std::free(y); std::free(z);
    return -3.0;
  }
  for (long long i = 0; i < n; ++i) {
    x[2 * i] = (float)(i % 61) * 1e-2f;
    x[2 * i + 1] = (float)(i % 53) * -1e-2f;
  }
  double err = -4.0;
  long long fwd = dfft_plan_c2c_3d(nx, ny, nz, -1);
  long long bwd = dfft_plan_c2c_3d(nx, ny, nz, +1);
  if (fwd >= 0 && bwd >= 0 && dfft_upload(fwd, x) == 0) {
    int ok = 0;
    for (int r = 0; r < repeats; ++r) ok |= dfft_execute_resident(fwd);
    if (ok == 0 && dfft_download(fwd, y) == 0 &&
        dfft_upload(bwd, y) == 0 && dfft_execute_resident(bwd) == 0 &&
        dfft_download(bwd, z) == 0) {
      double mx = 0.0, me = 0.0;
      for (long long i = 0; i < 2 * n; ++i) {
        double ax = x[i] < 0 ? -x[i] : x[i];
        double d = (double)z[i] - (double)x[i];
        if (d < 0) d = -d;
        if (ax > mx) mx = ax;
        if (d > me) me = d;
      }
      err = mx > 0 ? me / mx : me;
    }
  }
  if (fwd >= 0) dfft_destroy_plan_c(fwd);
  if (bwd >= 0) dfft_destroy_plan_c(bwd);
  std::free(x); std::free(y); std::free(z);
  return err;
}

int dfft_trace_dump(const char* path, long long process, long long nprocs) {
  std::lock_guard<std::mutex> lk(g_mu);
  std::FILE* f = std::fopen(path, "w");
  if (!f) return -1;
  std::fprintf(f, "process %lld of %lld\n", process, nprocs);
  double t0 = g_events.empty() ? 0.0 : g_events.front().start;
  for (const auto& e : g_events) {
    double dur = e.stop < 0 ? 0.0 : e.stop - e.start;
    std::fprintf(f, "%14.6f  %12.6f  %s\n", e.start - t0, dur,
                 e.name.c_str());
  }
  std::fclose(f);
  g_events.clear();
  g_on = false;
  return 0;
}

}  // extern "C"

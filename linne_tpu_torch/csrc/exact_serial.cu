// Strict serial-order float64 chains of the byte-exact device encoder.
//
// These kernels replace no Pallas kernel: the JAX package left the serial
// sums of its strict fit graph to XLA as `lax.scan` loops
// (linne_tpu/ops/exact_device.py). Run as plain torch, every step of such a
// scan is a kernel launch, some 10^5 launches per fit chunk, so each chain
// is a kernel here, one thread per independent chain, running the
// reference's loop in the reference's order:
//
//   autocorr_serial   replaces _autocorr_serial (:148):
//                     ac[s, lag] = sum_i seg[s, i] * seg[s, i + lag],
//                     i = 0, 1, ... from +0.0; one thread per (segment,
//                     lag), neighbouring lags in neighbouring lanes, so a
//                     warp reads seg[s, i] once (broadcast) and
//                     seg[s, i + lag] as one coalesced line per step.
//   levinson_serial   replaces _levinson_serial (:203) and its scan tail
//                     _levinson_scan_tail (:247): the Levinson-Durbin
//                     recursion op for op; one thread per segment, a[] in
//                     local memory.
//   serial_abs_mean   replaces _serial_abs_mean (:378):
//                     sum_{t=start}^{n-1} |x[t]| / n; one thread per row.
//   chain_predict     replaces _chain_predict (:349): per output sample a
//                     serial chain over the unit's taps, with and without
//                     the sample itself as the chain's start; one thread
//                     per (row, t), neighbouring t in neighbouring lanes.
//
// Exactness. Every product and sum is __dmul_rn / __dadd_rn and every
// quotient __ddiv_rn: nvcc contracts `a + x * y` into an FMA by default,
// and the intrinsics are never contracted, so the shared build flags stay
// as they are. Products the JAX graph takes behind its FMA shield
// (`_mulsh`: a NaN product becomes 0) do the same here (mulsh below).
// The autocorrelation's JAX scan also adds the products with its zero
// padding past the segment's end; adding +-0.0 to a sum that started at
// +0.0 never changes it (the sum is never -0.0), so the loop here stops at
// the end instead.
//
// Bound. At preset 7 (layers 4, 128, 16; four ridge terms; block 10240;
// 128 rows a chunk, so 512 row-terms) the work of one chunk is mostly
// autocorr_serial of the order-128 layer: per row-term
// sum over levels of units * sum_lag (ns - lag), about 2.7 M multiply-add
// pairs, 1.4 G in all, so 2.8 G FP64 operations (contraction off: a
// multiply and an add are two) at 64 FP64 operations/clk/SM x 132 SMs,
// ~0.17 ms at 1.98 GHz; chain_predict is about as large. The bytes are
// small beside that (the segments are read once: 42 MB, 0.013 ms at
// 3.35 TB/s). Beside the issue bound stands each chain's latency: 10,240
// dependent adds for the longest autocorrelation and abs-mean chains,
// about 8,128 dependent multiply-add steps for the order-128 recursion.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxOrder = 128;

// x * y behind the JAX graph's FMA shield: a NaN product counts as 0.
__device__ __forceinline__ double mulsh(double x, double y) {
  const double p = __dmul_rn(x, y);
  return p == p ? p : 0.0;
}

__global__ void __launch_bounds__(kThreads)
    autocorr_kernel(const double* __restrict__ seg, double* __restrict__ ac,
                    int64_t nseg, int ns, int nlags) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= nseg * nlags) return;
  const int64_t s = idx / nlags;
  const int lag = static_cast<int>(idx - s * nlags);
  const double* x = seg + s * ns;
  double acc = 0.0;
  for (int i = 0; i + lag < ns; ++i) {
    acc = __dadd_rn(acc, mulsh(__ldg(x + i), __ldg(x + i + lag)));
  }
  ac[idx] = acc;
}

// The recursion of linne_tpu/ops/exact_device.py:203-244 on one segment.
// a[0] stays exactly 1.0 (1.0 + mulsh(gamma, 0.0) == 1.0), so it is never
// rewritten, and the unrolled graph's literal 1.0 in v[k + 1] is used.
__global__ void __launch_bounds__(kThreads)
    levinson_kernel(const double* __restrict__ ac, double* __restrict__ coef,
                    double* __restrict__ parcor, uint8_t* __restrict__ zc,
                    int64_t nseg, int order) {
  const int64_t s = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (s >= nseg) return;
  const double* r = ac + s * (order + 1);
  double* c = coef + s * order;
  double* pc = parcor + s * order;
  const double r0 = r[0];
  const bool zero = fabs(r0) < static_cast<double>(1.1920928955078125e-07);

  double a[kMaxOrder + 2];
  a[0] = 1.0;
  double ek = r0;
  a[1] = __ddiv_rn(-r[1], r0);
  pc[0] = __ddiv_rn(r[1], ek);
  ek = __dadd_rn(ek, mulsh(r[1], a[1]));
  for (int k = 1; k < order; ++k) {
    double g = 0.0;
    for (int i = 0; i <= k; ++i) g = __dadd_rn(g, mulsh(a[i], r[k + 1 - i]));
    const double gamma = __ddiv_rn(g, -ek);
    ek = __dmul_rn(ek, __dsub_rn(1.0, mulsh(gamma, gamma)));
    // a[i] += gamma * a[k + 1 - i] for 1 <= i <= k, all from the old a[];
    // a[k + 1] = 0.0 + gamma * 1.0
    a[k + 1] = __dadd_rn(0.0, mulsh(gamma, 1.0));
    int i = 1;
    int j = k;
    for (; i < j; ++i, --j) {
      const double ai = a[i];
      const double aj = a[j];
      a[i] = __dadd_rn(ai, mulsh(gamma, aj));
      a[j] = __dadd_rn(aj, mulsh(gamma, ai));
    }
    if (i == j) a[i] = __dadd_rn(a[i], mulsh(gamma, a[i]));
    pc[k] = -gamma;
  }
  for (int k = 0; k < order; ++k) c[k] = zero ? 0.0 : a[k + 1];
  if (zero) {
    for (int k = 0; k < order; ++k) pc[k] = 0.0;
  }
  zc[s] = zero ? 1 : 0;
}

__global__ void __launch_bounds__(kThreads)
    abs_mean_kernel(const double* __restrict__ x, double* __restrict__ out,
                    int64_t nrows, int row_len, int start, int n) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (row >= nrows) return;
  const double* xr = x + row * row_len;
  double acc = 0.0;
  for (int t = start; t < n; ++t) acc = __dadd_rn(acc, fabs(__ldg(xr + t)));
  out[row] = __ddiv_rn(acc, static_cast<double>(n));
}

// params [rows, units * npu]: per unit, the taps in time-reversed order
// (layer.params); tap j of the unit holding t pairs with x[t + j - npu],
// zero before the row's start.
__global__ void __launch_bounds__(kThreads)
    chain_predict_kernel(const double* __restrict__ x,
                         const double* __restrict__ params,
                         double* __restrict__ base, double* __restrict__ nobase,
                         int64_t rows, int n, int units, int npu) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= rows * n) return;
  const int64_t row = idx / n;
  const int t = static_cast<int>(idx - row * n);
  const int ns = n / units;
  const double* xr = x + row * n;
  const double* p = params + row * static_cast<int64_t>(units) * npu +
                    static_cast<int64_t>(t / ns) * npu;
  double b = __ldg(xr + t);
  double nb = 0.0;
  for (int j = 0; j < npu; ++j) {
    const int src = t + j - npu;
    const double term = mulsh(__ldg(p + j), src >= 0 ? __ldg(xr + src) : 0.0);
    b = __dadd_rn(b, term);
    nb = __dadd_rn(nb, term);
  }
  base[idx] = b;
  nobase[idx] = nb;
}

unsigned blocks_for(int64_t threads) {
  return static_cast<unsigned>((threads + kThreads - 1) / kThreads);
}

}  // namespace

// All pointers are device pointers to contiguous float64 arrays (zc:
// uint8). Each function launches on `stream`, does not synchronise, and
// returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// shapes it does not take).

// seg [nseg, ns] -> ac [nseg, nlags], 1 <= nlags <= ns.
extern "C" int linne_autocorr_serial(const double* seg, double* ac,
                                     int64_t nseg, int ns, int nlags,
                                     void* stream) {
  if (nseg < 1 || ns < 1 || nlags < 1 || nlags > ns) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  autocorr_kernel<<<blocks_for(nseg * nlags), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(seg, ac, nseg, ns,
                                                         nlags);
  return static_cast<int>(cudaGetLastError());
}

// ac [nseg, order + 1] -> coef, parcor [nseg, order], zc [nseg];
// 1 <= order <= 128.
extern "C" int linne_levinson_serial(const double* ac, double* coef,
                                     double* parcor, uint8_t* zc,
                                     int64_t nseg, int order, void* stream) {
  if (nseg < 1 || order < 1 || order > kMaxOrder) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  levinson_kernel<<<blocks_for(nseg), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(ac, coef, parcor, zc,
                                                         nseg, order);
  return static_cast<int>(cudaGetLastError());
}

// x [nrows, row_len] -> out [nrows]; 0 <= start <= n <= row_len, n >= 1.
extern "C" int linne_serial_abs_mean(const double* x, double* out,
                                     int64_t nrows, int row_len, int start,
                                     int n, void* stream) {
  if (nrows < 1 || n < 1 || n > row_len || start < 0 || start > n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  abs_mean_kernel<<<blocks_for(nrows), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(x, out, nrows,
                                                         row_len, start, n);
  return static_cast<int>(cudaGetLastError());
}

// x [rows, n], params [rows, units * npu] -> base, nobase [rows, n];
// units divides n.
extern "C" int linne_chain_predict(const double* x, const double* params,
                                   double* base, double* nobase, int64_t rows,
                                   int n, int units, int npu, void* stream) {
  if (rows < 1 || n < 1 || units < 1 || npu < 1 || n % units) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  chain_predict_kernel<<<blocks_for(rows * n), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      x, params, base, nobase, rows, n, units, npu);
  return static_cast<int>(cudaGetLastError());
}

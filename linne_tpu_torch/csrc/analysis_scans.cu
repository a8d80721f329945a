// The serial recursions of the batched encoder's analysis and finish stages.
//
// These kernels replace no Pallas kernel: the JAX package left the three
// loops of its default encode to XLA as `lax.scan` loops inside jitted
// stages. Run as eager torch, every step of such a scan is a dozen kernel
// launches; here each scan is one kernel launch a call:
//
//   quantize_kernel     replaces quantize_coefficients'
//                       error-feedback scan (linne_tpu/ops/analysis.py:426,
//                       scan at :448): one thread a row runs the whole
//                       function, max |c| -> frexp -> rshift -> the tap loop
//                       from order - 1 down to 0.
//   levinson_*_kernel   replaces levinson_durbin's scan over the order
//                       (linne_tpu/ops/analysis.py:141, scan at :185): one
//                       thread a row up to order 32, one warp a row above.
//   predict_kernel      replaces _predict_dense's scan over the taps
//                       (linne_tpu/ops/intops.py:87, scan at :122): the
//                       masked full-order int32 FIR with per-unit
//                       passthrough; one CTA a (row, tile of samples).
//
// Exactness. The quantizer and the predict cascade are bit-equal to their
// plain torch versions (linne_tpu_torch/ops/analysis.py
// _quantize_coefficients_plain, ops/intops.py _predict_dense_plain): every
// float product and sum is __dmul_rn / __dadd_rn (nvcc contracts
// `a + x * y` into an FMA, the intrinsics are never contracted), the
// rounding is floor(q + 0.5) as there, scale is exp2 of the shift from the
// same CUDA math function torch calls, and the FIR sums in uint32, where
// the wrap of int32 arithmetic is associative. The recursion follows the
// plain version's arithmetic op for op (the silent-row substitution
// |ac0| < FLT_EPSILON -> 1, the guard gamma = |ek| > 0 ? num / -ek : 0,
// the generic k = 0 step, the sign convention) except for the order of
// the sum a . s, which is serial in a thread and a fixed shuffle tree in a
// warp: deterministic, and the same for a row wherever it sits in the
// batch (no atomics, nothing across rows). It is not bit-equal to the
// plain version, whose torch.sum takes another order.
//
// The plain recursion runs the full width order + 1 at every step: the
// entries a[i], i > k + 1, which the triangular form never touches, are
// 0 until a step's gamma is not finite, then NaN, all of them at once
// (each gets a[i] + gamma * 0), and each adds a[i] * 0 to the next sums.
// The kernels carry that as one scalar `tail`, so NaN and +-Inf inputs
// give NaN in the places the plain version gives it.
//
// Bound. The recursion and the quantizer are a serial chain a row, and the
// main path gives them few rows: at preset 7 (64-block batches, two
// channels, four ridges) the quantizer runs 128 rows of 4, 128 and 16
// taps, each tap five dependent float64 operations (add, add 0.5, floor,
// clamp, subtract); the order-128 recursion runs 512 rows, each step a sum
// of up to 129 products, a divide and the update. The bytes and the FP64
// issue rate bound them far below that chain; chip_smoke.py prints both
// bounds, the chain at the DADD and DDIV latencies that the clock64 probes
// (dadd_probe_kernel in exact_serial.cu, ddiv_probe_kernel here) measure.
// The predict cascade is the one that fills the card: 128 rows x 10240
// samples x up to 128 taps of int32 multiply-adds, ~10 us at 64
// IMAD/clk/SM x 132 SMs x 1.98 GHz against ~1.6 us of bytes; a thread
// takes one sample and reads its taps from shared memory, so two shared
// loads a multiply-add hold it above that bound.
//
// Measured (chip_smoke.py phase 4, NVIDIA H100 80GB HBM3 at 700 W): a
// 64-block preset-7 batch's calls take 0.154 ms (recursion, 17 calls; the
// order-128 call 0.054 ms against a 0.013 ms chain at 8.19 cycles a DADD
// and 111.6 a DDIV), 0.033 ms (quantizer, 3 calls) and 0.068 ms (predict,
// 3 calls; order 128 0.042 ms against a 0.0085 ms IMAD bound).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxOrder = 128;
constexpr double kFltEpsilon = 1.1920928955078125e-07;
constexpr unsigned kFullMask = 0xffffffffu;

// -- quantize_coefficients ---------------------------------------------------

constexpr int kQThreads = 64;

// coefs [rows, order] -> qc [rows, order], rshift [rows]. NaN rows are
// outside the function's domain (the plain version's int cast of NaN is
// not defined either).
__global__ void __launch_bounds__(kQThreads)
    quantize_kernel(const double* __restrict__ coefs, int32_t* __restrict__ qc,
                    int32_t* __restrict__ rshift, int64_t rows, int order,
                    int nbits) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kQThreads + threadIdx.x;
  if (r >= rows) return;
  const double* c = coefs + r * order;
  int32_t* q = qc + r * order;
  double max_abs = 0.0;
  for (int t = 0; t < order; ++t) {
    const double v = fabs(__ldg(c + t));
    max_abs = (v != v || v > max_abs) ? v : max_abs;  // amax keeps NaN
  }
  const bool is_zero = max_abs <= ldexp(1.0, -(nbits - 1));
  int e = 0;
  frexp(is_zero ? 1.0 : max_abs, &e);
  const int rs = min(max((nbits - 1) - e, 1), 15);
  const double scale = exp2(static_cast<double>(rs));
  const double qmax = static_cast<double>(1 << (nbits - 1));
  double qerr = 0.0;
#pragma unroll 4
  for (int t = order - 1; t >= 0; --t) {
    qerr = __dadd_rn(qerr, __dmul_rn(__ldg(c + t), scale));
    // round half away from zero
    double v = qerr >= 0.0 ? floor(__dadd_rn(qerr, 0.5))
                           : -floor(__dadd_rn(-qerr, 0.5));
    v = v < -qmax ? -qmax : (v > qmax - 1.0 ? qmax - 1.0 : v);
    qerr = __dsub_rn(qerr, v);
    q[t] = is_zero ? 0 : static_cast<int32_t>(v);
  }
  rshift[r] = is_zero ? nbits : rs;
}

// -- levinson_durbin ---------------------------------------------------------
//
// Step k (0 <= k < order) of the plain version, on a[0..order] with
// a = [1, 0, ...] and ek = ac0 at the start:
//   num   = sum_{i <= k+1} a[i] * ac[k+1-i]  (+ a[i] * 0 for i > k+1)
//   gamma = |ek| > 0 ? num / -ek : 0;  ek *= 1 - gamma * gamma
//   a[i] += gamma * a[k+1-i] for i <= k+1  (+= gamma * 0 for i > k+1)
//   parcor[k] = -gamma
// Entries i > k + 1 all hold `tail` (0, or NaN once a gamma was not
// finite); a[k + 2] takes it when it joins the sum.

constexpr int kLvThreadMax = 32;  // the largest order of the thread path
constexpr int kLvThreads = 128;
constexpr int kLvWarps = 4;  // rows (one a warp) a CTA of the warp path
constexpr int kLvSlots = (kMaxOrder + 1 + 31) / 32;  // a[] entries a lane
constexpr int kLvLen = kMaxOrder + 1;

// One thread a row, a[] and ac[] in registers: a template on the largest
// order it takes, so that every index is known to the compiler.
template <int P>
__global__ void __launch_bounds__(kLvThreads)
    levinson_thread_kernel(const double* __restrict__ ac,
                           double* __restrict__ lpc,
                           double* __restrict__ parcor, int64_t rows,
                           int order) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kLvThreads + threadIdx.x;
  if (r >= rows) return;
  const double* src = ac + r * (order + 1);
  double c[P + 1];
#pragma unroll
  for (int i = 0; i <= P; ++i) c[i] = i <= order ? __ldg(src + i) : 0.0;
  const bool silent = fabs(c[0]) < kFltEpsilon;
  if (silent) c[0] = 1.0;
  double a[P + 2];
  a[0] = 1.0;
#pragma unroll
  for (int i = 1; i < P + 2; ++i) a[i] = 0.0;
  double ek = c[0];
  double tail = 0.0;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    if (k < order) {
      double num = 0.0;
#pragma unroll
      for (int i = 0; i <= k + 1; ++i) {
        num = __dadd_rn(num, __dmul_rn(a[i], c[k + 1 - i]));
      }
      if (k + 2 <= order) num = __dadd_rn(num, __dmul_rn(tail, 0.0));
      const double gamma = fabs(ek) > 0.0 ? __ddiv_rn(num, -ek) : 0.0;
      ek = __dmul_rn(ek, __dsub_rn(1.0, __dmul_rn(gamma, gamma)));
      tail = __dadd_rn(tail, __dmul_rn(gamma, 0.0));
      double b[P + 2];
#pragma unroll
      for (int i = 0; i <= k + 1; ++i) {
        b[i] = __dadd_rn(a[i], __dmul_rn(gamma, a[k + 1 - i]));
      }
#pragma unroll
      for (int i = 0; i <= k + 1; ++i) a[i] = b[i];
      a[k + 2] = tail;
      if (parcor) parcor[r * order + k] = silent ? 0.0 : -gamma;
    }
  }
#pragma unroll
  for (int j = 0; j < P; ++j) {
    if (j < order) lpc[r * order + j] = silent ? 0.0 : a[j + 1];
  }
}

// One warp's shared memory: ac[] (lag 0 replaced on silent rows), a[]
// twice (the old and the new by step) and the parcor values.
struct LvWarp {
  double c[kLvLen];
  double a[2][kLvLen];
  double pc[kMaxOrder];
};

// One warp a row: lane l holds a[l + 32 m] in registers (own[m]); the sum
// is each lane's slots in order, then a butterfly of shuffles, which gives
// every lane the same value (each level adds the same two partial sums).
// The update reads a[k + 1 - i] from the shared copy of the step's start.
__global__ void __launch_bounds__(kLvWarps * 32)
    levinson_warp_kernel(const double* __restrict__ ac,
                         double* __restrict__ lpc,
                         double* __restrict__ parcor, int64_t rows,
                         int order) {
  __shared__ LvWarp smem[kLvWarps];
  const int lane = threadIdx.x & 31;
  const int64_t r =
      static_cast<int64_t>(blockIdx.x) * kLvWarps + (threadIdx.x >> 5);
  if (r >= rows) return;  // the whole warp: only __syncwarp below
  LvWarp& w = smem[threadIdx.x >> 5];
  const double* src = ac + r * (order + 1);
  for (int i = lane; i <= order; i += 32) w.c[i] = __ldg(src + i);
  __syncwarp();
  const bool silent = fabs(w.c[0]) < kFltEpsilon;
  __syncwarp();  // every lane has read c[0] before it changes
  if (silent && lane == 0) w.c[0] = 1.0;
  double own[kLvSlots];
#pragma unroll
  for (int m = 0; m < kLvSlots; ++m) {
    const int i = lane + 32 * m;
    own[m] = i == 0 ? 1.0 : 0.0;
    if (i <= order) w.a[0][i] = own[m];
  }
  __syncwarp();
  double ek = w.c[0];
  double tail = 0.0;
  for (int k = 0; k < order; ++k) {
    const double* old = w.a[k & 1];
    double* fresh = w.a[(k & 1) ^ 1];
    double part = 0.0;
#pragma unroll
    for (int m = 0; m < kLvSlots; ++m) {
      const int i = lane + 32 * m;
      if (i <= k + 1) part = __dadd_rn(part, __dmul_rn(own[m], w.c[k + 1 - i]));
    }
#pragma unroll
    for (int d = 16; d >= 1; d >>= 1) {
      part = __dadd_rn(part, __shfl_xor_sync(kFullMask, part, d));
    }
    double num = part;
    if (k + 2 <= order) num = __dadd_rn(num, __dmul_rn(tail, 0.0));
    const double gamma = fabs(ek) > 0.0 ? __ddiv_rn(num, -ek) : 0.0;
    ek = __dmul_rn(ek, __dsub_rn(1.0, __dmul_rn(gamma, gamma)));
    tail = __dadd_rn(tail, __dmul_rn(gamma, 0.0));
#pragma unroll
    for (int m = 0; m < kLvSlots; ++m) {
      const int i = lane + 32 * m;
      if (i <= k + 1) {
        own[m] = __dadd_rn(own[m], __dmul_rn(gamma, old[k + 1 - i]));
      } else if (i == k + 2) {
        own[m] = tail;
      }
      if (i <= k + 2 && i <= order) fresh[i] = own[m];
    }
    if (lane == 0) w.pc[k] = -gamma;
    __syncwarp();
  }
#pragma unroll
  for (int m = 0; m < kLvSlots; ++m) {
    const int i = lane + 32 * m;
    if (i >= 1 && i <= order) lpc[r * order + i - 1] = silent ? 0.0 : own[m];
  }
  if (parcor) {
    for (int i = lane; i < order; i += 32) {
      parcor[r * order + i] = silent ? 0.0 : w.pc[i];
    }
  }
}

// -- _predict_dense ------------------------------------------------------------
//
// Per row: u = 1 << log2u, npu = order >> log2u, ns = n >> log2u. Sample g
// of real unit g / ns, at offset g % ns, is
//   x[g]                                                   offset < npu
//   x[g] + ((half + sum_{k=1}^{npu} c[unit*npu + npu - k] * x[g-k]) >> rs)
// with x[g - k] = 0 before the row. These are the nonzero entries of the
// plain version's dense [u_max, order] matrix (column order - k, valid iff
// k <= npu); its masked terms add 0 and its fine segment s = g / (n/u_max)
// gives unit s * u / u_max = g / ns for u | u_max | n. Shifts follow
// torch's: `1 << b` is 0 and `a >> b` fills with the sign for b outside
// [0, 31].

constexpr int kPdTile = 256;  // samples a CTA, one a thread

__global__ void __launch_bounds__(kPdTile)
    predict_kernel(const int32_t* __restrict__ x,
                   const int32_t* __restrict__ coefs,
                   const int32_t* __restrict__ log2u,
                   const int32_t* __restrict__ rshift,
                   int32_t* __restrict__ out, int64_t tiles, int n,
                   int order) {
  __shared__ int32_t xs[kMaxOrder + kPdTile];
  __shared__ int32_t cs[kMaxOrder];
  const int64_t row = blockIdx.x / tiles;
  const int g0 = static_cast<int>(blockIdx.x - row * tiles) * kPdTile;
  const int32_t* xr = x + row * n;
  for (int i = threadIdx.x; i < order + kPdTile; i += kPdTile) {
    const int g = g0 - order + i;
    xs[i] = (g >= 0 && g < n) ? __ldg(xr + g) : 0;
  }
  for (int i = threadIdx.x; i < order; i += kPdTile) {
    cs[i] = __ldg(coefs + row * order + i);
  }
  __syncthreads();
  const int g = g0 + threadIdx.x;
  if (g >= n) return;
  const int l2 = __ldg(log2u + row);
  const int npu = order >> l2;
  const int ns = max(n >> l2, 1);  // log2u <= log2(u_max) by contract
  const int unit = g / ns;
  const int32_t xv = xs[order + threadIdx.x];
  if (g - unit * ns < npu) {
    out[row * n + g] = xv;
    return;
  }
  const int rs = __ldg(rshift + row);
  const uint32_t half = (rs >= 1 && rs <= 32) ? (1u << (rs - 1)) : 0u;
  const int shift = (rs < 0 || rs > 31) ? 31 : rs;
  const int32_t* cu = cs + unit * npu + npu;  // cu[-k]: tap age k
  const int32_t* xk = xs + order + threadIdx.x;  // xk[-k] = x[g - k]
  uint32_t acc = half;
  for (int k = 1; k <= npu; ++k) {
    acc += static_cast<uint32_t>(cu[-k]) * static_cast<uint32_t>(xk[-k]);
  }
  const int32_t pred = static_cast<int32_t>(acc) >> shift;
  out[row * n + g] = static_cast<int32_t>(static_cast<uint32_t>(xv) +
                                          static_cast<uint32_t>(pred));
}

// A dependent chain of n __ddiv_rn in one warp (a <- x / a stays near
// sqrt(x)), timed with clock64: the card's divide latency is
// (cycles(n2) - cycles(n1)) / (n2 - n1). The recursion's chain bound
// counts one a step.
__global__ void ddiv_probe_kernel(double x, int n, long long* cycles,
                                  double* out) {
  double a = x;
  const long long t0 = clock64();
#pragma unroll 16
  for (int i = 0; i < n; ++i) a = __ddiv_rn(x, a);
  const long long t1 = clock64();
  out[threadIdx.x] = a;
  if (threadIdx.x == 0) *cycles = t1 - t0;
}

template <int P>
void levinson_thread(const double* ac, double* lpc, double* parcor,
                     int64_t rows, int order, cudaStream_t st) {
  const auto grid =
      static_cast<unsigned>((rows + kLvThreads - 1) / kLvThreads);
  levinson_thread_kernel<P><<<grid, kLvThreads, 0, st>>>(ac, lpc, parcor,
                                                          rows, order);
}

}  // namespace

// All pointers are device pointers to contiguous tensors; each function
// launches on `stream`, does not synchronise, and returns
// cudaGetLastError() after the launch.

// coefs [rows, order] float64 -> qc [rows, order], rshift [rows] int32;
// 1 <= order <= 128, 1 <= nbits <= 31.
extern "C" int linne_quantize_coefficients(const double* coefs, int32_t* qc,
                                           int32_t* rshift, int64_t rows,
                                           int order, int nbits,
                                           void* stream) {
  if (rows < 1 || order < 1 || order > kMaxOrder || nbits < 1 || nbits > 31) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto grid = static_cast<unsigned>((rows + kQThreads - 1) / kQThreads);
  quantize_kernel<<<grid, kQThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      coefs, qc, rshift, rows, order, nbits);
  return static_cast<int>(cudaGetLastError());
}

// ac [rows, order + 1] float64 -> lpc [rows, order] and, unless parcor is
// null, parcor [rows, order]; 1 <= order <= 128.
extern "C" int linne_levinson_durbin(const double* ac, double* lpc,
                                     double* parcor, int64_t rows, int order,
                                     void* stream) {
  if (rows < 1 || order < 1 || order > kMaxOrder) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  if (order > kLvThreadMax) {
    const auto grid = static_cast<unsigned>((rows + kLvWarps - 1) / kLvWarps);
    levinson_warp_kernel<<<grid, kLvWarps * 32, 0, st>>>(ac, lpc, parcor,
                                                         rows, order);
  } else if (order > 16) {
    levinson_thread<32>(ac, lpc, parcor, rows, order, st);
  } else if (order > 8) {
    levinson_thread<16>(ac, lpc, parcor, rows, order, st);
  } else if (order > 4) {
    levinson_thread<8>(ac, lpc, parcor, rows, order, st);
  } else if (order > 2) {
    levinson_thread<4>(ac, lpc, parcor, rows, order, st);
  } else if (order > 1) {
    levinson_thread<2>(ac, lpc, parcor, rows, order, st);
  } else {
    levinson_thread<1>(ac, lpc, parcor, rows, order, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// cycles[0] <- the clock64 cycles of a chain of n dependent __ddiv_rn in
// one warp (out [32] float64 keeps the chain live), launched on stream.
extern "C" int linne_ddiv_probe(double x, int n, long long* cycles,
                                double* out, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  ddiv_probe_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      x, n, cycles, out);
  return static_cast<int>(cudaGetLastError());
}

// x [rows, n], coefs [rows, order], log2u [rows], rshift [rows] int32 ->
// out [rows, n] int32; 1 <= order <= 128, n >= 1.
extern "C" int linne_predict_dense(const int32_t* x, const int32_t* coefs,
                                   const int32_t* log2u,
                                   const int32_t* rshift, int32_t* out,
                                   int64_t rows, int n, int order,
                                   void* stream) {
  if (rows < 1 || n < 1 || order < 1 || order > kMaxOrder) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t tiles = (n + kPdTile - 1) / kPdTile;
  const int64_t ctas = rows * tiles;
  if (ctas > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  predict_kernel<<<static_cast<unsigned>(ctas), kPdTile, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      x, coefs, log2u, rshift, out, tiles, n, order);
  return static_cast<int>(cudaGetLastError());
}

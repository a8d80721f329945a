// The serial recursions of the batched encoder's analysis and finish
// stages, its layer fits' autocorrelation and residual pass, and the
// byte-exact fit's quantizer.
//
// These kernels replace no Pallas kernel: the JAX package left these loops
// to XLA as `lax.scan` loops (or, on the byte-exact fit, unrolled Python
// loops) inside jitted stages. Run as eager torch, every step of such a
// loop is a dozen kernel launches; here each is one kernel launch a call:
//
//   quantize_kernel<E>  replaces the error-feedback quantizer: E = false
//                       quantize_coefficients' scan (linne_tpu/ops/
//                       analysis.py:426, scan at :448), every layer of a
//                       batch in one launch; E = true the byte-exact fit's
//                       _quantize_layer (linne_tpu/ops/exact_device.py:429)
//                       with the guard's margins, every layer of a fit
//                       chunk in one launch (below).
//   levinson_kernel<G>  replaces levinson_durbin's scan over the order
//                       (linne_tpu/ops/analysis.py:141, scan at :185): G
//                       lanes a row (1 up to order 4, 32 from order 80),
//                       each step's numerator in Schur form (below).
//   predict_kernel      replaces _predict_dense's scan over the taps
//                       (linne_tpu/ops/intops.py:87, scan at :122): the
//                       masked full-order int32 FIR with per-unit
//                       passthrough, register-tiled (below).
//   unit_residual_kernel replaces fit_layer's loop over the unit counts
//                       (linne_tpu/ops/analysis.py:348): every candidate
//                       split's residual and loss and the first-minimum
//                       pick of a layer, one launch a layer (below).
//   lpc_autocorr_kernel replaces the layer fits' Welch-windowed
//                       autocorrelation (linne_tpu/ops/analysis.py
//                       fit_unit_lpc, autocorrelation): every candidate
//                       split's windowing and lags, one launch a layer and
//                       one for the block-type estimate (below).
//
// Exactness. The quantizer and the predict cascade are bit-equal to their
// plain torch versions (linne_tpu_torch/ops/analysis.py
// _quantize_coefficients_plain, ops/exact_device.py _quantize_layer_plain,
// ops/intops.py _predict_dense_plain): every float product and sum is
// __dmul_rn / __dadd_rn (nvcc contracts `a + x * y` into an FMA, the
// intrinsics are never contracted), the rounding is floor(q + 0.5) as
// there, scale is the exact power of two of the shift (as torch.exp2 and
// the table give it), and the FIR sums in uint32, where the wrap of int32
// arithmetic is associative, so any order of the taps gives the same
// bits. The recursion keeps the plain version's silent-row
// substitution (|ac0| < FLT_EPSILON -> 1), its guard (gamma = |ek| > 0 ?
// num / -ek : 0, one correctly rounded divide), its ek update and its sign
// convention, but takes the numerator by the Schur recursion instead of a
// sum: deterministic, the same for a row wherever it sits in the batch (no
// atomics, nothing across rows), and within rounding of the plain version,
// not bit-equal to it. tests/torch_levinson_model.py models it step for
// step, and the card tests hold the kernel to that model bit for bit.
//
// Bound. The recursion's longest chain a row is, at every step, the divide
// and ek's update (multiply, subtract, multiply) that the next divide
// waits for: order x (DDIV + 3 DADD) at the latencies the clock64 probes
// measure (ddiv_probe_kernel here, dadd_probe_kernel in exact_serial.cu),
// 136 cycles a step, 0.0088 ms at order 128 at 1.98 GHz; bytes and the
// FP64 issue rate bound it far below that. The quantizer is a chain of
// five dependent float64 operations a tap, so a launch's chain bound is
// its longest layer's: 128 x 5 DADD latencies, 0.0027 ms at 8.19 cycles
// and 1.98 GHz; its bytes are ~0.2 MB. The predict cascade fills the
// card: 128 rows x 10240 samples x up to 128 taps of int32 multiply-adds
// at 64 IMAD/clk/SM x 132 SMs x 1.98 GHz, against the bytes of the
// order-4 and order-16 calls.
// chip_smoke.py prints each call's bound and chain bound.
//
// Measured (chip_pairs.py --kernel: one 64-block preset-7 batch's calls
// back to back, device time; NVIDIA H100 80GB HBM3 at 700 W): the
// recursion's 17 calls 0.0837 ms against 0.1512 ms for the one-thread /
// one-warp design before it in the same call, the order-128 call alone
// 0.0228 ms against 0.0558 ms (~310 cycles a step by clock64, against the
// chain bound's 136: a step issues ~110 instructions, 40 of them FP64);
// the cascade's 3 calls 0.0360 ms against 0.0683 ms for one sample a
// thread, the order-128 call alone 0.0199 ms against 0.0447 ms; the
// quantizer's one launch a batch 0.0081 ms against 0.0317 ms for the three
// per-layer calls of one thread a row (five batches back to back; the
// chain 61 cycles a tap by clock64), the byte-exact variant 0.0097 ms for
// a 128-row fit chunk's layers.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxOrder = 128;
constexpr double kFltEpsilon = 1.1920928955078125e-07;
constexpr unsigned kFullMask = 0xffffffffu;

// -- clock64 split (measurement builds only) ----------------------------------
//
// Built with -DLINNE_CLOCK_SPLIT (chip_pairs.py --split), one thread of each
// kernel books the clock64 cycles between its marks to slots in registers
// and adds them to g_split at its end; linne_clock_split copies g_split out
// and clears it. A mark reads the clock only once `dep`, a value the phase
// produced, is ready (the read is predicated on a compare of it), so a
// phase's latency is not booked to the next. The default build has no
// marks and no g_split.
constexpr int kSplitSlots = 8;
#ifdef LINNE_CLOCK_SPLIT
__device__ long long g_split[kSplitSlots];

__device__ __forceinline__ long long clock_after(long long dep) {
  long long t;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.eq.s64 p, %1, 0x7ff8dead0badf00d;\n\t"
      "@!p mov.u64 %0, %%clock64;\n\t"
      "@p mov.u64 %0, 0;\n\t}"
      : "=l"(t)
      : "l"(dep)
      : "memory");
  return t;
}
__device__ __forceinline__ long long split_bits(double v) {
  return __double_as_longlong(v);
}
__device__ __forceinline__ long long split_bits(int v) { return v; }
__device__ __forceinline__ long long split_bits(uint32_t v) { return v; }

#define SPLIT_START(on)                          \
  const bool split_on_ = (on);                   \
  long long split_acc_[kSplitSlots] = {};        \
  long long split_t_ = clock_after(0)
#define SPLIT_MARK(slot, dep)                                      \
  do {                                                             \
    if (split_on_) {                                               \
      const long long split_now_ = clock_after(split_bits(dep));   \
      split_acc_[slot] += split_now_ - split_t_;                   \
      split_t_ = split_now_;                                       \
    }                                                              \
  } while (0)
#define SPLIT_END()                                                \
  do {                                                             \
    if (split_on_) {                                               \
      for (int s_ = 0; s_ < kSplitSlots; ++s_) {                   \
        g_split[s_] += split_acc_[s_];                             \
      }                                                            \
    }                                                              \
  } while (0)
#else
#define SPLIT_START(on) \
  do {                  \
  } while (0)
#define SPLIT_MARK(slot, dep) \
  do {                        \
  } while (0)
#define SPLIT_END() \
  do {              \
  } while (0)
#endif

// -- the error-feedback quantizer ---------------------------------------------
//
// One launch quantizes up to kQMaxLayers layers of the same rows (a batch's
// layers on the main path, a fit chunk's on the byte-exact path). A layer
// is a descriptor: its rows' taps at src + row * stride + t, its order, and
// the first column of its int coefficients in qc. A CTA takes a tile of
// T = kQMaxItems / count rows and every layer of them, so that its (layer,
// row) chains fill one warp; the host sorts the descriptors longest order
// first, so lane 0 runs the longest chain. Phases:
//   1. stage and reduce: the tile's taps into shared memory with cp.async,
//      a warp a row, the lanes on consecutive taps (coalesced, no
//      registers held), a row's layers side by side at an odd stride of
//      doubles, so that the chain's lanes (a row each) read in distinct
//      banks; then eight lanes an item, all the CTA's items at once: max
//      |c| as a tree in registers and three shuffles (max is exact in any
//      order), frexp -> rshift -> scale, and the products p[t] = c[t] *
//      scale written over the taps;
//   2. chain: lane i of warp 0 runs item i from tap order - 1 down to 0,
//      the products eight taps ahead in registers. The plain version's tap
//      is s = qerr + p[t]; v = s >= 0 ? floor(s + 0.5) : -floor(0.5 - s),
//      clamped to [-qmax, qmax - 1]; qerr = s - v. On the chain here: s,
//      y = |s| + 0.5 (the same bits as s + 0.5 or 0.5 - s), f = floor(y)
//      by a round-down add of 2^52 (exact, and shorter than FRND),
//      qerr = s - f or s + f, or s - v_clamp where the clamp binds (y >=
//      qmax for s >= 0, y >= qmax + 1 for s < 0, beside the floor): five
//      dependent adds and a select a tap, every value (zeros' signs too)
//      the plain version's. s goes over p[t] in shared memory; nothing
//      else is done a tap;
//   3. store: eight lanes an item again: v from s as the plain version
//      rounds, clamps and casts it, out coalesced (0 on low rows); on the
//      exact variant the round margin a tap, its minimum over the item,
//      and both margins folded over the row's layers.
//
// kExact = false is ops/analysis.py:_quantize_coefficients_plain (the
// batched encoder's quantizer): max |c| by amax (a NaN wins), rshift from
// frexp clamped to [1, 15], no NaN shield. kExact = true is
// ops/exact_device.py:_quantize_layer_plain (lpc.c:981-1040 as the
// byte-exact fit runs it): max |c| skips NaN (the reference's `<` update
// from 0.0); rshift = (nbits - 1) - exponent, unclamped, in int32 that
// wraps as torch's does; scale the exact power of two (the plain version's
// table, its index clamped to [-1074, 1023]); a NaN product counts as 0;
// and the guard's two sensors: round_margin, the least |y - rint(y)| over
// the taps (inf on the low path), taken from the stored sums, and
// scale_margin, from max |c| and its frexp bin edges; each is folded over
// the row's layers in the launch. A NaN in either propagates, as
// torch.minimum and amin propagate it. Plain and kernel are bit-equal on
// the same card; a NaN coefficient's int cast is the card's (the CPU's
// cast of NaN differs, as it does for the plain version itself).

constexpr int kQThreads = 256;
constexpr int kQWarps = kQThreads / 32;
constexpr int kQMaxLayers = 4;
constexpr int kQMaxItems = 32;                       // (layer, row) a CTA
constexpr int kQTaps = kMaxOrder / 32;               // taps a lane, staging
constexpr int kQLaneTaps = kMaxOrder / 8;            // taps a lane, reducing
static_assert(kQWarps * 4 == kQMaxItems, "eight lanes an item");
// a tile's taps: T rows x (sum of orders | 1) doubles with T = 32 / count:
// at most 32 x 129, 16 x 257, 10 x 385 or 8 x 513
constexpr int kQSmem = kQMaxItems * (kMaxOrder + 1);

struct QLayer {
  const double* src;
  int64_t stride;  // between rows, in doubles
  int order;
  int col;         // first column of the layer's int coefficients in qc
  int index;       // the layer's place in the caller's list
  int scol;        // first column of the layer in a shared-memory row
};

struct QGroup {
  QLayer layer[kQMaxLayers];  // longest order first
  int count;
  int tile_rows;              // T
  int stride;                 // the shared-memory row stride (odd)
};

// Exact 2^e for e clamped to [-1074, 1023], from its bits (the plain
// versions' table; torch.exp2 at the integers 1..15).
__device__ __forceinline__ double pow2_exact(long long e) {
  e = e < -1074 ? -1074 : (e > 1023 ? 1023 : e);
  return e >= -1022 ? __longlong_as_double((e + 1023) << 52)
                    : __longlong_as_double(1LL << (e + 1074));
}

// torch.minimum: a NaN operand wins, the first one first.
__device__ __forceinline__ double nan_min(double a, double b) {
  return a != a ? a : (b != b ? b : fmin(a, b));
}

// The layer of item k = l * T + r, without a division (l < kQMaxLayers).
__device__ __forceinline__ int q_layer(int k, int T) {
  return (k >= T) + (k >= 2 * T) + (k >= 3 * T);
}

// dst: a shared-memory address (cvta.to.shared of a pointer into sm)
__device__ __forceinline__ void cp_async8(unsigned dst, const double* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// The error fed back from the sum s of a tap (see 2. above): s - v, with v
// s rounded half away from zero and clamped to [-qmax, qmax - 1].
__device__ __forceinline__ double quantize_feedback(double s, double qmax) {
  constexpr double kTwo52 = 4503599627370496.0;
  const bool pos = s >= 0.0;
  const double y = __dadd_rn(fabs(s), 0.5);
  // floor(y) for 0.5 <= y < 2^52, exactly: y + 2^52 rounded down lands on
  // the integer 2^52 + floor(y) (the spacing there is 1), and taking 2^52
  // off is exact. At y >= 2^52 (and at inf) the clamp binds, and f is not
  // used
  const double f = __dsub_rn(__dadd_rd(y, kTwo52), kTwo52);
  const bool binds = y >= (pos ? qmax : qmax + 1.0);
  const double held = pos ? __dsub_rn(s, qmax - 1.0) : __dadd_rn(s, qmax);
  const double fed = pos ? __dsub_rn(s, f) : __dadd_rn(s, f);
  return binds ? held : fed;
}

// The int32 coefficient of a tap's sum s, as the plain version rounds,
// clamps and casts it (the clamp in int32 on the saturated cast of f; its
// cast of a NaN is the card's), and the tap's round margin |y - rint(y)|,
// y = |s| + 0.5 (the same bits as s + 0.5 or 0.5 - s).
__device__ __forceinline__ int32_t quantize_value(double s, int qmax,
                                                  double& margin) {
  const double y = __dadd_rn(fabs(s), 0.5);
  const int32_t f = __double2int_rz(floor(y));  // saturates at inf
  margin = fabs(__dsub_rn(y, rint(y)));
  const int32_t v = s >= 0.0 ? min(f, qmax - 1) : -min(f, qmax);
  return s == s ? v : static_cast<int32_t>(s);
}

// split slots: 0 issuing the staging copies, 1 waiting for them and the
// barrier, 2 max |c|, rshift and the products, 3 the barrier before the
// chain, 4 the chain, 5 the stores
template <bool kExact>
__global__ void __launch_bounds__(kQThreads)
    quantize_kernel(const QGroup g, int32_t* __restrict__ qc,
                    int64_t qc_stride, int32_t* __restrict__ rshift,
                    int64_t rs_layer, int64_t rs_row,
                    double* __restrict__ round_margin,
                    double* __restrict__ scale_margin, int64_t rows,
                    int nbits) {
  __shared__ double sm[kQSmem];
  __shared__ int s_order[kQMaxLayers], s_scol[kQMaxLayers],
      s_col[kQMaxLayers];
  __shared__ int s_index[kQMaxLayers], s_rank[kQMaxLayers];
  __shared__ bool s_low[kQMaxItems];
  __shared__ double s_scale_m[kQMaxItems], s_round_m[kQMaxItems];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int T = g.tile_rows, S = g.stride;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * T;
  const int nr = rows - r0 < T ? static_cast<int>(rows - r0) : T;
  const int items = g.count * T;
  const double qmax = static_cast<double>(1u << (nbits - 1));
  const double lowthr = pow2_exact(-(nbits - 1));
  const double inf = __longlong_as_double(0x7ff0000000000000LL);
  SPLIT_START(blockIdx.x == 0 && tid == 0);

  // 1. stage: a warp a row, the lanes over its taps; the descriptor read
  // once into registers, the shared address taken once
  const unsigned sbase = static_cast<unsigned>(__cvta_generic_to_shared(sm));
#pragma unroll
  for (int l = 0; l < kQMaxLayers; ++l) {
    if (l < g.count) {
      const double* const src0 = g.layer[l].src;
      const int64_t stride = g.layer[l].stride;
      const int order = g.layer[l].order;
      const int scol = g.layer[l].scol;
      if (tid == 0) {
        s_order[l] = order;
        s_scol[l] = scol;
        s_col[l] = g.layer[l].col;
        s_index[l] = g.layer[l].index;
        s_rank[g.layer[l].index] = l;
      }
      const double* src = src0 + (r0 + warp) * stride;
      unsigned dst = sbase + 8u * (warp * S + scol + lane);
      for (int r = warp; r < nr; r += kQWarps) {
#pragma unroll
        for (int q = 0; q < kQTaps; ++q) {
          const int t = lane + 32 * q;
          if (t < order) cp_async8(dst + 256u * q, src + t);
        }
        src += kQWarps * stride;
        dst += 8u * kQWarps * S;
      }
    }
  }
  SPLIT_MARK(0, 0);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  SPLIT_MARK(1, sm[0]);

  // 1'. max |c|, rshift, products: eight lanes an item, item k = 4 * warp
  // + lane / 8; a lane takes taps sub, sub + 8, ... of it
  [[maybe_unused]] double split_dep = 0.0;
  {
    const int k = 4 * warp + (lane >> 3), sub = lane & 7;
    const int l = q_layer(k, T), r = k - l * T;
    const bool on = k < items && r < nr;
    const int order = on ? s_order[l] : 0;
    double* row = sm + r * S + (on ? s_scol[l] : 0);
    double c[kQLaneTaps];
    double a[kQLaneTaps];
#pragma unroll
    for (int q = 0; q < kQLaneTaps; ++q) {
      const int t = sub + 8 * q;
      c[q] = t < order ? row[t] : 0.0;
      a[q] = fabs(c[q]);
      if constexpr (kExact) a[q] = a[q] == a[q] ? a[q] : 0.0;  // NaN: 0
    }
    // max |c|: a tree in registers, then across the eight lanes (exact in
    // any order; on the batched variant a NaN wins, as amax's does)
    const auto wider = [](double x, double o) {
      return (o > x || (!kExact && o != o)) ? o : x;
    };
    static_assert(kQLaneTaps == 16, "a tree of four levels");
#pragma unroll
    for (int q = 0; q < 8; ++q) a[q] = wider(a[q], a[q + 8]);
#pragma unroll
    for (int q = 0; q < 4; ++q) a[q] = wider(a[q], a[q + 4]);
#pragma unroll
    for (int q = 0; q < 2; ++q) a[q] = wider(a[q], a[q + 2]);
    double max_abs = wider(a[0], a[1]);
#pragma unroll
    for (int off = 4; off > 0; off >>= 1) {
      max_abs = wider(max_abs, __shfl_xor_sync(kFullMask, max_abs, off));
    }
    const bool low = max_abs <= lowthr;
    int e = 0;
    int rs;
    if constexpr (kExact) {
      frexp(max_abs, &e);
      rs = static_cast<int>(static_cast<unsigned>(nbits - 1) -
                            static_cast<unsigned>(e));
    } else {
      frexp(low ? 1.0 : max_abs, &e);
      rs = min(max((nbits - 1) - e, 1), 15);
    }
    const double scale = pow2_exact(rs);
#pragma unroll
    for (int q = 0; q < kQLaneTaps; ++q) {
      const int t = sub + 8 * q;
      if (t < order) {
        double p = __dmul_rn(c[q], scale);
        if constexpr (kExact) p = p == p ? p : 0.0;
        row[t] = p;
        split_dep = p;
      }
    }
    if (on && sub == 0) {
      s_low[k] = low;
      rshift[s_index[l] * rs_layer + (r0 + r) * rs_row] = low ? nbits : rs;
      if constexpr (kExact) {
        const int em1 = static_cast<int>(static_cast<unsigned>(e) - 1u);
        double fm = nan_min(__dsub_rn(max_abs, pow2_exact(em1)),
                            __dsub_rn(pow2_exact(e), max_abs));
        fm = __ddiv_rn(fm, fmax(max_abs, 1e-300));
        const double lm =
            __ddiv_rn(fabs(__dsub_rn(max_abs, lowthr)), lowthr);
        s_scale_m[k] = nan_min(low ? inf : fm, lm);
      }
    }
  }
  SPLIT_MARK(2, split_dep);
  __syncthreads();
  SPLIT_MARK(3, sm[0]);

  // 2. the chains, one a lane of warp 0: only s and the error fed back
  // are on it; s goes over p[t] in shared memory
  if (warp == 0) {
    const int l = q_layer(lane, T), r = lane - l * T;
    if (lane < items && r < nr) {
      const int order = s_order[l];
      double* row = sm + r * S + s_scol[l];
      double qerr = 0.0;
      int t = order - 1;
      const int groups = order >> 3;
      double cur[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) cur[i] = groups ? row[t - i] : 0.0;
      for (int gi = 0; gi < groups; ++gi) {
        double next[8];
        const bool more = gi + 1 < groups;
#pragma unroll
        for (int i = 0; i < 8; ++i) next[i] = more ? row[t - 8 - i] : 0.0;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const double s = __dadd_rn(qerr, cur[i]);
          row[t - i] = s;
          qerr = quantize_feedback(s, qmax);
        }
        t -= 8;
#pragma unroll
        for (int i = 0; i < 8; ++i) cur[i] = next[i];
      }
      for (; t >= 0; --t) {
        const double s = __dadd_rn(qerr, row[t]);
        row[t] = s;
        qerr = quantize_feedback(s, qmax);
      }
      SPLIT_MARK(4, qerr);
    }
  }
  __syncthreads();

  // 3. the int coefficients from the sums, out coalesced (0 on low rows),
  // and on the exact variant each item's round margin: eight lanes an item
  // as in 1.
  [[maybe_unused]] int32_t split_out = 0;
  {
    const int k = 4 * warp + (lane >> 3), sub = lane & 7;
    const int l = q_layer(k, T), r = k - l * T;
    const bool on = k < items && r < nr;
    const int order = on ? s_order[l] : 0;
    const double* row = sm + r * S + (on ? s_scol[l] : 0);
    int32_t* dst = qc + (r0 + r) * qc_stride + (on ? s_col[l] : 0);
    const bool low = on && s_low[k];
    const int qi = 1 << (nbits - 1);
    // every tap into registers first, no branch, then the stores
    int32_t v[kQLaneTaps];
    double rmin = inf;
#pragma unroll
    for (int q = 0; q < kQLaneTaps; ++q) {
      const int t = sub + 8 * q;
      const bool in = t < order;
      double d;
      v[q] = quantize_value(row[in ? t : 0], qi, d);
      d = in ? d : inf;
      rmin = (d != d || d < rmin) ? d : rmin;  // amin: a NaN stays
    }
#pragma unroll
    for (int q = 0; q < kQLaneTaps; ++q) {
      if (sub + 8 * q < order) dst[sub + 8 * q] = low ? 0 : v[q];
    }
    split_out = v[0];
    if constexpr (kExact) {
#pragma unroll
      for (int off = 4; off > 0; off >>= 1) {
        rmin = nan_min(rmin, __shfl_xor_sync(kFullMask, rmin, off));
      }
      if (on && sub == 0) s_round_m[k] = rmin;
      __syncthreads();
    }
  }
  if constexpr (kExact) {
    if (tid < nr) {
      // the caller's layer order, as its fold over the layers runs
      double sm_min = inf, rm_min = inf;
      for (int i = 0; i < g.count; ++i) {
        const int k = s_rank[i] * T + tid;
        sm_min = nan_min(sm_min, s_scale_m[k]);
        rm_min = nan_min(rm_min, s_low[k] ? inf : s_round_m[k]);
      }
      scale_margin[r0 + tid] = sm_min;
      round_margin[r0 + tid] = rm_min;
    }
  }
  SPLIT_MARK(5, split_out);
  SPLIT_END();
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
// finite); a[k + 2] takes it when it joins the update.
//
// Schur form. The step's numerator is not summed: with F_k[m] = sum_i
// a_k[i] c[m-i] and B_k[m] = sum_i a_k[k-i] c[m-i] (F_0 = B_0 = c), each
// step updates both elementwise,
//   F_{k+1}[m] = F_k[m] + gamma_k B_k[m-1],
//   B_{k+1}[m] = B_k[m-1] + gamma_k F_k[m],
// and num_{k+1} = F_{k+1}[k+2] = F_k[k+2] + gamma_k B_k[k+1], two values
// known before gamma_k. So the serial chain a step is the divide, one
// multiply and one add (beside ek's three operations); the updates and
// the data movement run beside the divide. The kernel keeps them in a
// frame that moves with the step, Ft_k[j] = F_k[j+k+1] and Bt_k[j] =
// B_k[j+k]: then num_{k+1} = Ft_k[1] + gamma_k Bt_k[1] always reads entry
// 1, Bt updates in place (Bt += gamma Ft) and Ft takes (Ft + gamma Bt)
// one entry down. No entry past k + 1 of a_k (the plain version's
// `tail`: 0, or NaN once a gamma is not finite) enters num: num_{k+1} is
// NaN when gamma_k is not finite instead, which is when the plain
// version's tail turns NaN and carries NaN into every later sum; a lag
// first reaches num through F_0 = c, as it reaches the plain sum through
// a[0] = 1, so NaN and +-Inf land in the same places. The update of a
// runs over every entry, a[k + 1 - i] read as 0 past the row's start, so
// the entries past k + 1 take gamma * 0 as the plain version's do
// (tests/torch_levinson_model.py models the kernel step for step).

constexpr int kLvSlots = 5;      // a[], Ft and Bt entries a lane
constexpr int kLvThreads = 128;  // a CTA

// The least power of two G of lanes a row with G * kLvSlots >= order + 1.
__host__ __device__ constexpr int levinson_lanes(int order) {
  int g = 1;
  while (g * kLvSlots < order + 1) g *= 2;
  return g;
}

// A CTA's rows in shared memory: a[] twice (step k's and step k + 1's),
// each after kWidth zeros, so that a[k + 1 - i] reads 0 for i > k + 1,
// and the parcor values; odd strides of doubles, so that rows on
// neighbouring lanes fall in other banks.
template <int G>
struct LvShared {
  static constexpr int kRows = kLvThreads / G;
  static constexpr int kWidth = G * kLvSlots;
  static constexpr int kStride = kWidth | 1;
  double a[2][kRows][kWidth + kStride];
  double pc[kRows][kStride];
};

// Entry I of a row whose lane l holds v[m] = x[l + G m], on every lane.
template <int G, int I>
__device__ __forceinline__ double lv_entry(const double (&v)[kLvSlots]) {
  if constexpr (G == 1) {
    return v[I];
  } else {
    return __shfl_sync(kFullMask, v[I / G], I % G, G);
  }
}

// x[j + 1] on lane l for the x[l + G m] = v[m] of a row's G lanes: from
// the lane above, lane G - 1 from lane 0 a slot higher (0 past the end).
template <int G>
__device__ __forceinline__ void lv_shift_down(double (&v)[kLvSlots],
                                              int lane) {
  if constexpr (G == 1) {
#pragma unroll
    for (int m = 0; m + 1 < kLvSlots; ++m) v[m] = v[m + 1];
    v[kLvSlots - 1] = 0.0;
  } else {
    double up[kLvSlots];
#pragma unroll
    for (int m = 0; m < kLvSlots; ++m) {
      up[m] = __shfl_sync(kFullMask, v[m], (lane + 1) % G, G);
    }
#pragma unroll
    for (int m = 0; m + 1 < kLvSlots; ++m) {
      v[m] = lane == G - 1 ? up[m + 1] : up[m];
    }
    v[kLvSlots - 1] = lane == G - 1 ? 0.0 : up[kLvSlots - 1];
  }
}

// gamma_k = num_k / -ek_k (0 where ek_k is 0), taken as -num_k / ek_k
// (the same bits), from nnum = -num_k; then, in place, -num_{k+1} =
// -f - gamma_k b with f = F_k[k+2], b = B_k[k+1] (NaN when gamma_k is not
// finite), and ek_{k+1}.
__device__ __forceinline__ double lv_gamma(double& nnum, double& ek,
                                           double f, double b) {
  const double q = __ddiv_rn(nnum, ek);
  const double gamma = fabs(ek) > 0.0 ? q : 0.0;
  nnum = isfinite(gamma) ? __dsub_rn(-f, __dmul_rn(gamma, b))
                         : __longlong_as_double(0x7ff8000000000000LL);
  ek = __dmul_rn(ek, __dsub_rn(1.0, __dmul_rn(gamma, gamma)));
  return gamma;
}

// G lanes a row, 128 / G rows a CTA (rows are independent: no barrier
// across the CTA). Lane l holds a[i], Ft[i] and Bt[i] for i = l + G m in
// registers, reads its lags and writes its results straight from them,
// and keeps each step's a in shared memory, from which the next update
// reads the reversed entries a[k + 1 - i].
//
// In-order issue sets the loop's shape. Step k's divide runs beside step
// k - 1's work with gamma_{k-1} (the reads of a's copy, the updates of a,
// Ft and Bt, and the two values for num_{k+1}: Bt_k[1] and P[2] =
// Ft_k[1], read before the shift), so that the work fills the divide's
// latency; the shift and the stores follow it. The divide takes -num /
// ek, the same bits as num / -ek, so that ek's update feeds the next
// divide without a negation.
template <int G>
__global__ void __launch_bounds__(kLvThreads)
    levinson_kernel(const double* __restrict__ ac, double* __restrict__ lpc,
                    double* __restrict__ parcor, int64_t rows, int order) {
  using Shared = LvShared<G>;
  constexpr int W = Shared::kWidth;
  __shared__ Shared sm;
  const int tid = threadIdx.x;
  const int g = tid / G;
  const int lane = tid % G;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * Shared::kRows + g;
  const bool live = r < rows;  // the rest run along for the shuffles
  // split slots: 0 loads and set-up, 1 the steps, 2 the stores
  SPLIT_START(blockIdx.x == 0 && tid == 0);
  double own[kLvSlots];  // a_k[lane + G m]
  double ft[kLvSlots];   // Ft_k[lane + G m] = F_k[lane + G m + k + 1]
  double bt[kLvSlots];   // Bt_k[lane + G m] = B_k[lane + G m + k]
  double* const a0 = sm.a[0][g];
  double* const a1 = sm.a[1][g];
#pragma unroll
  for (int m = 0; m < kLvSlots; ++m) {
    const int i = lane + G * m;
    bt[m] = live && i <= order ? __ldg(ac + r * (order + 1) + i) : 0.0;
    own[m] = i == 0 ? 1.0 : 0.0;
    a0[i] = 0.0;  // the zeros before each copy of a[]
    a1[i] = 0.0;
    a0[W + i] = own[m];
  }
  const double c1 = lv_entry<G, 1>(bt);
  const double craw = lv_entry<G, 0>(bt);
  const bool silent = fabs(craw) < kFltEpsilon;
  const double c0 = silent ? 1.0 : craw;
  if (lane == 0) bt[0] = c0;
  // Ft_0[j] = c[j + 1]: Bt_0 one entry down
#pragma unroll
  for (int m = 0; m < kLvSlots; ++m) ft[m] = bt[m];
  lv_shift_down<G>(ft, lane);
  if constexpr (G > 1) __syncwarp();
  double ek = c0;
  // -num_0, with step 0's sum as the plain version takes it: a[0] c[1] +
  // a[1] c[0]
  double nnum = -__dadd_rn(__dadd_rn(0.0, c1), __dmul_rn(0.0, c0));
  SPLIT_MARK(0, nnum);
  // step 0: nothing pending
  double gamma = lv_gamma(nnum, ek, lv_entry<G, 1>(ft), lv_entry<G, 1>(bt));
  for (int k = 1; k < order; ++k) {
    // step k - 1's work with gamma_{k-1}, beside step k's divide: a_k,
    // Bt_k, P = Ft_{k-1} + gamma_{k-1} Bt_{k-1}, Ft_k[1] = P[2] and
    // Bt_k[1]; then Ft_k (P one entry down) and the stores
    const double* old = sm.a[(k - 1) & 1][g] + W + k - lane;
    double rv[kLvSlots];  // a_{k-1}[k - i], every read before any store
#pragma unroll
    for (int m = 0; m < kLvSlots; ++m) rv[m] = old[-G * m];
#pragma unroll
    for (int m = 0; m < kLvSlots; ++m) {
      const double fo = ft[m];
      ft[m] = __dadd_rn(fo, __dmul_rn(gamma, bt[m]));
      bt[m] = __dadd_rn(bt[m], __dmul_rn(gamma, fo));
      own[m] = __dadd_rn(own[m], __dmul_rn(gamma, rv[m]));
    }
    const double pending = gamma;
    gamma = lv_gamma(nnum, ek, lv_entry<G, 2>(ft), lv_entry<G, 1>(bt));
    lv_shift_down<G>(ft, lane);
    double* fresh = sm.a[k & 1][g] + W + lane;
#pragma unroll
    for (int m = 0; m < kLvSlots; ++m) fresh[G * m] = own[m];
    if (lane == 0) sm.pc[g][k - 1] = -pending;
    if constexpr (G > 1) __syncwarp();  // a_k's copy, for the next update
  }
  {
    // the last step's update of a
    const double* old = sm.a[(order - 1) & 1][g] + W + order - lane;
#pragma unroll
    for (int m = 0; m < kLvSlots; ++m) {
      own[m] = __dadd_rn(own[m], __dmul_rn(gamma, old[-G * m]));
    }
    if (lane == 0) sm.pc[g][order - 1] = -gamma;
  }
  SPLIT_MARK(1, own[0]);
  if constexpr (G > 1) __syncwarp();
  if (live) {
#pragma unroll
    for (int m = 0; m < kLvSlots; ++m) {
      const int i = lane + G * m;
      if (i >= 1 && i <= order) {
        lpc[r * order + i - 1] = silent ? 0.0 : own[m];
      }
      if (parcor && i < order) {
        parcor[r * order + i] = silent ? 0.0 : sm.pc[g][i];
      }
    }
  }
  SPLIT_MARK(2, 0);
  SPLIT_END();
}

// -- _predict_dense ----------------------------------------------------------
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

//
// Register tiling. A thread computes kPdG consecutive outputs from a window
// of samples in registers: each tap's coefficient is read once for all of
// them (a shared-memory broadcast), and the window slides four taps at a
// time by one 16-byte load, so a multiply-add costs 1/32 of a shared load
// where one output a thread cost two. The coefficients sit in shared
// memory reversed per unit and padded with zeros to a multiple of four
// taps (cr[unit * npu4 + k - 1] = c[unit * npu + npu - k]), so every tap
// block is four taps and one aligned load; each thread fetches its
// coefficient beside the samples and puts it in place once log2u is
// known, so the CTA waits for one round of loads, not two. A CTA takes
// kPdTile samples of one row after a history of kPdHist, staged by 16-byte
// loads where the row allows them: at n = 10240, 640 CTAs, one wave at 5
// a SM. At n = 10240 a unit has 80 << (7 - log2u) samples, so a thread's
// outputs never straddle two units; where they do (other n), the thread
// takes each output on its own. Tensor cores do not fit: a unit has one
// coefficient vector, so the product has width 1.

// N int32 from 16-byte-aligned shared memory into v[0, N), 16 bytes a
// load
template <int N, int M>
__device__ __forceinline__ void pd_load(int32_t (&v)[M], const int32_t* p) {
  static_assert(N % 4 == 0 && N <= M, "whole 16-byte loads");
#pragma unroll
  for (int t = 0; t < N; t += 4) {
    const int4 q = *reinterpret_cast<const int4*>(p + t);
    v[t] = q.x;
    v[t + 1] = q.y;
    v[t + 2] = q.z;
    v[t + 3] = q.w;
  }
}

constexpr int kPdThreads = 128;
constexpr int kPdG = 16;                         // outputs a thread
constexpr int kPdTile = kPdThreads * kPdG;       // samples a CTA
constexpr int kPdHist = kMaxOrder;               // history before a tile
constexpr int kPdCoefs = kMaxOrder * 4;          // u * npu4 <= order + 3 u
static_assert(kPdThreads >= kMaxOrder, "a coefficient a thread");

__global__ void __launch_bounds__(kPdThreads)
    predict_kernel(const int32_t* __restrict__ x,
                   const int32_t* __restrict__ coefs,
                   const int32_t* __restrict__ log2u,
                   const int32_t* __restrict__ rshift,
                   int32_t* __restrict__ out, int64_t tiles, int n,
                   int order, int64_t coef_stride) {
  __shared__ __align__(16) int32_t xs[kPdHist + kPdTile];
  __shared__ __align__(16) int32_t cr[kPdCoefs];
  const int tid = threadIdx.x;
  // split slots: 0 staging and the barrier, 1 set-up of the taps, 2 the
  // taps, 3 the residuals and the stores
  SPLIT_START(blockIdx.x == 1 && tid == 0);
  const int64_t row = blockIdx.x / tiles;
  const int g0 = static_cast<int>(blockIdx.x - row * tiles) * kPdTile;
  const int l2 = __ldg(log2u + row);
  const int rs = __ldg(rshift + row);
  const int32_t cv = tid < order ? __ldg(coefs + row * coef_stride + tid) : 0;
  const int32_t* xr = x + row * n;
  // xs[h] = x[g0 - kPdHist + h], 0 outside the row
  const int base = g0 - kPdHist;
  if ((n & 3) == 0 && (reinterpret_cast<uintptr_t>(xr) & 15) == 0) {
    const int4 zero = make_int4(0, 0, 0, 0);
    for (int q = tid; q < (kPdHist + kPdTile) / 4; q += kPdThreads) {
      const int g = base + 4 * q;  // a multiple of 4, as n is
      reinterpret_cast<int4*>(xs)[q] =
          (g >= 0 && g < n) ? __ldg(reinterpret_cast<const int4*>(xr + g))
                            : zero;
    }
  } else {
    for (int h = tid; h < kPdHist + kPdTile; h += kPdThreads) {
      const int g = base + h;
      xs[h] = (g >= 0 && g < n) ? __ldg(xr + g) : 0;
    }
  }
  const int npu = order >> l2;
  const int npu4 = (npu + 3) & ~3;
  const int units = npu4 ? min(1 << l2, kPdCoefs / npu4) : 0;
  // c[tid] is tap npu - (tid - unit * npu) of its unit; the padding is 0
  if (tid < units * npu) {
    const int unit = tid / npu;
    cr[unit * npu4 + npu - 1 - (tid - unit * npu)] = cv;
  }
  for (int e = tid; e < units * (npu4 - npu); e += kPdThreads) {
    const int unit = e / (npu4 - npu);
    cr[unit * npu4 + npu + (e - unit * (npu4 - npu))] = 0;
  }
  __syncthreads();
  SPLIT_MARK(0, xs[kPdHist]);
  const int ns = max(n >> l2, 1);  // log2u <= log2(u_max) by contract
  const int g = g0 + tid * kPdG;
  if (g >= n) return;
  const uint32_t half = (rs >= 1 && rs <= 32) ? (1u << (rs - 1)) : 0u;
  const int shift = (rs < 0 || rs > 31) ? 31 : rs;
  const int h = kPdHist + tid * kPdG;  // xs index of sample g
  const int last = min(g + kPdG, n) - 1;
  const int unit = g / ns;
  uint32_t acc[kPdG];
  uint32_t kept = 0;  // bit j: output j is predicted (past its unit's head)
  if (last / ns == unit) {
    const int offset = g - unit * ns;
#pragma unroll
    for (int j = 0; j < kPdG; ++j) kept |= (offset + j >= npu ? 1u : 0u) << j;
#pragma unroll
    for (int j = 0; j < kPdG; ++j) acc[j] = half;
    const int32_t* cu = cr + unit * npu4;
    SPLIT_MARK(1, acc[0]);
    int kb = 0;  // taps done
    if (npu4 >= 16) {
      // sixteen taps a pass: w[t] = xs[h - kb - 16 + t], so tap kb + 1 + e
      // of output j is w[15 - e + j]; the window slides by 16 a pass, so
      // that it moves kPdG / 4 registers a tap block, not kPdG
      int32_t w[kPdG + 16];
      pd_load<kPdG + 16>(w, xs + h - 16);
      for (; kb + 16 <= npu4; kb += 16) {
        int32_t cd[16];
        pd_load<16>(cd, cu + kb);
#pragma unroll
        for (int e = 0; e < 16; ++e) {
#pragma unroll
          for (int j = 0; j < kPdG; ++j) {
            acc[j] += static_cast<uint32_t>(cd[e]) *
                      static_cast<uint32_t>(w[15 - e + j]);
          }
        }
#pragma unroll
        for (int t = kPdG + 15; t >= 16; --t) w[t] = w[t - 16];
        if (kb + 32 <= npu4) pd_load<16>(w, xs + h - kb - 32);
      }
    }
    if (kb < npu4) {
      // four taps a pass: win[t] = xs[h - kb - 4 + t], tap kb + 1 + d of
      // output j is win[3 - d + j]
      int32_t win[kPdG + 4];
      pd_load<kPdG + 4>(win, xs + h - kb - 4);
      for (; kb < npu4; kb += 4) {
        int32_t cd[4];
        pd_load<4>(cd, cu + kb);
#pragma unroll
        for (int d = 0; d < 4; ++d) {
#pragma unroll
          for (int j = 0; j < kPdG; ++j) {
            acc[j] += static_cast<uint32_t>(cd[d]) *
                      static_cast<uint32_t>(win[3 - d + j]);
          }
        }
        // (the window stays inside xs: kb + 8 <= npu4 <= 128 = kPdHist)
#pragma unroll
        for (int t = kPdG + 3; t >= 4; --t) win[t] = win[t - 4];
        if (kb + 8 <= npu4) pd_load<4>(win, xs + h - kb - 8);
      }
    }
    SPLIT_MARK(2, acc[kPdG - 1]);
  } else {
    // the thread's outputs straddle two units: each on its own
#pragma unroll
    for (int j = 0; j < kPdG; ++j) {
      const int gj = min(g + j, last);
      const int uj = gj / ns;
      kept |= (gj - uj * ns >= npu ? 1u : 0u) << j;
      const int32_t* cu = cr + uj * npu4;
      acc[j] = half;
      for (int k = 1; k <= npu; ++k) {
        acc[j] += static_cast<uint32_t>(cu[k - 1]) *
                  static_cast<uint32_t>(xs[h + j - k]);
      }
    }
  }
  int32_t* o = out + row * n + g;
  const bool vec =
      last == g + kPdG - 1 && (reinterpret_cast<uintptr_t>(o) & 15) == 0;
#pragma unroll
  for (int t = 0; t < kPdG; t += 4) {
    const int4 v = *reinterpret_cast<const int4*>(xs + h + t);
    const int32_t xv[4] = {v.x, v.y, v.z, v.w};
    int32_t res[4];
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      const int32_t pred = static_cast<int32_t>(acc[t + d]) >> shift;
      res[d] = (kept >> (t + d)) & 1u
                   ? static_cast<int32_t>(static_cast<uint32_t>(xv[d]) +
                                          static_cast<uint32_t>(pred))
                   : xv[d];
    }
    if (vec) {
      *reinterpret_cast<int4*>(o + t) = make_int4(res[0], res[1], res[2],
                                                  res[3]);
    } else {
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        if (g + t + d <= last) o[t + d] = res[d];
      }
    }
  }
  SPLIT_MARK(3, acc[0]);
  SPLIT_END();
}

// -- unit_residual_select ----------------------------------------------------
//
// The residual pass of fit_layer's unit-count sweep. For each candidate
// unit count u of a layer of `order` taps (npu = order / u taps a unit,
// ns = n / u samples), the residual of every sample t >= 1,
//   r[t] = x[t] + sum_{j < npu} c[(t / ns) * npu + j] * x[t - npu + j]
// (r[0] = x[0]; x is 0 before t = 0, and a unit's context reaches back
// into the unit before it), the candidate's loss sum_{t >= 1} |r[t]| / n,
// and the first minimum over the candidates in order (strict <: a tie
// keeps the earlier split, a NaN loss never wins and a NaN first loss is
// never replaced); then the winner's residual row, its coefficients, its
// log2 u and its loss. It replaces the candidate loop of
// ops/analysis.py:fit_layer (per candidate unit_forward's loop, FFT or
// matrix-unit route, then abs, sum and four where on [ridges, blocks,
// channels, n] tensors), which the JAX package leaves to XLA
// (linne_tpu/ops/analysis.py fit_layer): it replaces no Pallas kernel.
//
// Exactness. Each prediction is the loop route's sum, tap by tap from
// j = 0: acc = +0, acc = __dadd_rn(acc, __dmul_rn(c, x)), then
// __dadd_rn(x[t], acc); so every residual is bit-equal to
// ops/analysis.py:_unit_forward_loop's. The loss is summed in another
// order than torch.sum (a thread's outputs in order, the lanes of a warp
// in a butterfly, then the warps and chunks in order): the same bits for
// a row wherever it sits in the batch, within rounding of the plain
// version's, so only a near-tie pick can differ from it.
//
// Bound. The multiply-adds, n * npu a row and candidate (255 a sample
// summed over the candidates of order 128), two FP64 instructions each
// (a product then a sum: the loop route rounds the product, so no FMA),
// at the FP64 issue rate; the bytes, a row in and its residual out, take
// about a fifteenth of that time at order 128.
//
// Design. One CTA a row. The row is staged in shared memory once with
// cp.async, after `order` samples of history, beside every candidate's
// coefficients; a row longer than the shared memory a CTA keeps
// (kUrSmemBudget, so that two CTAs share an SM) is taken in chunks, each
// staged with its own history. Pass 1: a thread takes tiles of kUrP
// consecutive outputs and runs the taps eight at a time from a window of
// kUrP + 7 samples in registers: each coefficient is a shared-memory
// broadcast, each sample is loaded once for eight taps, and as kUrP is
// odd, the lanes' windows, kUrP doubles apart, fall in distinct banks.
// The tiles cut the row at the units of the finest candidate split, so
// that a tile lies in one unit of every candidate, and they are the same
// for every candidate, and so is the order in which the loss adds up the
// outputs: candidates with equal residuals have equal losses, and the
// first of them wins, as in the plain version. (kUrP = 9 wastes 1 of 81
// outputs on the 80-sample units of a 10240-sample block in 128 units.)
// A thread adds up |r| over its outputs; each warp's sum of a candidate
// goes to shared memory, with no barrier between the candidates, so that
// a thread idle at the end of one candidate's tiles starts on the next.
// One thread then folds the candidates' losses.
// Pass 2 computes the winner's residual again and writes it over the
// staged samples, in rounds of tiles from the end of the row back: a
// round's outputs read only samples at or before their own, which the
// rounds after it (written before it) do not reach. The row then leaves
// in one coalesced copy.
//
// Measured (chip_smoke.py phase 4b; NVIDIA H100 80GB HBM3 at 700 W): the
// preset-7 order-128 call of a 128-block batch (1,024 rows of 10,240
// samples, 8 candidates) 0.653 ms against 11.49 ms for the torch pass it
// replaced and a 0.320 ms FP64 issue bound; a batch's three calls ~0.9
// ms, the order-4 and order-16 ones bound by staging their rows.

constexpr int kUrP = 9;            // outputs a tile (odd: no bank conflicts)
constexpr int kUrThreads = 256;    // the most threads a CTA
constexpr int kUrMaxCands = 8;     // unit counts 1, 2, 4, ..., 128
constexpr int kUrPad = kUrP + 1;   // samples a tile may read past a chunk
constexpr int kUrSmemBudget = 110 * 1024;  // bytes a CTA: two an SM

struct UrCands {
  const double* params[kUrMaxCands];  // candidate i: [rows, order]
  int log2u[kUrMaxCands];
  int count;
};

// The tiles of the chunk [cs, ce), for units of ns samples: tile i holds
// the outputs [start, min(start + kUrP, end)) of one unit, the chunk's
// first unit (or its part of one) first, then whole units of `full`
// tiles each; a tile of a unit that the chunk's end cuts may start at or
// past `end`, and then holds nothing.
struct UrTiles {
  int cs, ce, ns, first_end, first, full, count;
  __device__ UrTiles(int cs_, int ce_, int ns_) : cs(cs_), ce(ce_), ns(ns_) {
    first_end = min(ce, (cs / ns + 1) * ns);
    first = (first_end - cs + kUrP - 1) / kUrP;
    full = (ns + kUrP - 1) / kUrP;
    count = first + (ce - first_end + ns - 1) / ns * full;
  }
  __device__ __forceinline__ void at(int i, int& start, int& end) const {
    if (i < first) {
      start = cs + i * kUrP;
      end = first_end;
      return;
    }
    const int j = i - first;
    const int unit = j / full;
    const int unit_start = first_end + unit * ns;
    start = unit_start + (j - unit * full) * kUrP;
    end = min(ce, unit_start + ns);
  }
};

// acc[p] += c[k] * w[k + p] for k < K, tap by tap, with w = xw[0, kUrP +
// K - 1) and c[0, K) read from shared memory.
template <int K>
__device__ __forceinline__ void ur_taps(const double* xw, const double* c,
                                        double (&acc)[kUrP]) {
  double w[kUrP + K - 1];
#pragma unroll
  for (int q = 0; q < kUrP + K - 1; ++q) w[q] = xw[q];
  double cc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) cc[k] = c[k];
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int p = 0; p < kUrP; ++p) {
      acc[p] = __dadd_rn(acc[p], __dmul_rn(cc[k], w[k + p]));
    }
  }
}

// r[p]: the residual of output start + p, from xw = the staged x[start -
// npu] and c = its unit's npu taps.
__device__ __forceinline__ void ur_tile(const double* xw, const double* c,
                                        int npu, double (&r)[kUrP]) {
  double acc[kUrP];
#pragma unroll
  for (int p = 0; p < kUrP; ++p) acc[p] = 0.0;
  int j = 0;
  for (; j + 8 <= npu; j += 8) ur_taps<8>(xw + j, c + j, acc);
  if (j + 4 <= npu) {
    ur_taps<4>(xw + j, c + j, acc);
    j += 4;
  }
  if (j + 2 <= npu) {
    ur_taps<2>(xw + j, c + j, acc);
    j += 2;
  }
  if (j < npu) ur_taps<1>(xw + j, c + j, acc);
#pragma unroll
  for (int p = 0; p < kUrP; ++p) r[p] = __dadd_rn(xw[npu + p], acc[p]);
}

// buf[i] = x[cs - hist + i] for i < hist + ce - cs (0 before the row's
// start), then a barrier.
__device__ __forceinline__ void ur_stage(double* buf, const double* xr,
                                         int cs, int ce, int hist) {
  const unsigned sbase = static_cast<unsigned>(__cvta_generic_to_shared(buf));
  for (int i = threadIdx.x; i < hist + ce - cs; i += blockDim.x) {
    const int g = cs - hist + i;
    if (g >= 0) {
      cp_async8(sbase + 8u * i, xr + g);
    } else {
      buf[i] = 0.0;
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// The sum of v over the warp, the same bits on every lane.
__device__ __forceinline__ double ur_warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = __dadd_rn(v, __shfl_xor_sync(kFullMask, v, off));
  }
  return v;
}

// Row `row` of x starts at x + (row / per_ridge) * ridge_stride + (row %
// per_ridge) * n. Shared memory: the staged chunk (`order` samples of
// history, `chunk` samples, kUrPad more), the candidates' coefficients
// [count][order] and each warp's loss sums [count][warps].
__global__ void __launch_bounds__(kUrThreads, 2)
    unit_residual_kernel(const double* __restrict__ x, int64_t ridge_stride,
                         int64_t per_ridge, const UrCands cands, int order,
                         int n, int chunk, double* __restrict__ res,
                         double* __restrict__ flat, double* __restrict__ loss,
                         int32_t* __restrict__ log2u) {
  extern __shared__ double ur_sm[];
  __shared__ int s_best;
  const int tid = threadIdx.x, threads = blockDim.x;
  const int warps = threads >> 5, warp = tid >> 5, lane = tid & 31;
  const int hist = order, count = cands.count;
  double* const buf = ur_sm;
  double* const coef = buf + hist + chunk + kUrPad;
  double* const part = coef + count * order;
  int fine = 0;  // the finest split's log2 u: its units cut the tiles
  for (int c = 0; c < count; ++c) fine = max(fine, cands.log2u[c]);
  const int64_t row = blockIdx.x;
  const double* const xr =
      x + (row / per_ridge) * ridge_stride + (row % per_ridge) * n;
  for (int i = tid; i < count * order; i += threads) {
    const int c = i / order;
    coef[i] = __ldg(cands.params[c] + row * order + (i - c * order));
  }
  for (int i = tid; i < count * warps; i += threads) part[i] = 0.0;
  const int chunks = (n + chunk - 1) / chunk;

  // pass 1: every candidate's loss, chunk by chunk
  for (int k = 0; k < chunks; ++k) {
    const int cs = k * chunk, ce = min(n, cs + chunk);
    if (k) __syncthreads();  // every read of the chunk before is done
    ur_stage(buf, xr, cs, ce, hist);
    const UrTiles tiles(cs, ce, n >> fine);
    for (int c = 0; c < count; ++c) {
      const int npu = order >> cands.log2u[c], ns = n >> cands.log2u[c];
      double s = 0.0;
      for (int i = tid; i < tiles.count; i += threads) {
        int start, end;
        tiles.at(i, start, end);
        if (start >= end) continue;
        double r[kUrP];
        ur_tile(buf + hist + (start - cs) - npu,
                coef + c * order + (start / ns) * npu, npu, r);
#pragma unroll
        for (int p = 0; p < kUrP; ++p) {
          if (p < end - start && start + p > 0) s = __dadd_rn(s, fabs(r[p]));
        }
      }
      s = ur_warp_sum(s);
      if (lane == 0) {
        part[c * warps + warp] = __dadd_rn(part[c * warps + warp], s);
      }
    }
  }
  __syncthreads();
  if (tid == 0) {
    int best = 0;
    double best_loss = 0.0;
    for (int c = 0; c < count; ++c) {
      double s = 0.0;
      for (int w = 0; w < warps; ++w) s = __dadd_rn(s, part[c * warps + w]);
      const double l = __ddiv_rn(s, static_cast<double>(n));
      if (c == 0 || l < best_loss) {
        best_loss = l;
        best = c;
      }
    }
    s_best = best;
    loss[row] = best_loss;
    log2u[row] = cands.log2u[best];
  }
  __syncthreads();
  const int best = s_best;
  for (int i = tid; i < order; i += threads) {
    flat[row * order + i] = coef[best * order + i];
  }

  // pass 2: the winner's residual over the staged samples, from the last
  // chunk (still staged) back to the first
  const int npu = order >> cands.log2u[best], ns = n >> cands.log2u[best];
  const double* const cb = coef + best * order;
  double* const out = res + row * n;
  for (int k = chunks - 1; k >= 0; --k) {
    const int cs = k * chunk, ce = min(n, cs + chunk);
    if (k != chunks - 1) {
      __syncthreads();  // the copy of the chunk after it is done
      ur_stage(buf, xr, cs, ce, hist);
    }
    const UrTiles tiles(cs, ce, n >> fine);
    for (int round = (tiles.count + threads - 1) / threads - 1; round >= 0;
         --round) {
      const int i = round * threads + tid;
      int start = 0, end = 0;
      double r[kUrP];
      if (i < tiles.count) {
        tiles.at(i, start, end);
        if (start < end) {
          ur_tile(buf + hist + (start - cs) - npu, cb + (start / ns) * npu,
                  npu, r);
        } else {
          end = start;
        }
      }
      __syncthreads();  // every read of the round's samples is done
#pragma unroll
      for (int p = 0; p < kUrP; ++p) {
        if (p < end - start && start + p > 0) {
          buf[hist + (start - cs) + p] = r[p];
        }
      }
    }
    __syncthreads();
    for (int t = cs + tid; t < ce; t += threads) out[t] = buf[hist + t - cs];
  }
}

// -- lpc_autocorr -------------------------------------------------------------
//
// The windowed autocorrelation of every candidate unit split of a layer
// fit (and of the block-type estimate): for each candidate, u = 2^log2u
// units of ns = n / u samples, each unit's samples multiplied by the
// candidate's window of ns taps, xw[t] = x[t] * w[t], and for each unit
// and lag l < lags, ac[l] = sum_{t < ns - l} xw[t] * xw[t + l]. It
// replaces, on a CUDA tensor, ops/analysis.py's per-candidate `seg *
// window` product and all of `autocorrelation`'s card routes (a lag scan
// of one product and one sum a lag, the FFT, the chunked G-matrix product
// `_autocorr_matmul`), which the JAX package leaves to XLA
// (linne_tpu/ops/analysis.py fit_unit_lpc, autocorrelation): it replaces
// no Pallas kernel.
//
// Exactness. Each windowed sample is __dmul_rn(x[t], w[t]) with w read
// from the caller's window table, the bits of torch's `seg * window`.
// Each ac[l] is summed in a fixed order (below) with fused multiply-adds:
// no atomics, one CTA a row, so the same bits for a row wherever it sits
// in the batch and run to run, within rounding of the plain version's
// sums. A silent row gives exact zeros.
//
// Bound. The multiply-adds, sum over the candidates of u * sum_{l < lags}
// (ns - l) a row, at the FP64 rate (one DFMA each): 2.69 M a row at order
// 128 and n = 10240; the bytes, each row read once and every ac written
// once, are far below that there and set the bound at orders 2 and 4.
//
// Design. One CTA a row, two CTAs an SM (so that one's staging and
// windowing overlap the other's multiply-adds). The row is staged in
// shared memory with cp.async in chunks, each with the lags' lookahead, as
// long as two CTAs' copies fit. For each candidate: (1) the CTA writes the
// windowed chunk beside it (the window's taps by cp.async, then one
// multiply each), each unit followed by zeros for the lags that reach
// past its end and, where that leaves an even stride, one slot more, so
// that units start in other banks; (2) the work is cut into items: a
// unit, a group of up to 16 consecutive lags (the last group takes 2..17,
// so 129 lags are 7 x 16 + 17) and one of S stretches of t, S the largest
// power of two with S x (units x groups) <= the CTA's threads and S x 32
// <= ns, each stretch of odd length, so that lanes S apart or a unit
// apart read distinct banks. An item keeps its group's sums in registers
// and a ring of its group's second operands: a step loads one sample of
// each operand for K fused multiply-adds, where the lag scan loaded two a
// multiply-add; the zeros after the unit stand in for every mask. A group
// is run at the least compiled lag count that holds it (2, 3, 5, 9, 16 or
// 17: the groups of the format's power-of-two orders), its extra lags left
// unstored. (3) The lanes that share a (unit, group) pair, a warp or S of
// its lanes, add their sums in a butterfly and one of them adds the total
// to the row's sums in shared memory; where a pair spans warps (S > 32),
// or lanes of two lag counts share a warp, partials go to shared memory
// and (4) one thread an output adds them in order of t. The row's sums
// leave in one coalesced copy. The order of every sum depends only on n
// and the candidates, through the plan.
//
// Measured (chip_smoke.py phase 4c; NVIDIA H100 80GB HBM3 at 700 W): see
// PERF.md. Per launch of a 128-block batch: order 128 (1,024 rows, 8
// candidates) ~0.57 ms against a 0.165 ms FP64 bound and 6.8-7.1 ms for
// the card routes it replaced; of it ~0.21 ms staging, windowing and
// barriers (the launch with the multiply-adds taken out).

constexpr int kLaThreads = 256;    // the most threads a CTA
constexpr int kLaMaxCands = 8;     // unit counts 1, 2, 4, ..., 128
constexpr int kLaMaxLags = kMaxOrder + 1;
constexpr int kLaGroup = 16;       // lags an item, the last group 2..17
constexpr int kLaMaxK = kLaGroup + 1;
constexpr int kLaMinStretch = 32;  // the fewest samples of t an item takes
constexpr int kLaSmemBudget = 112 * 1024;  // bytes a CTA: two an SM

struct LaCands {
  const double* window[kLaMaxCands];  // [n >> log2u] or null: no window
  int log2u[kLaMaxCands];
  int lags[kLaMaxCands];
  int count;
};

// Shared memory in doubles: the staged chunk and its lookahead, the
// windowed chunk (units at odd strides), the partials (min(lags, kLaMaxK)
// doubles an item or warp), the row's sums [total].
struct LaPlan {
  int chunk, look, raw_len, wbuf_len, part_len, total;
};

// The lag groups of a unit with L lags: groups of kLaGroup, the last one
// K = L - kLaGroup * (G - 1) in [1, kLaMaxK].
__host__ __device__ __forceinline__ int la_groups(int L) {
  return L <= kLaMaxK ? 1 : (L - 2) / kLaGroup + 1;
}

// The lag count the kernel is compiled for that runs a group of K lags:
// the least of those of the format's power-of-two orders (2, 3, 5, 9, 16,
// 17) that holds K; the lags past K are formed and left unstored.
__host__ __device__ __forceinline__ int la_compiled(int K) {
  return K <= 2 ? 2 : K == 3 ? 3 : K <= 5 ? 5 : K <= 9 ? 9
                                             : K <= kLaGroup ? kLaGroup
                                                             : kLaMaxK;
}

// The slots after each unit of ns samples in the windowed chunk: zeros for
// the lags its groups form past its end (la_compiled of its largest group,
// less one), and one more where that leaves an even stride, so that the
// units start in other banks.
__host__ __device__ __forceinline__ int la_pad(int ns, int L) {
  const int G = la_groups(L);
  const int kc =
      max(G > 1 ? kLaGroup : 0, la_compiled(L - kLaGroup * (G - 1)));
  return kc - 1 + ((ns + kc - 1) & 1 ? 0 : 1);
}

// S, the stretches of t a (unit, group) pair is cut into: the largest
// power of two with S x pairs <= threads and S x kLaMinStretch <= ns.
__host__ __device__ __forceinline__ int la_stretches(int pairs, int ns,
                                                     int threads) {
  int S = 1;
  while (2 * S * pairs <= threads && 2 * S * kLaMinStretch <= ns) S *= 2;
  return S;
}

// The lanes whose sums of one pair are added in registers: a warp's (S >=
// 32: a warp holds one pair), S (one lag count over the warp: its lanes
// run the same code), else 1 (lanes of two lag counts share the warp).
// Where they are all S stretches, the pair's total goes straight to the
// row's sums; else one partial a `lanes` lanes, for the fold.
__host__ __device__ __forceinline__ int la_lanes(int S, int G) {
  return S >= 32 ? 32 : (G == 1 ? S : 1);
}

// acc[k] = sum_{t in [t0, t1)} w[t] * w[t + l0 + k], k < K; w indexes the
// unit's windowed samples, which zeros follow for K - 1 slots past its
// end, so no product needs a mask. Each acc[k] adds its products in order
// of t, fused. A ring of K registers holds w[t + l0 .. t + l0 + K): a step
// loads w[t] and the one sample that enters the ring, for K multiply-adds,
// and a block of K steps brings the ring back to its first slot, so that
// every index is static; the last block's steps past t1 multiply zeros.
template <int K>
__device__ __forceinline__ void la_sums(const double* w, int t0, int t1,
                                        int l0, double (&acc)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.0;
  if (t0 >= t1) return;
  double ring[K];
#pragma unroll
  for (int k = 0; k < K; ++k) ring[k] = w[t0 + l0 + k];
  for (int t = t0; t < t1; t += K) {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      const double a = t + s < t1 ? w[t + s] : 0.0;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        acc[k] = __fma_rn(a, ring[(s + k) % K], acc[k]);
      }
      // w[t + l0 + s] leaves the ring, w[t + l0 + s + K] enters: the last
      // lag of step s + 1, read where that step is inside the stretch
      if (t + s + 1 < t1) ring[s] = w[t + l0 + s + K];
    }
  }
}

// One item's sums, added over `lanes` lanes of the warp in a butterfly
// (every lane then holds the same bits); where `store`, the first `keep`
// written to dst[k], or with `add` added to it.
template <int K>
__device__ __forceinline__ void la_item(const double* w, int t0, int t1,
                                        int l0, int lanes, int keep,
                                        bool add, bool store, double* dst) {
  double acc[K];
  la_sums<K>(w, t0, t1, l0, acc);
  for (int off = lanes >> 1; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      acc[k] = __dadd_rn(acc[k], __shfl_xor_sync(kFullMask, acc[k], off));
    }
  }
  if (!store) return;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (k < keep) dst[k] = add ? __dadd_rn(dst[k], acc[k]) : acc[k];
  }
}

// la_item for a group of K lags, at la_compiled(K) lags (the unit's zeros
// and the chunk's lookahead cover the samples the lags past K read).
__device__ __forceinline__ void la_item_k(int K, const double* w, int t0,
                                          int t1, int l0, int lanes,
                                          bool add, bool store, double* dst) {
#define LA_RUN(k) la_item<k>(w, t0, t1, l0, lanes, K, add, store, dst)
  switch (la_compiled(K)) {
    case 2: LA_RUN(2); break;
    case 3: LA_RUN(3); break;
    case 5: LA_RUN(5); break;
    case 9: LA_RUN(9); break;
    case kLaGroup: LA_RUN(kLaGroup); break;
    default: LA_RUN(kLaMaxK); break;
  }
#undef LA_RUN
}

// Row `row` of x at x + row * row_stride; out [rows, plan.total], each
// candidate's [u][lags] after the one before it.
__global__ void __launch_bounds__(kLaThreads, 2)
    lpc_autocorr_kernel(const double* __restrict__ x, int64_t row_stride,
                        int n, const LaCands cands, const LaPlan plan,
                        double* __restrict__ out) {
  extern __shared__ double la_sm[];
  double* const raw = la_sm;
  double* const wbuf = raw + plan.raw_len;
  double* const part = wbuf + plan.wbuf_len;
  double* const sums = part + plan.part_len;
  const int tid = threadIdx.x, threads = blockDim.x;
  const int64_t row = blockIdx.x;
  const double* const xr = x + row * row_stride;
  SPLIT_START(blockIdx.x == 0 && tid == 0);
  for (int i = tid; i < plan.total; i += threads) sums[i] = 0.0;
  const int chunks = (n + plan.chunk - 1) / plan.chunk;
  for (int k = 0; k < chunks; ++k) {
    const int c0 = k * plan.chunk, c1 = min(n, c0 + plan.chunk);
    // raw[i] = x[c0 + i]; the last reads of raw (a window pass) are
    // behind a barrier, the sums' and partials' readers are not touched
    ur_stage(raw, xr, c0, min(n, c1 + plan.look), 0);
    SPLIT_MARK(0, raw[0]);
    int col = 0;
    for (int c = 0; c < cands.count; ++c) {
      const int l2 = cands.log2u[c], L = cands.lags[c];
      const int ns = n >> l2;
      const int j0 = c0 / ns, j1 = (c1 - 1) / ns;
      const int pad = la_pad(ns, L);  // zeros after a unit
      // (1) the windowed chunk: unit j at wbuf[base(j) + t], t from the
      // unit's start, base(j) = j * ns - c0 + pad * (j - j0), its zeros
      // after it where it ends before the chunk's lookahead does. The
      // window's taps come in with cp.async, all of a thread's in flight
      // at once, and each thread then multiplies the taps it copied by the
      // samples
      const double* const win = cands.window[c];
      const int we = min(min(n, c1 + plan.look), (j1 + 1) * ns);
      // a thread's samples t = c0 + tid + m * threads, each one's unit j
      // and offset r = t - j * ns carried from the one before
      const int jstep = threads / ns, rstep = threads - jstep * ns;
      const int jt = (c0 + tid) / ns, rt = c0 + tid - jt * ns;
      if (win) {
        const unsigned wsb =
            static_cast<unsigned>(__cvta_generic_to_shared(wbuf));
        for (int t = c0 + tid, j = jt, r = rt; t < we; t += threads) {
          cp_async8(wsb + 8u * (t - c0 + pad * (j - j0)), win + r);
          j += jstep;
          r += rstep;
          if (r >= ns) r -= ns, ++j;
        }
        asm volatile("cp.async.wait_all;\n" ::: "memory");
      }
      for (int t = c0 + tid, j = jt, r = rt; t < we; t += threads) {
        const int i = t - c0 + pad * (j - j0);
        wbuf[i] = win ? __dmul_rn(raw[t - c0], wbuf[i]) : raw[t - c0];
        j += jstep;
        r += rstep;
        if (r >= ns) r -= ns, ++j;
      }
      for (int i = tid; i < (we / ns - j0) * pad; i += threads) {
        const int j = j0 + i / pad;
        wbuf[(j + 1) * ns - c0 + pad * (j - j0) + (i - (j - j0) * pad)] = 0.0;
      }
      __syncthreads();
      SPLIT_MARK(1, wbuf[0]);
      // (2)-(3) the items: pair p = (unit j0 + p / G, group p % G), its
      // stretch s; a warp's lanes all take part in its butterflies (those
      // past the last item with empty stretches)
      const int G = la_groups(L), klast = L - kLaGroup * (G - 1);
      const int ks = min(L, kLaMaxK);  // the partials' stride
      const int pairs = (j1 - j0 + 1) * G;
      const int S = la_stretches(pairs, ns, threads), sh = __ffs(S) - 1;
      const int lanes = la_lanes(S, G), lsh = __ffs(lanes) - 1;
      const bool direct = lanes == S;
      const int slots = S >> lsh;  // partials a pair, where not direct
      const int lane = tid & 31;
      for (int ib = tid - lane; ib < pairs * S; ib += threads) {
        const bool valid = ib + lane < pairs * S;
        const int i = valid ? ib + lane : ib;
        const int p = i >> sh, s = i & (S - 1);
        const int jp = p / G, g = p - jp * G, j = j0 + jp;
        const int l0 = kLaGroup * g, K = g == G - 1 ? klast : kLaGroup;
        const int a0 = max(0, c0 - j * ns);
        const int t1 = min(min(ns, c1 - j * ns), ns - l0);
        const int len = valid ? max(0, t1 - a0) : 0;
        const int cl = ((len + S - 1) >> sh) | 1;
        const int ts = min(len, s * cl), te = min(len, ts + cl);
        // w from the unit's first sample in the chunk, a0 (>= 0 in wbuf)
        la_item_k(K, wbuf + (j * ns - c0 + pad * (j - j0) + a0), ts, te, l0,
                  lanes, direct, valid && (s & (lanes - 1)) == 0,
                  direct ? sums + col + j * L + l0
                         : part + ((p << (sh - lsh)) + (s >> lsh)) * ks);
      }
      SPLIT_MARK(2, part[0]);
      __syncthreads();
      SPLIT_MARK(3, 0);
      // (4) where the pairs left partials, the chunk's sums, a thread an
      // output, in order of t; the next window pass runs beside it (its
      // barrier comes before the partials are written again)
      for (int o = tid; !direct && o < (j1 - j0 + 1) * L; o += threads) {
        const int jl = o / L, l = o - jl * L;
        const int g = min(l / kLaGroup, G - 1);
        const double* const q =
            part + (jl * G + g) * slots * ks + (l - kLaGroup * g);
        double v = 0.0;
        for (int s = 0; s < slots; ++s) v = __dadd_rn(v, q[s * ks]);
        double* const dst = sums + col + (j0 + jl) * L + l;
        *dst = __dadd_rn(*dst, v);
      }
      SPLIT_MARK(4, sums[0]);
      col += (1 << l2) * L;
    }
  }
  __syncthreads();
  double* const orow = out + row * plan.total;
  for (int i = tid; i < plan.total; i += threads) orow[i] = sums[i];
  SPLIT_MARK(5, 0);
  SPLIT_END();
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

template <int G>
void levinson_launch(const double* ac, double* lpc, double* parcor,
                     int64_t rows, int order, cudaStream_t st) {
  constexpr int R = kLvThreads / G;
  const auto grid = static_cast<unsigned>((rows + R - 1) / R);
  levinson_kernel<G><<<grid, kLvThreads, 0, st>>>(ac, lpc, parcor, rows,
                                                   order);
}

}  // namespace

// All pointers are device pointers to contiguous tensors; each function
// launches on `stream`, does not synchronise, and returns
// cudaGetLastError() after the launch.

// count (1..4) layers of the same rows: layer i's taps at srcs[i] + row *
// strides[i] + t (float64), orders[i] (1..128) taps, its int coefficients
// to qc[row * qc_stride + cols[i] + t] and its rshift to rshift[i *
// rs_layer + row * rs_row] (int32); 1 <= nbits <= 31. exact selects the
// byte-exact fit's variant, which also writes round_margin[row] and
// scale_margin[row] (float64, folded over the layers).
extern "C" int linne_quantize_layers(int count, const void* const* srcs,
                                     const int64_t* strides,
                                     const int* orders, const int* cols,
                                     int32_t* qc, int64_t qc_stride,
                                     int32_t* rshift, int64_t rs_layer,
                                     int64_t rs_row, double* round_margin,
                                     double* scale_margin, int64_t rows,
                                     int nbits, int exact, void* stream) {
  if (count < 1 || count > kQMaxLayers || rows < 1 || nbits < 1 ||
      nbits > 31 || (exact && (!round_margin || !scale_margin))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int by_order[kQMaxLayers];
  for (int i = 0; i < count; ++i) {
    if (orders[i] < 1 || orders[i] > kMaxOrder) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    // insertion sort, longest order first, ties in the caller's order
    int j = i;
    for (; j > 0 && orders[by_order[j - 1]] < orders[i]; --j) {
      by_order[j] = by_order[j - 1];
    }
    by_order[j] = i;
  }
  QGroup g{};
  g.count = count;
  g.tile_rows = kQMaxItems / count;
  int scol = 0;
  for (int l = 0; l < count; ++l) {
    const int i = by_order[l];
    g.layer[l] = {static_cast<const double*>(srcs[i]), strides[i], orders[i],
                  cols[i], i, scol};
    scol += orders[i];
  }
  g.stride = scol | 1;
  const int64_t ctas = (rows + g.tile_rows - 1) / g.tile_rows;
  if (g.tile_rows * g.stride > kQSmem || ctas > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const auto grid = static_cast<unsigned>(ctas);
  if (exact) {
    quantize_kernel<true><<<grid, kQThreads, 0, st>>>(
        g, qc, qc_stride, rshift, rs_layer, rs_row, round_margin,
        scale_margin, rows, nbits);
  } else {
    quantize_kernel<false><<<grid, kQThreads, 0, st>>>(
        g, qc, qc_stride, rshift, rs_layer, rs_row, nullptr, nullptr, rows,
        nbits);
  }
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
  switch (levinson_lanes(order)) {
    case 1: levinson_launch<1>(ac, lpc, parcor, rows, order, st); break;
    case 2: levinson_launch<2>(ac, lpc, parcor, rows, order, st); break;
    case 4: levinson_launch<4>(ac, lpc, parcor, rows, order, st); break;
    case 8: levinson_launch<8>(ac, lpc, parcor, rows, order, st); break;
    case 16: levinson_launch<16>(ac, lpc, parcor, rows, order, st); break;
    default: levinson_launch<32>(ac, lpc, parcor, rows, order, st); break;
  }
  return static_cast<int>(cudaGetLastError());
}

#ifdef LINNE_CLOCK_SPLIT
// out[0..7] <- the cycles booked to each split slot since the last call,
// which clears them (synchronous).
extern "C" int linne_clock_split(long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_split, sizeof(g_split));
  if (err == cudaSuccess) {
    const long long zeros[kSplitSlots] = {};
    err = cudaMemcpyToSymbol(g_split, zeros, sizeof(g_split));
  }
  return static_cast<int>(err);
}
#endif

// cycles[0] <- the clock64 cycles of a chain of n dependent __ddiv_rn in
// one warp (out [32] float64 keeps the chain live), launched on stream.
extern "C" int linne_ddiv_probe(double x, int n, long long* cycles,
                                double* out, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  ddiv_probe_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      x, n, cycles, out);
  return static_cast<int>(cudaGetLastError());
}

// x [rows, n], coefs [rows, order] (row r at coefs + r * coef_stride),
// log2u [rows], rshift [rows] int32 -> out [rows, n] int32;
// 1 <= order <= 128, n >= 1.
extern "C" int linne_predict_dense(const int32_t* x, const int32_t* coefs,
                                   const int32_t* log2u,
                                   const int32_t* rshift, int32_t* out,
                                   int64_t rows, int n, int order,
                                   int64_t coef_stride, void* stream) {
  if (rows < 1 || n < 1 || order < 1 || order > kMaxOrder ||
      coef_stride < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t tiles = (n + kPdTile - 1) / kPdTile;
  const int64_t ctas = rows * tiles;
  if (ctas > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  predict_kernel<<<static_cast<unsigned>(ctas), kPdThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      x, coefs, log2u, rshift, out, tiles, n, order, coef_stride);
  return static_cast<int>(cudaGetLastError());
}

// x: row r of n float64 samples at x + (r / per_ridge) * ridge_stride +
// (r % per_ridge) * n (ridge_stride >= 0, in doubles; 0 for an expanded
// input); params[i] [rows, order] float64, candidate i's coefficients
// (u_i units of order / u_i taps, reversed layout), log2u[i] = log2 u_i,
// count (1..8) candidates in the order of the first-minimum fold; out: res
// [rows, n], flat [rows, order], loss [rows] float64 and log2u_out [rows]
// int32 of each row's winner. 1 <= order <= 128; u_i divides order and n.
extern "C" int linne_unit_residual_select(
    const double* x, int64_t ridge_stride, int64_t per_ridge,
    const void* const* params, const int* log2u, int count, int order, int n,
    int64_t rows, double* res, double* flat, double* loss,
    int32_t* log2u_out, void* stream) {
  if (rows < 1 || rows > 0x7fffffffLL || per_ridge < 1 || ridge_stride < 0 ||
      count < 1 || count > kUrMaxCands || order < 1 || order > kMaxOrder ||
      n < 1 || n > (1 << 30)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  UrCands cands{};
  cands.count = count;
  for (int i = 0; i < count; ++i) {
    const int l2 = log2u[i];
    if (l2 < 0 || l2 > 7 || (order >> l2) << l2 != order ||
        (n >> l2) << l2 != n) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    cands.params[i] = static_cast<const double*>(params[i]);
    cands.log2u[i] = l2;
  }
  // the plan: a thread per tile up to kUrThreads; the longest chunk that
  // keeps the CTA's shared memory within kUrSmemBudget, in chunks of
  // equal length
  const int tiles = (n + kUrP - 1) / kUrP;
  const int threads = min(kUrThreads, max(32, (tiles + 31) / 32 * 32));
  const int fixed = count * order + count * (threads / 32);  // doubles
  const int cap = kUrSmemBudget / 8 - fixed - order - kUrPad;
  const int chunks = (n + cap - 1) / cap;
  const int chunk = (n + chunks - 1) / chunks;
  const size_t smem = 8 * static_cast<size_t>(order + chunk + kUrPad + fixed);
  // above 48 KB only once the kernel allows it, on each device
  static bool allowed[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!allowed[dev]) {
    err = cudaFuncSetAttribute(unit_residual_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kUrSmemBudget);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed[dev] = true;
  }
  unit_residual_kernel<<<static_cast<unsigned>(rows), threads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      x, ridge_stride, per_ridge, cands, order, n, chunk, res, flat, loss,
      log2u_out);
  return static_cast<int>(cudaGetLastError());
}

// x: row r of n float64 samples at x + r * row_stride (row_stride >= 0, in
// doubles); count (1..8) candidates, candidate i: 2^log2u[i] units (log2u
// 0..7, dividing n) of n >> log2u[i] samples under windows[i] (float64,
// n >> log2u[i] taps, or null: no window) and lags[i] (1..129) lags;
// out [rows, sum of 2^log2u[i] * lags[i]] float64, candidate i's [units,
// lags] after candidate i - 1's.
extern "C" int linne_lpc_autocorr(const double* x, int64_t row_stride,
                                  int64_t rows, int n,
                                  const void* const* windows,
                                  const int* log2u, const int* lags,
                                  int count, double* out, void* stream) {
  if (rows < 1 || rows > 0x7fffffffLL || row_stride < 0 || n < 1 ||
      n > (1 << 30) || count < 1 || count > kLaMaxCands) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  LaCands cands{};
  cands.count = count;
  LaPlan plan{};
  int max_lags = 1;
  for (int i = 0; i < count; ++i) {
    const int l2 = log2u[i];
    if (l2 < 0 || l2 > 7 || (n >> l2) << l2 != n || lags[i] < 1 ||
        lags[i] > kLaMaxLags) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    cands.window[i] = static_cast<const double*>(windows[i]);
    cands.log2u[i] = l2;
    cands.lags[i] = lags[i];
    plan.total += (1 << l2) * lags[i];
    // the furthest lag a group forms, its compiled lags past L included
    const int G = la_groups(lags[i]);
    max_lags = max(max_lags, kLaGroup * (G - 1) +
                                 la_compiled(lags[i] - kLaGroup * (G - 1)));
  }
  // the plan, from n and the candidates alone: a thread for every ~20
  // samples up to kLaThreads; the partials of every item (or warp); the
  // longest chunk whose staged and windowed copies fit beside them
  const int threads = min(kLaThreads, max(32, (n / 20 + 31) / 32 * 32));
  plan.look = max_lags - 1;
  for (int i = 0; i < count; ++i) {  // a chunk reaches 1..u units
    const int ns = n >> log2u[i], G = la_groups(lags[i]);
    for (int units = 1; units <= (1 << log2u[i]); ++units) {
      const int S = la_stretches(units * G, ns, threads);
      const int lanes = la_lanes(S, G);
      if (lanes != S) {
        plan.part_len = max(plan.part_len, units * G * (S / lanes) *
                                               min(lags[i], kLaMaxK));
      }
    }
  }
  const int avail = kLaSmemBudget / 8 - plan.part_len - plan.total;
  auto wbuf_len = [&](int chunk) {
    int zeros = 0;  // the zeros after each unit the chunk reaches
    for (int i = 0; i < count; ++i) {
      const int ns = n >> log2u[i];
      const int units = min(1 << log2u[i], (chunk + plan.look - 1) / ns + 2);
      zeros = max(zeros, units * la_pad(ns, lags[i]));
    }
    return min(n, chunk + plan.look) + zeros;
  };
  int chunks = 1;
  plan.chunk = n;
  while (min(n, plan.chunk + plan.look) + wbuf_len(plan.chunk) > avail) {
    if (plan.chunk <= 1) return static_cast<int>(cudaErrorInvalidValue);
    chunks = max(chunks + 1, chunks * 5 / 4);
    plan.chunk = (n + chunks - 1) / chunks;
  }
  plan.raw_len = min(n, plan.chunk + plan.look);
  plan.wbuf_len = wbuf_len(plan.chunk);
  const size_t smem = 8 * static_cast<size_t>(plan.raw_len + plan.wbuf_len +
                                              plan.part_len + plan.total);
  static bool allowed[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!allowed[dev]) {
    err = cudaFuncSetAttribute(lpc_autocorr_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kLaSmemBudget);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed[dev] = true;
  }
  lpc_autocorr_kernel<<<static_cast<unsigned>(rows), threads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      x, row_stride, n, cands, plan, out);
  return static_cast<int>(cudaGetLastError());
}

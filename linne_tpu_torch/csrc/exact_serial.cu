// Strict serial-order float64 chains of the byte-exact device encoder.
//
// These kernels replace no Pallas kernel: the JAX package left the serial
// sums of its strict fit graph to XLA as `lax.scan` loops
// (linne_tpu/ops/exact_device.py). Run as plain torch, every step of such a
// scan is a kernel launch, some 10^5 launches per fit chunk, so each chain
// is a kernel here, running the reference's loop in the reference's order:
//
//   autocorr_serial   replaces _autocorr_serial (:148):
//                     ac[s, lag] = sum_i seg[s, i] * seg[s, i + lag],
//                     i = 0, 1, ... from +0.0. Staged and blocked (below).
//   levinson_serial   replaces _levinson_serial (:203) and its scan tail
//                     _levinson_scan_tail (:247): the Levinson-Durbin
//                     recursion op for op; one thread a segment with a[]
//                     in registers up to order 32, one warp a segment
//                     above (below).
//   serial_abs_mean   replaces _serial_abs_mean (:378):
//                     sum_{t=start}^{n-1} |x[t]| / n; one warp runs up to
//                     32 rows staged through shared-memory tiles (below).
//   chain_predict     replaces _chain_predict (:349): per output sample a
//                     serial chain over the unit's taps, with and without
//                     the sample itself as the chain's start; one thread
//                     per (row, t), neighbouring t in neighbouring lanes.
//
// autocorr_serial. Each (segment, lag) sum is one chain of ns - lag
// dependent adds; a call has nseg * nlags of them. A thread runs K chains
// (lags l0 .. l0 + K - 1 of one segment, K = 1, 2 or 4 by call shape) and
// keeps them in registers, interleaved. A CTA of 32-128 threads takes
// consecutive (segment, lag group) tasks and stages its segments through a
// ring of two shared-memory tiles: per segment the samples of a tile and
// the window the tile's lags reach past it, one TMA bulk copy a segment
// (cp.async.bulk, completing on an mbarrier; 8-byte cp.async where a row
// is not 16-byte aligned), tile t + 1 in flight while the threads run tile
// t. A chain step then reads shared memory and registers only, and a block
// of 8 steps loads 16 samples for 8K products, a block ahead of its use.
//
// Exactness. Every product and sum is __dmul_rn / __dadd_rn and every
// quotient __ddiv_rn: nvcc contracts `a + x * y` into an FMA by default,
// and the intrinsics are never contracted, so the shared build flags stay
// as they are. Products the JAX graph takes behind its FMA shield
// (`_mulsh`: a NaN product becomes 0) do the same here (mulsh below). No
// chain is split, reordered or contracted: each is one thread's serial
// __dadd_rn sequence in i. The autocorrelation's JAX scan adds the
// products with its zero padding past the segment's end; the staged tiles
// hold zeros there too, so the last tile's steps past ns add +-0.0 (or a
// shielded 0 * Inf) to a sum that started at +0.0 and so is never -0.0:
// bit-neutral. The chains first run unshielded: a NaN product makes the
// sum NaN for good, so a sum that ends not NaN is the shielded sum; a CTA
// with a NaN sum runs again with the shield.
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
// 8,765 dependent steps for the order-128 recursion (k + 5 at step k).
// serial_abs_mean is bytes-bound where its rows fill the card (a chunk's
// 4,096-row call: 336 MB, 0.100 ms at 3.35 TB/s) and chain-bound where
// they do not (the 512-row call: 10,240 adds, ~0.042 ms at 8.19 cycles
// and 1.98 GHz); levinson_serial is chain-bound at every order.
// dadd_probe_kernel measures a dependent add's latency on the card.

#include <algorithm>
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

// -- autocorr_serial ---------------------------------------------------------

constexpr int kAcThreads = 128;  // the most threads a CTA: 4 warps
// Dynamic shared memory a CTA may take: at 100 KB two CTAs share an SM's
// 227 KB, at 72 KB three (plan_for).
constexpr int kAcSmemBudget = 100 * 1024;
constexpr int kAcSmemBudget3 = 72 * 1024;
// Steps a block of run_tile: the unit of its register window and loads.
constexpr int kAcBlock = 8;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async8(double* dst, const double* src,
                                          bool valid) {
  // src-size 0 fills the 8 bytes with zeros
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 8 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// One arrival that also expects `bytes` of bulk copies to complete.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// A TMA bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from global to shared memory, completing on bar.
__device__ __forceinline__ void bulk_copy(double* dst, const double* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// One CTA's share of the flattened [nseg, groups] task grid: blockDim.x
// consecutive (segment, lag group) tasks, and where their samples sit in
// shared memory. A stage holds, per segment j the CTA touches, the window
// region: samples [t0 + lo_j, t0 + lo_j + width) of the tile at t0 (the
// x[i + lag] operands; lo_j is the first lag the CTA runs of segment j,
// rounded down to even), at j * stride. The x[i] operands are the window
// region's head, except for a first segment that starts past lag 0: its
// samples [t0, t0 + tile + kAcBlock) sit at nsc * stride. Samples at or
// past ns read as zeros.
struct AcCta {
  const double* seg;
  double* smem;
  uint64_t* bars;  // one mbarrier a stage (bulk copies)
  int64_t s_lo;    // first segment
  int nsc;         // segments touched
  int lo0;         // lo_0, even
  int ns;
  int tile;        // samples a tile, a multiple of 3 * kAcBlock
  int width;       // samples of a window region: tile + span, even
  int stride;      // doubles between window regions, 2 mod 4
  int stage;       // doubles a stage
  bool bulk;       // ns even and seg 16-byte aligned: TMA bulk copies
  unsigned uses0, uses1;  // tiles staged into each stage so far
};

__device__ __forceinline__ int ac_head(const AcCta& c) {
  return c.tile + kAcBlock;
}

// Stages the tile at t0 into stage b. With bulk copies thread 0 issues one
// TMA copy a region and the threads zero what lies past ns; else every
// thread copies 8-byte samples with cp.async, as one commit group.
__device__ __forceinline__ void stage_tile(AcCta& c, int b, int t0) {
  double* buf = c.smem + b * c.stage;
  if (b) {
    ++c.uses1;
  } else {
    ++c.uses0;
  }
  const int nreg = c.nsc + (c.lo0 ? 1 : 0);
  // region q: segment q < nsc (window) or the first segment's head
  auto region = [&](int q, const double*& src, double*& dst, int& len) {
    const bool head = q == c.nsc;
    const int start = t0 + (head || q ? 0 : c.lo0);
    const int size = head ? ac_head(c) : c.width;
    src = c.seg + (c.s_lo + (head ? 0 : q)) * c.ns + start;
    dst = buf + q * c.stride;
    len = c.ns - start < size ? (c.ns - start > 0 ? c.ns - start : 0) : size;
    return size;
  };
  if (c.bulk) {
    for (int q = 0; q < nreg; ++q) {
      const double* src;
      double* dst;
      int len;
      const int size = region(q, src, dst, len);
      for (int i = len + threadIdx.x; i < size; i += blockDim.x) dst[i] = 0.0;
    }
    if (threadIdx.x == 0) {
      unsigned bytes = 0;
      for (int q = 0; q < nreg; ++q) {
        const double* src;
        double* dst;
        int len;
        region(q, src, dst, len);
        bytes += 8u * len;
      }
      // the threads' earlier reads of this stage precede the async writes
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_expect(c.bars + b, bytes);
      for (int q = 0; q < nreg; ++q) {
        const double* src;
        double* dst;
        int len;
        region(q, src, dst, len);
        if (len) bulk_copy(dst, src, 8u * len, c.bars + b);
      }
    }
  } else {
    for (int q = 0; q < nreg; ++q) {
      const double* src;
      double* dst;
      int len;
      const int size = region(q, src, dst, len);
      for (int i = threadIdx.x; i < size; i += blockDim.x) {
        cp_async8(dst + i, i < len ? src + i : c.seg, i < len);
      }
    }
    cp_async_commit();
  }
}

// Waits until the tile last staged into stage b has landed, for every
// thread (`last`: no later tile is in flight).
__device__ __forceinline__ void wait_tile(const AcCta& c, int b, bool last) {
  if (c.bulk) {
    mbar_wait(c.bars + b, ((b ? c.uses1 : c.uses0) - 1) & 1);
  } else if (last) {
    cp_async_wait<0>();
  } else {
    cp_async_wait<1>();
  }
  __syncthreads();
}

template <bool kShield>
__device__ __forceinline__ double product(double x, double y) {
  if constexpr (kShield) return mulsh(x, y);
  return __dmul_rn(x, y);
}

// S consecutive samples from p: 16-byte loads where p is even.
template <int S, bool kPairs>
__device__ __forceinline__ void load_run(const double* p, double (&v)[S]) {
  if constexpr (kPairs) {
    const double2* q = reinterpret_cast<const double2*>(p);
#pragma unroll
    for (int j = 0; j < S / 2; ++j) {
      const double2 t = q[j];
      v[2 * j] = t.x;
      v[2 * j + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < S; ++j) v[j] = p[j];
  }
}

// One tile of K chains, lags l0 .. l0 + K - 1 of one segment: xa[i] is
// x[t0 + i], xw[r + i] is x[t0 + i + l0] (r = l0 - lo of the region).
// Step i adds x[i] * x[i + l0 + k] to chain k, in order of i. A block of
// S = kAcBlock steps from i0 needs x[i0 .. i0 + S - 1] and the window
// x[i0 + l0 .. i0 + l0 + K + S - 2]: its first K samples are the last K of
// the previous block's, so a block loads 2S samples for S * K products.
// The lanes of a warp load windows K samples apart; as 16-byte loads (K
// even) that is conflict-free for K = 2. The source issues the next
// block's loads before a block's adds (ptxas moves many of them next to
// their use, where their latency shows), and three register sets
// rotate, so the loop carries no dependence but the K chains and needs no
// register moves.
template <int K, bool kShield>
__device__ __forceinline__ void run_tile(const double* xa, const double* xw,
                                         int r, int tile, double (&acc)[K]) {
  constexpr int S = kAcBlock;
  static_assert(K <= S && S % 2 == 0, "block of S steps, K <= S");
  constexpr bool kPairs = K % 2 == 0;
  double r0[S], r1[S], r2[S], a0[S], a1[S], a2[S];
  auto load = [&](int i, double (&a)[S], double (&fresh)[S]) {
    load_run<S, true>(xa + i, a);
    load_run<S, kPairs>(xw + r + i + K, fresh);
  };
  // prev[S - K + m] is x[i0 + l0 + m] for m < K, fresh[m - K] above
  auto block = [&](const double (&a)[S], const double (&prev)[S],
                   const double (&fresh)[S]) {
#pragma unroll
    for (int j = 0; j < S; ++j) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const double y = j + k < K ? prev[S - K + j + k] : fresh[j + k - K];
        acc[k] = __dadd_rn(acc[k], product<kShield>(a[j], y));
      }
    }
  };
#pragma unroll
  for (int k = 0; k < K; ++k) r0[S - K + k] = xw[r + k];
  load(0, a0, r1);
  for (int i0 = 0; i0 < tile; i0 += 3 * S) {
    load(i0 + S, a1, r2);
    block(a0, r0, r1);
    load(i0 + 2 * S, a2, r0);
    block(a1, r1, r2);
    load(i0 + 3 * S, a0, r1);
    block(a2, r2, r0);
  }
}

// Every tile of the CTA's segments through a ring of two stages: tile
// t + 1 is in flight while the threads run tile t.
template <int K, bool kShield>
__device__ __forceinline__ void run_tiles(AcCta& c, int ls, int r,
                                          double (&acc)[K]) {
  const int ntiles = (c.ns + c.tile - 1) / c.tile;
  stage_tile(c, 0, 0);
  if (ntiles > 1) stage_tile(c, 1, c.tile);
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.0;
  for (int t = 0; t < ntiles; ++t) {
    wait_tile(c, t & 1, t + 1 == ntiles);
    const double* buf = c.smem + (t & 1) * c.stage;
    const double* xw = buf + ls * c.stride;
    const double* xa = (ls == 0 && c.lo0) ? buf + c.nsc * c.stride : xw;
    run_tile<K, kShield>(xa, xw, r, c.tile, acc);
    if (t + 2 < ntiles) {
      __syncthreads();  // every thread is done with this stage
      stage_tile(c, t & 1, (t + 2) * c.tile);
    }
  }
}

// Thread t of CTA b runs lag group g = task % groups of segment
// task / groups (task = b * blockDim.x + t): lags g*K .. g*K + K - 1.
// Lanes past the last task repeat it and store nothing.
//
// The chains first run without the NaN shield. A product is NaN only if
// an operand is NaN or it is 0 * Inf, and a NaN product makes the chain's
// sum NaN for good; so a chain that ends not NaN met no NaN product, and
// its sum is the shielded sum, bit for bit. Where any chain of the CTA
// ends NaN, the CTA runs again with the shield.
template <int K>
__global__ void __launch_bounds__(kAcThreads)
    autocorr_kernel(const double* __restrict__ seg, double* __restrict__ ac,
                    int64_t nseg, int ns, int nlags, int groups, int tile,
                    int width, int stride, int segs, int bulk) {
  extern __shared__ __align__(16) double smem[];
  __shared__ __align__(8) uint64_t bars[2];
  const int64_t tasks = nseg * groups;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x;
  const int64_t end =
      tasks < first + blockDim.x ? tasks : first + blockDim.x;
  AcCta c;
  c.seg = seg;
  c.smem = smem;
  c.bars = bars;
  c.s_lo = first / groups;
  c.nsc = static_cast<int>((end - 1) / groups - c.s_lo) + 1;
  c.lo0 = (static_cast<int>(first - c.s_lo * groups) * K) & ~1;
  c.ns = ns;
  c.tile = tile;
  c.width = width;
  c.stride = stride;
  c.stage = segs * stride + ac_head(c);
  c.bulk = bulk != 0;
  c.uses0 = c.uses1 = 0;
  const bool live = first + threadIdx.x < end;
  const int64_t task = live ? first + threadIdx.x : end - 1;
  const int ls = static_cast<int>(task / groups - c.s_lo);
  const int l0 = static_cast<int>(task % groups) * K;
  const int r = l0 - (ls == 0 ? c.lo0 : 0);  // lag offset in the region
  if (c.bulk && threadIdx.x == 0) {
    mbar_init(bars);
    mbar_init(bars + 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  double acc[K];
  run_tiles<K, false>(c, ls, r, acc);
  bool nan = false;
#pragma unroll
  for (int k = 0; k < K; ++k) nan |= l0 + k < nlags && acc[k] != acc[k];
  if (__syncthreads_or(live && nan)) {
    run_tiles<K, true>(c, ls, r, acc);
  }
  if (live) {
    double* out = ac + (c.s_lo + ls) * nlags;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (l0 + k < nlags) out[l0 + k] = acc[k];
    }
  }
}

// -- levinson_serial ---------------------------------------------------------
//
// The recursion of linne_tpu/ops/exact_device.py:203-244 on one segment:
//   a[1] = -r1 / r0; parcor[0] = r1 / r0; ek = r0 + r1 * a[1];
//   step k = 1 .. order - 1:
//     g = sum_{i=0}^{k} a[i] * r[k + 1 - i], serial in i from +0.0;
//     gamma = g / -ek; ek = ek * (1 - gamma * gamma);
//     a[i] = a[i] + gamma * a[k + 1 - i] for 1 <= i <= k + 1, all from the
//     old a[] (a[k + 1] is +0.0 and a[0] is 1.0 there, so a[k + 1] becomes
//     0.0 + gamma * 1.0); parcor[k] = -gamma.
// a[0] stays exactly 1.0 (1.0 + mulsh(gamma, 0.0) == 1.0), so it is never
// rewritten. Every product is mulsh, as in the JAX graph.
//
// Two paths by order (lv_plan). Up to kLvThreadMax, one thread a segment
// with a[] and r[] in registers: a template on the largest order it takes,
// loops fully unrolled and guarded by the call's order, so that no array
// is indexed at run time (an indexed a[] lives in local memory, and every
// term of the chain then goes through L1). Above it, one warp a segment:
// a[] and r[] in shared memory, lane l owning a[l], a[l + 32], ...; a
// step's k + 1 products are formed by their owners in parallel, then every
// lane runs the serial g chain over them from broadcast shared memory (no
// value is sent back), and the update is parallel over i. a[] and the
// products are double-buffered by step, so one __syncwarp a step orders
// every write before the next step's reads. Order 32 stays on the thread
// path: on an H100 the warp path took 0.0268 ms for the chunk's order-32
// call against the thread path's 0.0156 ms, and equal times at order 8.

constexpr double kFltEpsilon = 1.1920928955078125e-07;
constexpr int kLvThreadMax = 32;  // the largest order of the thread path
constexpr int kLvWarps = 4;       // the most warps (segments) a CTA
constexpr int kLvSlots = (kMaxOrder + 2 + 31) / 32;  // a[] entries a lane
constexpr int kLvBlock = 16;  // lv_chain's adds a block
// doubles of a product buffer: lv_chain reads a block past the chain's
// length rounded up to a block
constexpr int kLvProd = kMaxOrder + 2 * kLvBlock + 8;
constexpr int kLvLen = kMaxOrder + 2;

template <int P>
__global__ void __launch_bounds__(kThreads)
    levinson_thread_kernel(const double* __restrict__ ac,
                           double* __restrict__ coef,
                           double* __restrict__ parcor,
                           uint8_t* __restrict__ zc, int64_t nseg,
                           int order) {
  const int64_t s = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (s >= nseg) return;
  const double* r = ac + s * (order + 1);
  double rr[P + 1];
#pragma unroll
  for (int i = 0; i <= P; ++i) rr[i] = i <= order ? __ldg(r + i) : 0.0;
  double a[P + 2];
  a[0] = 1.0;
#pragma unroll
  for (int i = 1; i < P + 2; ++i) a[i] = 0.0;
  double* c = coef + s * order;
  double* pc = parcor + s * order;
  const double r0 = rr[0];
  const bool zero = fabs(r0) < kFltEpsilon;
  double ek = r0;
  a[1] = __ddiv_rn(-rr[1], r0);
  pc[0] = zero ? 0.0 : __ddiv_rn(rr[1], ek);
  ek = __dadd_rn(ek, mulsh(rr[1], a[1]));
#pragma unroll
  for (int k = 1; k < P; ++k) {
    if (k < order) {
      double g = 0.0;
#pragma unroll
      for (int i = 0; i <= k; ++i) g = __dadd_rn(g, mulsh(a[i], rr[k + 1 - i]));
      const double gamma = __ddiv_rn(g, -ek);
      ek = __dmul_rn(ek, __dsub_rn(1.0, mulsh(gamma, gamma)));
      double b[P + 2];
#pragma unroll
      for (int i = 1; i <= k + 1; ++i) {
        b[i] = __dadd_rn(a[i], mulsh(gamma, a[k + 1 - i]));
      }
#pragma unroll
      for (int i = 1; i <= k + 1; ++i) a[i] = b[i];
      pc[k] = zero ? 0.0 : -gamma;
    }
  }
#pragma unroll
  for (int k = 0; k < P; ++k) {
    if (k < order) c[k] = zero ? 0.0 : a[k + 1];
  }
  zc[s] = zero ? 1 : 0;
}

// One warp's shared memory: a[] twice (the old and the new by step), the
// products twice, r[] and the parcor values.
struct LvWarp {
  double a[2][kLvLen];
  double prod[2][kLvProd];
  double r[kLvLen];
  double pc[kMaxOrder];
};

// sum_{i < len} p[i], serial in i from +0.0; p holds +0.0 from len up to
// len rounded up to kLvBlock, whose adds leave the sum's bits as they are
// (a sum that starts at +0.0 is never -0.0, and x + +0.0 == x). Blocks of
// kLvBlock adds with no branch inside, the next block's loads issued
// before them in the source. On an H100 blocks of 16 ran the order-128
// call fastest (0.077 ms against 0.081 and 0.080 ms for 8 and 32), yet
// the chain still takes ~11.7 cycles an add against the DADD's 8.19:
// ptxas places the loads next to their use whatever the source order.
__device__ __forceinline__ double lv_chain(const double* p, int len) {
  constexpr int B = kLvBlock;
  const int m = (len + B - 1) / B * B;
  double x[B], y[B];
  load_run<B, true>(p, x);
  double g = 0.0;
  for (int i = 0; i < m; i += B) {
    load_run<B, true>(p + i + B, y);  // past m on the last turn: unused
#pragma unroll
    for (int j = 0; j < B; ++j) g = __dadd_rn(g, x[j]);
#pragma unroll
    for (int j = 0; j < B; ++j) x[j] = y[j];
  }
  return g;
}

__global__ void __launch_bounds__(kLvWarps * 32)
    levinson_warp_kernel(const double* __restrict__ ac,
                         double* __restrict__ coef,
                         double* __restrict__ parcor,
                         uint8_t* __restrict__ zc, int64_t nseg, int order) {
  extern __shared__ __align__(16) double lv_smem[];
  const int lane = threadIdx.x & 31;
  const int64_t s =
      static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (s >= nseg) return;  // the whole warp: only __syncwarp below
  LvWarp& w = reinterpret_cast<LvWarp*>(lv_smem)[threadIdx.x >> 5];
  const double* r = ac + s * (order + 1);
  for (int i = lane; i < kLvProd; i += 32) {
    if (i < kLvLen) {
      w.r[i] = i <= order ? __ldg(r + i) : 0.0;
      w.a[0][i] = 0.0;
      w.a[1][i] = 0.0;
    }
    w.prod[0][i] = 0.0;
    w.prod[1][i] = 0.0;
  }
  __syncwarp();
  const double r0 = w.r[0];
  const double r1 = w.r[1];
  const bool zero = fabs(r0) < kFltEpsilon;
  const double a1 = __ddiv_rn(-r1, r0);
  const double pc0 = __ddiv_rn(r1, r0);
  double ek = __dadd_rn(r0, mulsh(r1, a1));
  // own[m] is a[lane + 32 m]
  double own[kLvSlots];
#pragma unroll
  for (int m = 0; m < kLvSlots; ++m) {
    const int i = lane + 32 * m;
    own[m] = i == 0 ? 1.0 : i == 1 ? a1 : 0.0;
    if (i <= 1) {
      w.a[0][i] = own[m];
      if (order > 1) w.prod[0][i] = mulsh(own[m], w.r[2 - i]);
    }
  }
  if (lane == 0) w.pc[0] = pc0;
  __syncwarp();
  for (int k = 1; k < order; ++k) {
    const int cur = (k - 1) & 1;
    const double* old = w.a[cur];
    double* fresh = w.a[cur ^ 1];
    double* prod = w.prod[cur ^ 1];
    const double g = lv_chain(w.prod[cur], k + 1);
    // the update's operands, read while the divide runs: every slot's
    // loads precede every store (the compiler moves no load past a store
    // to shared memory). A slot past k + 1 reads clamped indices and stores
    // into an entry no step reads (a[kLvLen - 1], prod[kLvProd - 1]).
    double av[kLvSlots], rv[kLvSlots];
#pragma unroll
    for (int m = 0; m < kLvSlots; ++m) {
      const int i = lane + 32 * m;
      const bool live = i <= k + 1;
      av[m] = old[live ? k + 1 - i : 0];
      rv[m] = w.r[live ? k + 2 - i : 0];
    }
    const double gamma = __ddiv_rn(g, -ek);
    ek = __dmul_rn(ek, __dsub_rn(1.0, mulsh(gamma, gamma)));
    // no branch over the slots, so that their latencies overlap; the last
    // step's products are written and never read
#pragma unroll
    for (int m = 0; m < kLvSlots; ++m) {
      const int i = lane + 32 * m;
      const bool live = i <= k + 1;
      const double updated = __dadd_rn(own[m], mulsh(gamma, av[m]));
      own[m] = live && i >= 1 ? updated : own[m];
      fresh[live ? i : kLvLen - 1] = own[m];
      prod[live ? i : kLvProd - 1] = mulsh(own[m], rv[m]);
    }
    if (lane == 0) w.pc[k] = -gamma;
    __syncwarp();
  }
  const double* a = w.a[(order - 1) & 1];
  for (int i = lane; i < order; i += 32) {
    coef[s * order + i] = zero ? 0.0 : a[i + 1];
    parcor[s * order + i] = zero ? 0.0 : w.pc[i];
  }
  if (lane == 0) zc[s] = zero ? 1 : 0;
}

// -- serial_abs_mean ---------------------------------------------------------
//
// sum_{t=start}^{n-1} |x[t]| / n per row: one chain of n - start dependent
// adds a row. A CTA is one warp running `rows` rows (lane q runs row q;
// am_plan picks rows so that the call spreads over the SMs) and staging
// them through shared-memory tiles, a ring of two where a row does not fit
// whole: each lane copies its own row's part of a tile with one TMA bulk
// copy onto the stage's mbarrier. A bulk copy needs 16-byte aligned ends,
// so a row's tiles start at the aligned element at or below `start`; the
// element at `start` where that lies 8 bytes past a boundary, and the one
// at n - 1 where the row's aligned part ends before it, are read by the
// lane itself (head, tail). A row's stride in shared memory is 2 mod 4
// doubles, so the lanes' 16-byte loads of one offset in their rows fall in
// distinct banks. The head is added before the tiles and the tail after
// them; in the first and the last tile an element outside the copied part
// adds +0.0 (one compare and one select an element, off the chain); the
// tiles between are copied whole and run unmasked.
// Every added value is |x| >= +0.0 or NaN and the sum starts at +0.0, so an
// added +0.0 leaves the sum's bits as they are.

constexpr int kAmBlock = 8;             // doubles a register set
constexpr int kAmStep = 2 * kAmBlock;   // tiles are a multiple of this
constexpr int kAmMaxTile = 1024;
// Dynamic shared memory of the CTAs an SM holds at once (of its 227 KB,
// less 1 KB a CTA the card reserves), and the most one CTA takes (on an
// H100, 416-sample tiles at 214 KB ran the 4,096-row call no faster than
// 192-sample tiles at 99 KB).
constexpr int kAmSmemPerSm = 216 * 1024;
constexpr int kAmSmemBudget = 100 * 1024;

// Where one row's tiles lie: tile j holds elements [a0 + j * tile,
// a0 + (j + 1) * tile); [clo, chi) is bulk-copied, 16-byte aligned.
struct AmRow {
  const double* x;  // the row
  int a0, clo, chi;
  int hpos, tpos;  // the head's and the tail's element, or -1
};

__device__ __forceinline__ AmRow am_row(const double* x, int64_t row,
                                        int row_len, int start, int n) {
  AmRow g;
  g.x = x + row * row_len;
  const uintptr_t base = reinterpret_cast<uintptr_t>(g.x) >> 3;
  const int ms = static_cast<int>((base + start) & 1);
  const int me = static_cast<int>((base + n) & 1);
  g.a0 = start - ms;
  g.clo = start + ms;
  g.chi = n - me;
  g.hpos = ms && start < n ? start : -1;
  g.tpos = me && n - 1 >= start ? n - 1 : -1;
  return g;
}

// Stages tile j into stage `buf` on bar: lane q < here copies row q's part.
__device__ __forceinline__ void am_stage(const AmRow& g, bool stager,
                                         double* buf, uint64_t* bar, int j,
                                         int tile) {
  const int t0 = g.a0 + j * tile;
  const int lo = max(t0, g.clo);
  const int hi = min(t0 + tile, g.chi);
  const unsigned bytes = stager && hi > lo ? 8u * (hi - lo) : 0u;
  const unsigned total = __reduce_add_sync(0xffffffffu, bytes);
  if (threadIdx.x == 0) mbar_expect(bar, total);
  __syncwarp();
  if (bytes) {
    // the lanes' earlier reads of this stage precede the async writes
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bulk_copy(buf + (lo - t0), g.x + lo, bytes, bar);
  }
}

// A tile whose every element is copied: the next set's loads are issued
// before this set's adds (the last turn reads past the tile, into the pad).
__device__ __forceinline__ double am_tile(const double* xs, int tile,
                                          double acc) {
  constexpr int S = kAmBlock;
  double r0[S], r1[S];
  load_run<S, true>(xs, r0);
  for (int i0 = 0; i0 < tile; i0 += 2 * S) {
    load_run<S, true>(xs + i0 + S, r1);
#pragma unroll
    for (int j = 0; j < S; ++j) acc = __dadd_rn(acc, fabs(r0[j]));
    load_run<S, true>(xs + i0 + 2 * S, r0);
#pragma unroll
    for (int j = 0; j < S; ++j) acc = __dadd_rn(acc, fabs(r1[j]));
  }
  return acc;
}

// The first or last tile: the copied elements [lo, hi) of it in order;
// the others add +0.0. The loop ends at the warp's last copied element.
__device__ __forceinline__ double am_tile_range(const double* xs, int lo,
                                                int hi, double acc) {
  constexpr int S = kAmBlock;
  const int end = __reduce_max_sync(0xffffffffu, hi);
  for (int i0 = 0; i0 < end; i0 += S) {
    double v[S];
    load_run<S, true>(xs + i0, v);
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const bool in = static_cast<unsigned>(i0 + j - lo) <
                      static_cast<unsigned>(hi - lo);
      acc = __dadd_rn(acc, fabs(in ? v[j] : 0.0));
    }
  }
  return acc;
}

__global__ void __launch_bounds__(32)
    abs_mean_kernel(const double* __restrict__ x, double* __restrict__ out,
                    int64_t nrows, int row_len, int start, int n, int rows,
                    int tile, int ntiles) {
  extern __shared__ __align__(16) double am_smem[];
  __shared__ __align__(8) uint64_t bars[2];
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * rows;
  const int here =
      nrows - row0 < rows ? static_cast<int>(nrows - row0) : rows;
  const int lane = threadIdx.x;
  const bool stager = lane < here;
  const int q = stager ? lane : here - 1;  // idle lanes shadow the last row
  const AmRow g = am_row(x, row0 + q, row_len, start, n);
  const double head = g.hpos >= 0 ? fabs(g.x[g.hpos]) : 0.0;
  const double tail = g.tpos >= 0 ? fabs(g.x[g.tpos]) : 0.0;
  const int stride = tile + 2;
  const int stage = rows * stride;
  if (lane == 0) {
    mbar_init(bars);
    mbar_init(bars + 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  double* mine = am_smem + q * stride;
  am_stage(g, stager, mine, bars, 0, tile);
  if (ntiles > 1) am_stage(g, stager, mine + stage, bars + 1, 1, tile);
  // the head sample precedes every copied one, the tail follows them
  double acc = __dadd_rn(0.0, head);
  for (int j = 0; j < ntiles; ++j) {
    const int b = j & 1;
    mbar_wait(bars + b, (j >> 1) & 1);
    const double* xs = mine + b * stage;
    if (j == 0 || j == ntiles - 1) {
      const int t0 = g.a0 + j * tile;
      acc = am_tile_range(xs, max(g.clo - t0, 0),
                          max(min(g.chi - t0, tile), 0), acc);
    } else {
      acc = am_tile(xs, tile, acc);
    }
    if (j + 2 < ntiles) {
      __syncthreads();  // every lane is done with this stage
      am_stage(g, stager, mine + b * stage, bars + b, j + 2, tile);
    }
  }
  acc = __dadd_rn(acc, tail);
  if (stager) out[row0 + lane] = __ddiv_rn(acc, static_cast<double>(n));
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

// A dependent chain of n __dadd_rn in one warp, timed with clock64: the
// card's DADD latency is (cycles(n2) - cycles(n1)) / (n2 - n1).
__global__ void dadd_probe_kernel(double x, int n, long long* cycles,
                                  double* out) {
  double a = x;
  const long long t0 = clock64();
#pragma unroll 16
  for (int i = 0; i < n; ++i) a = __dadd_rn(a, x);
  const long long t1 = clock64();
  out[threadIdx.x] = a;
  if (threadIdx.x == 0) *cycles = t1 - t0;
}

// How autocorr_serial runs one call shape.
struct AcPlan {
  int k;         // chains (lags) a thread
  int threads;   // a CTA: 32, 64 or 128 (plan_for)
  int groups;    // lag groups a segment: ceil(nlags / k)
  int tile;      // samples a tile, a multiple of 3 * kAcBlock
  int stages;    // 1: the whole segment is one tile; 2: a ring of two
  int width;     // samples of a window region: tile + span
  int stride;    // doubles between window regions: width, made 2 mod 4
  int segs;      // the most segments a CTA touches
  int64_t ctas;
  int64_t smem;  // bytes of dynamic shared memory a CTA
};

// The plan of a call at a CTA size and a shared-memory budget a CTA: the
// whole segment as one tile where it fits the budget, else two stages of
// the largest tile that fits.
AcPlan plan_at(int64_t nseg, int ns, int nlags, int k, int threads,
               int64_t budget) {
  AcPlan p{};
  p.k = k;
  p.threads = threads;
  p.groups = (nlags + k - 1) / k;
  const int64_t tasks = nseg * p.groups;
  p.ctas = (tasks + threads - 1) / threads;
  const int64_t touched = (threads - 1 + p.groups - 1) / p.groups + 1;
  p.segs = static_cast<int>(touched < nseg ? touched : nseg);
  // a window region reaches K + kAcBlock samples past its last lag group's
  // first lag, one more where its first lag was rounded down to even
  const int span =
      ((p.groups < threads ? p.groups : threads) * k + kAcBlock + 2) & ~1;
  const int step = 3 * kAcBlock;  // run_tile takes three blocks a turn
  // 16-byte aligned regions whose 16-byte halves map to odd bank quads
  auto stride_of = [](int width) { return width % 4 ? width : width + 2; };
  auto bytes = [&](int tile, int stages) {
    const int64_t head = tile + kAcBlock;
    return static_cast<int64_t>(stages) * 8 *
           (p.segs * stride_of(tile + span) + head);
  };
  p.tile = (ns + step - 1) / step * step;
  p.stages = 1;
  if (bytes(p.tile, 1) > budget) {
    p.stages = 2;
    // a stage holds about (segs + 1) tile doubles
    const int64_t fit =
        (budget / 16 - p.segs * (span + 2) - step) / (p.segs + 1) / step *
        step;
    if (fit < p.tile) p.tile = static_cast<int>(fit > step ? fit : step);
    while (p.tile > step && bytes(p.tile, 2) > budget) p.tile -= step;
  }
  p.width = p.tile + span;
  p.stride = stride_of(p.width);
  p.smem = bytes(p.tile, p.stages);
  return p;
}

// CTAs of 128 threads, or of 64 or 32 where 128 would leave an SM without
// two. Where the segments then fit whole in one stage, one-warp CTAs take
// them: they hold the fewest segments, so the most fit an SM at once and
// one CTA's copy overlaps another's chains. Longer segments run two stages,
// and CTAs of two or more warps take a smaller budget, so that three share
// an SM.
AcPlan plan_for(int64_t nseg, int ns, int nlags, int k, int sms) {
  const int64_t tasks = nseg * ((nlags + k - 1) / k);
  int threads = kAcThreads;
  while (threads > 32 &&
         (tasks + threads - 1) / threads < 2 * static_cast<int64_t>(sms)) {
    threads /= 2;
  }
  if (plan_at(nseg, ns, nlags, k, threads, kAcSmemBudget).stages == 1) {
    return plan_at(nseg, ns, nlags, k, 32, kAcSmemBudget);
  }
  return plan_at(nseg, ns, nlags, k, threads,
                 threads > 32 ? kAcSmemBudget3 : kAcSmemBudget);
}

// The chains (lags) a thread runs. A warp is one chain-stepping stream of
// its SM sub-partition; where a call has few chains for the card's 4 * sms
// sub-partitions, a step costs a dependent add and one chain a thread
// keeps the most warps in flight; where it has many, K chains a thread
// share each loaded sample among K products. The thresholds give the
// fastest forced choice at 15 of the 16 call shapes of a preset-7 fit
// chunk on an H100 (chip_smoke.py phase 10; PERF.md).
int choose_k(int64_t nseg, int nlags, int sms) {
  const double per_sp = static_cast<double>(nseg) * nlags / (4.0 * sms);
  if (nlags <= 2 || per_sp < 12.0) return 1;
  return per_sp < 64.0 ? 2 : 4;
}

constexpr int kMaxDevices = 64;

// Lets a kernel take up to `bytes` of dynamic shared memory (past the
// default 48 KB) on the current device, once a device (`done`).
cudaError_t allow_smem(const void* kernel, int bytes,
                       bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const bool cached = dev >= 0 && dev < kMaxDevices;
  if (cached && done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess && cached) done[dev] = true;
  return e;
}

template <int K>
cudaError_t allow_smem() {
  static bool done[kMaxDevices] = {};
  return allow_smem(reinterpret_cast<const void*>(autocorr_kernel<K>),
                    kAcSmemBudget, done);
}

template <int K>
int launch_autocorr(const AcPlan& p, const double* seg, double* ac,
                    int64_t nseg, int ns, int nlags, cudaStream_t stream) {
  const cudaError_t e = allow_smem<K>();
  if (e != cudaSuccess) return static_cast<int>(e);
  // TMA bulk copies need 16-byte aligned rows: an even ns from an aligned
  // base; other shapes stage with cp.async
  const int bulk =
      ns % 2 == 0 && reinterpret_cast<uintptr_t>(seg) % 16 == 0 ? 1 : 0;
  autocorr_kernel<K><<<static_cast<unsigned>(p.ctas), p.threads,
                       static_cast<size_t>(p.smem),
                       stream>>>(seg, ac, nseg, ns, nlags, p.groups, p.tile,
                                 p.width, p.stride, p.segs, bulk);
  return static_cast<int>(cudaGetLastError());
}

// The current device's SM count, read once a device (132 if unknown).
int sm_count() {
  static int sms[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) {
    return 132;
  }
  if (!sms[dev]) {
    cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  }
  return sms[dev] ? sms[dev] : 132;
}

bool valid_k(int k) { return k == 1 || k == 2 || k == 4; }

unsigned blocks_for(int64_t threads) {
  return static_cast<unsigned>((threads + kThreads - 1) / kThreads);
}

// How levinson_serial runs one call shape: one thread a segment
// (levinson_thread_kernel<maxp>, maxp the smallest of 4, 8, 16, 32 that
// holds the order) up to kLvThreadMax, else one warp a segment. CTAs of
// 128 threads (4 warps), made smaller while the call would fill fewer than
// two CTAs an SM (thread path) or one (warp path).
struct LvPlan {
  int warp;     // 1: one warp a segment
  int maxp;     // the thread path's template order (0 on the warp path)
  int threads;  // a CTA
  int segs;     // segments a CTA
  int64_t ctas;
  int64_t smem;  // dynamic shared bytes a CTA
};

LvPlan lv_plan(int64_t nseg, int order, int sms) {
  LvPlan p{};
  p.warp = order > kLvThreadMax ? 1 : 0;
  if (p.warp) {
    int warps = kLvWarps;
    while (warps > 1 && (nseg + warps - 1) / warps < sms) warps /= 2;
    p.threads = 32 * warps;
    p.segs = warps;
    p.smem = static_cast<int64_t>(warps) * sizeof(LvWarp);
  } else {
    p.maxp = order <= 4 ? 4 : order <= 8 ? 8 : order <= 16 ? 16 : 32;
    p.threads = kThreads;
    while (p.threads > 32 &&
           (nseg + p.threads - 1) / p.threads < 2 * static_cast<int64_t>(sms)) {
      p.threads /= 2;
    }
    p.segs = p.threads;
  }
  p.ctas = (nseg + p.segs - 1) / p.segs;
  return p;
}

const void* lv_kernel(const LvPlan& p) {
  switch (p.warp ? 0 : p.maxp) {
    case 0: return reinterpret_cast<const void*>(levinson_warp_kernel);
    case 4: return reinterpret_cast<const void*>(levinson_thread_kernel<4>);
    case 8: return reinterpret_cast<const void*>(levinson_thread_kernel<8>);
    case 16: return reinterpret_cast<const void*>(levinson_thread_kernel<16>);
    default: return reinterpret_cast<const void*>(levinson_thread_kernel<32>);
  }
}

// How serial_abs_mean runs one call shape. Rows a CTA (one warp): of 32,
// 16, ... 1, the count that puts the fewest rows on the busiest SM, the
// largest among ties (4,096 rows: 32 an SM at 32, 16 or 8 a CTA; 2,560
// rows: 20 an SM at 4 a CTA, against 32 at 16). The CTAs an SM
// takes at once share kAmSmemPerSm; a CTA's rows fit whole in one stage
// where that allows, else they run a ring of two stages of the largest
// tile that fits (at most kAmMaxTile, so the first tile lands soon).
struct AmPlan {
  int rows;    // rows a CTA
  int tile;    // samples a tile, a multiple of kAmStep
  int stages;  // 1 or 2
  int ntiles;  // tiles a row: cover [start - 1, n)
  int64_t ctas;
  int64_t smem;  // dynamic shared bytes a CTA
};

AmPlan am_plan(int64_t nrows, int start, int n, int sms) {
  AmPlan p{};
  // the fewest rows on the busiest SM; the most rows a CTA among ties
  int64_t best = -1;
  for (int rows = 32; rows >= 1; rows /= 2) {
    const int64_t ctas = (nrows + rows - 1) / rows;
    const int64_t load = rows * ((ctas + sms - 1) / sms);
    if (best < 0 || load < best) {
      best = load;
      p.rows = rows;
    }
  }
  p.ctas = (nrows + p.rows - 1) / p.rows;
  const int64_t per_sm = (p.ctas + sms - 1) / sms;
  const int64_t budget = std::min<int64_t>(kAmSmemPerSm / per_sm,
                                           kAmSmemBudget);
  const int span = n - start + 1;
  auto bytes = [&](int tile, int stages) {
    return 8 * (static_cast<int64_t>(stages) * p.rows * (tile + 2) + kAmStep);
  };
  const int whole = (span + kAmStep - 1) / kAmStep * kAmStep;
  if (whole <= kAmMaxTile && bytes(whole, 1) <= budget) {
    p.tile = whole;
  } else {
    const int64_t fit =
        ((budget / 8 - kAmStep) / (2 * p.rows) - 2) / kAmStep * kAmStep;
    p.tile = static_cast<int>(fit < kAmStep ? kAmStep : fit);
    if (p.tile > kAmMaxTile) p.tile = kAmMaxTile;
    if (p.tile > whole) p.tile = whole;
  }
  p.ntiles = (span + p.tile - 1) / p.tile;
  p.stages = p.ntiles > 1 ? 2 : 1;
  p.smem = bytes(p.tile, p.stages);
  return p;
}

cudaError_t allow_am_smem() {
  static bool done[kMaxDevices] = {};
  return allow_smem(reinterpret_cast<const void*>(abs_mean_kernel),
                    kAmSmemBudget, done);
}

}  // namespace

// All pointers are device pointers to contiguous float64 arrays (zc:
// bytes, 0 or 1). Each function launches on `stream`, does not synchronise, and
// returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// shapes it does not take).

// seg [nseg, ns] -> ac [nseg, nlags], 1 <= nlags <= ns; k chains a thread
// (1, 2 or 4), or 0 for choose_k's.
extern "C" int linne_autocorr_serial_k(const double* seg, double* ac,
                                       int64_t nseg, int ns, int nlags, int k,
                                       void* stream) {
  if (nseg < 1 || ns < 1 || nlags < 1 || nlags > ns ||
      (k != 0 && !valid_k(k))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int sms = sm_count();
  if (k == 0) k = choose_k(nseg, nlags, sms);
  const AcPlan p = plan_for(nseg, ns, nlags, k, sms);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: return launch_autocorr<1>(p, seg, ac, nseg, ns, nlags, st);
    case 2: return launch_autocorr<2>(p, seg, ac, nseg, ns, nlags, st);
    default: return launch_autocorr<4>(p, seg, ac, nseg, ns, nlags, st);
  }
}

extern "C" int linne_autocorr_serial(const double* seg, double* ac,
                                     int64_t nseg, int ns, int nlags,
                                     void* stream) {
  return linne_autocorr_serial_k(seg, ac, nseg, ns, nlags, 0, stream);
}

// The plan of one autocorr_serial call (k as above) into out[10]: k,
// threads a CTA, lag groups a segment, tile, stages, segments a CTA, CTAs,
// shared bytes a CTA, CTAs an SM holds at once (the occupancy calculator),
// SMs.
extern "C" int linne_autocorr_plan(int64_t nseg, int ns, int nlags, int k,
                                   int64_t* out) {
  if (nseg < 1 || ns < 1 || nlags < 1 || nlags > ns ||
      (k != 0 && !valid_k(k))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int sms = sm_count();
  if (k == 0) k = choose_k(nseg, nlags, sms);
  const AcPlan p = plan_for(nseg, ns, nlags, k, sms);
  int per_sm = 0;
  cudaError_t e = cudaSuccess;
  auto occupancy = [&](auto kernel, cudaError_t allowed) {
    e = allowed;
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, p.threads, static_cast<size_t>(p.smem));
    }
  };
  switch (k) {
    case 1: occupancy(autocorr_kernel<1>, allow_smem<1>()); break;
    case 2: occupancy(autocorr_kernel<2>, allow_smem<2>()); break;
    default: occupancy(autocorr_kernel<4>, allow_smem<4>()); break;
  }
  const int64_t v[10] = {p.k,    p.threads, p.groups, p.tile,  p.stages,
                         p.segs, p.ctas,    p.smem,   per_sm, sms};
  for (int i = 0; i < 10; ++i) out[i] = v[i];
  return static_cast<int>(e);
}

// cycles[0] <- the clock64 cycles of a chain of n dependent __dadd_rn in
// one warp (out [32] float64 keeps the chain live), launched on stream.
extern "C" int linne_dadd_probe(double x, int n, long long* cycles,
                                double* out, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  dadd_probe_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      x, n, cycles, out);
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
  const LvPlan p = lv_plan(nseg, order, sm_count());
  const auto st = static_cast<cudaStream_t>(stream);
  const auto grid = static_cast<unsigned>(p.ctas);
  if (p.warp) {
    levinson_warp_kernel<<<grid, p.threads, static_cast<size_t>(p.smem), st>>>(
        ac, coef, parcor, zc, nseg, order);
  } else {
    switch (p.maxp) {
      case 4:
        levinson_thread_kernel<4><<<grid, p.threads, 0, st>>>(
            ac, coef, parcor, zc, nseg, order);
        break;
      case 8:
        levinson_thread_kernel<8><<<grid, p.threads, 0, st>>>(
            ac, coef, parcor, zc, nseg, order);
        break;
      case 16:
        levinson_thread_kernel<16><<<grid, p.threads, 0, st>>>(
            ac, coef, parcor, zc, nseg, order);
        break;
      default:
        levinson_thread_kernel<32><<<grid, p.threads, 0, st>>>(
            ac, coef, parcor, zc, nseg, order);
        break;
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// The plan of one levinson_serial call into out[8]: warp path (1) or
// thread path (0), the thread path's template order, threads a CTA,
// segments a CTA, CTAs, dynamic shared bytes a CTA, CTAs an SM holds at
// once (the occupancy calculator), SMs.
extern "C" int linne_levinson_plan(int64_t nseg, int order, int64_t* out) {
  if (nseg < 1 || order < 1 || order > kMaxOrder) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int sms = sm_count();
  const LvPlan p = lv_plan(nseg, order, sms);
  int per_sm = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, lv_kernel(p), p.threads, static_cast<size_t>(p.smem));
  const int64_t v[8] = {p.warp, p.maxp, p.threads, p.segs,
                        p.ctas, p.smem, per_sm,    sms};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return static_cast<int>(e);
}

// x [nrows, row_len] -> out [nrows]; 0 <= start <= n <= row_len, n >= 1.
// x need only be 8-byte aligned.
extern "C" int linne_serial_abs_mean(const double* x, double* out,
                                     int64_t nrows, int row_len, int start,
                                     int n, void* stream) {
  if (nrows < 1 || n < 1 || n > row_len || start < 0 || start > n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t e = allow_am_smem();
  if (e != cudaSuccess) return static_cast<int>(e);
  const AmPlan p = am_plan(nrows, start, n, sm_count());
  abs_mean_kernel<<<static_cast<unsigned>(p.ctas), 32,
                    static_cast<size_t>(p.smem),
                    static_cast<cudaStream_t>(stream)>>>(
      x, out, nrows, row_len, start, n, p.rows, p.tile, p.ntiles);
  return static_cast<int>(cudaGetLastError());
}

// The plan of one serial_abs_mean call into out[8]: rows a CTA, tile,
// stages, tiles a row, CTAs, dynamic shared bytes a CTA, CTAs an SM holds
// at once (the occupancy calculator), SMs.
extern "C" int linne_abs_mean_plan(int64_t nrows, int start, int n,
                                   int64_t* out) {
  if (nrows < 1 || n < 1 || start < 0 || start > n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int sms = sm_count();
  const AmPlan p = am_plan(nrows, start, n, sms);
  int per_sm = 0;
  cudaError_t e = allow_am_smem();
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, abs_mean_kernel, 32, static_cast<size_t>(p.smem));
  }
  const int64_t v[8] = {p.rows, p.tile, p.stages, p.ntiles,
                        p.ctas, p.smem, per_sm,   sms};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return static_cast<int>(e);
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

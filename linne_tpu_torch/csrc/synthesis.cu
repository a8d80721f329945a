// Batched integer LPC synthesis: the decode recurrence of the LINNE codec.
//
// Replaces the TPU kernel linne_tpu/ops/synthesis.py:46 (_synth_kernel,
// Pallas). It computes what that kernel computes, row by row and
// independently:
//
//   y[t] = x[t]                                                  t < npu
//   y[t] = x[t] - ((half + sum_j c[j] * y[t-npu+j]) >> rshift)   t >= npu
//
// with int32 two's-complement wrap, an arithmetic shift, and
// half = rshift >= 1 ? 1 << (rshift-1) : 0 (corrupt streams may carry
// rshift = 0 in the 4-bit field). Rows with ns <= npu are copied.
// Reference: libs/linne_decoder/src/linne_lpc_synthesize.c:8-83.
//
// Bound. At (rows, ns, npu) the recurrence needs rows * (ns - npu) * npu
// int32 multiply-adds: 667.9 M at (516, 10240, 128), about 40 us at the
// H100's 64 IMAD/clk/SM x 132 SMs x 1.98 GHz. Reading x and writing y once
// (42.5 MB there) takes 12.7 us at 3.35 TB/s. So the bound is the IMAD
// issue rate. Beside it stands a latency floor: each row is a chain of
// ns - npu dependent steps (multiply-add, shift, subtract), which no
// amount of parallelism across rows shortens.
//
// Design: one warp per row, time in chunks of 32 steps, one output per
// lane, everything in registers. The per-step shift is the only
// nonlinearity; the sum wraps mod 2^32 and is kept in uint32, where
// addition is associative, so the sum for y[t] may be gathered in any
// order, term by term, as the outputs it needs appear. Output t of lane k
// in chunk c takes y[s] (lane i of chunk c - q) with lag
// d = t - s = 32q + k - i and weight c[npu - d], for 1 <= d <= npu, so
// q < NQ = (npu + 31) / 32 + 1. Each lane holds:
//   w[q][i]  the weight with which its output in chunk c + q takes lane
//            i's output of chunk c (zero where d is out of range): NQ * 32
//            registers, loaded once per row;
//   acc[q]   the running sum of its output in chunk c + q, started at half.
// Within a chunk, step i: every lane forms x - (acc[0] >> shift); lane i's
// value is final (all its terms have arrived), one __shfl_sync broadcasts
// it, and every lane adds w[q][i] * y_i to each acc[q]. After 32 steps the
// accumulators rotate by one chunk. The dependent chain per step is one
// shuffle, one IMAD, a shift and a subtract; the NQ - 1 other IMADs of the
// step lie off the chain. There is no shared memory and no barrier. x is
// read one chunk ahead (coalesced, 128 B a warp) and y written coalesced.
// Lanes past the row's end take part in every shuffle; their loads and
// stores are masked, and their values reach only outputs past the end.
// Chunks holding copied outputs (t < npu) take a variant with the copy
// select; the rest do not pay for it. 516 rows give 516 warps; the
// short-unit groups of the decode give thousands.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kMaxNpu = 128;
constexpr unsigned kFullMask = 0xffffffffu;

// One chunk of 32 steps; returns this lane's output. `copy`: this lane's
// output is a copied head sample (only read when kHead).
template <int NQ, bool kHead>
__device__ __forceinline__ uint32_t run_chunk(uint32_t (&acc)[NQ],
                                              const uint32_t (&w)[NQ][32],
                                              uint32_t xv, int shift,
                                              bool copy, uint32_t half) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    uint32_t v = xv - static_cast<uint32_t>(
                          static_cast<int32_t>(acc[0]) >> shift);
    if (kHead) v = copy ? xv : v;
    const uint32_t yi = __shfl_sync(kFullMask, v, i);
#pragma unroll
    for (int q = 0; q < NQ; ++q) acc[q] += w[q][i] * yi;
  }
  uint32_t y = xv - static_cast<uint32_t>(
                        static_cast<int32_t>(acc[0]) >> shift);
  if (kHead) y = copy ? xv : y;
#pragma unroll
  for (int q = 0; q + 1 < NQ; ++q) acc[q] = acc[q + 1];
  acc[NQ - 1] = half;
  return y;
}

template <int NQ>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    synth_rows_kernel(const int32_t* __restrict__ x,
                      const int32_t* __restrict__ coefs,
                      const int32_t* __restrict__ rshift,
                      int32_t* __restrict__ out, int rows, int ns, int npu) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  const int32_t* xr = x + static_cast<int64_t>(row) * ns;
  const int32_t* cr = coefs + static_cast<int64_t>(row) * npu;
  int32_t* yr = out + static_cast<int64_t>(row) * ns;

  // the wire field holds 0..15. Out of [0, 31] a C++ shift is undefined;
  // there the shift fills with the sign, as torch's `>>` does
  const int rs = __ldg(rshift + row);
  const int shift = (rs < 0 || rs > 31) ? 31 : rs;
  const uint32_t half = (rs >= 1 && rs <= 32) ? (1u << (rs - 1)) : 0u;

  uint32_t w[NQ][32];
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int d = 32 * q + lane - i;
      w[q][i] = (d >= 1 && d <= npu)
                    ? static_cast<uint32_t>(__ldg(cr + npu - d))
                    : 0u;
    }
  }
  uint32_t acc[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) acc[q] = half;

  const int nchunks = (ns + 31) / 32;
  const int head_chunks = min(nchunks, (npu + 31) / 32);
  int t = lane;
  uint32_t xv = t < ns ? static_cast<uint32_t>(__ldg(xr + t)) : 0u;
  for (int c = 0; c < nchunks; ++c, t += 32) {
    const uint32_t xnext =
        t + 32 < ns ? static_cast<uint32_t>(__ldg(xr + t + 32)) : 0u;
    const uint32_t y =
        c < head_chunks
            ? run_chunk<NQ, true>(acc, w, xv, shift, t < npu, half)
            : run_chunk<NQ, false>(acc, w, xv, shift, false, half);
    if (t < ns) yr[t] = static_cast<int32_t>(y);
    xv = xnext;
  }
}

template <int NQ>
cudaError_t launch(const int32_t* x, const int32_t* coefs,
                   const int32_t* rshift, int32_t* out, int rows, int ns,
                   int npu, cudaStream_t stream) {
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  synth_rows_kernel<NQ><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      x, coefs, rshift, out, rows, ns, npu);
  return cudaGetLastError();
}

}  // namespace

// x, out: [rows, ns] int32; coefs: [rows, npu] int32 (wire order: c[j] pairs
// with y[t-npu+j]), 1 <= npu <= 128; rshift: [rows] int32. All device
// pointers, contiguous. Launches on `stream` and does not synchronise.
// Returns cudaGetLastError() after the launch.
extern "C" int linne_synthesize_rows(const int32_t* x, const int32_t* coefs,
                                     const int32_t* rshift, int32_t* out,
                                     int rows, int ns, int npu, void* stream) {
  if (npu < 1 || npu > kMaxNpu || rows < 1 || ns < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch ((npu + 31) / 32 + 1) {
    case 2: err = launch<2>(x, coefs, rshift, out, rows, ns, npu, s); break;
    case 3: err = launch<3>(x, coefs, rshift, out, rows, ns, npu, s); break;
    case 4: err = launch<4>(x, coefs, rshift, out, rows, ns, npu, s); break;
    default: err = launch<5>(x, coefs, rshift, out, rows, ns, npu, s); break;
  }
  return static_cast<int>(err);
}

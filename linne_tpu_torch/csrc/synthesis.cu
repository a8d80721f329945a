// Batched integer LPC synthesis: the decode recurrence of the LINNE codec.
//
// Replaces the TPU kernel linne_tpu/ops/synthesis.py:_synth_kernel (Pallas).
// It computes what that kernel computes, row by row and independently:
//
//   y[t] = x[t]                                            for t < npu
//   y[t] = x[t] - ((half + sum_j c[j] * y[t-npu+j]) >> rshift)   t >= npu
//
// with int32 two's-complement wrap, an arithmetic shift, and
// half = rshift >= 1 ? 1 << (rshift-1) : 0 (corrupt streams may carry
// rshift = 0 in the 4-bit field). Rows with ns <= npu are copied.
// Reference: libs/linne_decoder/src/linne_lpc_synthesize.c:8-83.
//
// Design, correctness first: one thread per row walks t serially. The
// window of the last npu outputs is read back from the row's own output,
// which that thread wrote (L1-resident: npu <= 128 values). The dot product
// accumulates in uint32, where overflow is defined to wrap; the sum is cast
// to int32 only for the arithmetic shift (signed overflow is undefined in
// C++ and nvcc has no -fwrapv). Unsigned addition is associative mod 2^32,
// so four independent accumulators shorten the add chain without changing
// a bit of the result.
//
// What bounds it on the card: the serial dependence chain per row (step t+1
// needs y[t]), and the row count. A small corpus gives a few hundred rows,
// i.e. a few warps on a handful of the 132 SMs; the rest of the card idles.
// The TPU's VMEM budget and time chunking do not apply here: rows are taken
// whole. Later work: a time-major [ns, rows] layout for coalesced loads,
// register windows templated on npu, and more rows in flight per SM.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreadsPerBlock = 32;

__global__ void synth_rows_kernel(const int32_t* __restrict__ x,
                                  const int32_t* __restrict__ coefs,
                                  const int32_t* __restrict__ rshift,
                                  int32_t* __restrict__ out, int rows, int ns,
                                  int npu) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const int32_t* xr = x + static_cast<int64_t>(r) * ns;
  const int32_t* cr = coefs + static_cast<int64_t>(r) * npu;
  int32_t* yr = out + static_cast<int64_t>(r) * ns;

  const int head = npu < ns ? npu : ns;
  for (int t = 0; t < head; ++t) yr[t] = xr[t];
  if (ns <= npu) return;

  // the wire field holds 0..15. Out of [0, 31] a C++ shift is undefined;
  // there the shift fills with the sign, as torch's `>>` does
  const int rs = rshift[r];
  const int shift = (rs < 0 || rs > 31) ? 31 : rs;
  const uint32_t half = (rs >= 1 && rs <= 32) ? (1u << (rs - 1)) : 0u;

  for (int t = npu; t < ns; ++t) {
    const int32_t* w = yr + (t - npu);
    uint32_t a0 = half, a1 = 0u, a2 = 0u, a3 = 0u;
    int j = 0;
    for (; j + 4 <= npu; j += 4) {
      a0 += static_cast<uint32_t>(__ldg(cr + j)) * static_cast<uint32_t>(w[j]);
      a1 += static_cast<uint32_t>(__ldg(cr + j + 1)) *
            static_cast<uint32_t>(w[j + 1]);
      a2 += static_cast<uint32_t>(__ldg(cr + j + 2)) *
            static_cast<uint32_t>(w[j + 2]);
      a3 += static_cast<uint32_t>(__ldg(cr + j + 3)) *
            static_cast<uint32_t>(w[j + 3]);
    }
    for (; j < npu; ++j) {
      a0 += static_cast<uint32_t>(__ldg(cr + j)) * static_cast<uint32_t>(w[j]);
    }
    const int32_t pred = static_cast<int32_t>(a0 + a1 + a2 + a3) >> shift;
    yr[t] = static_cast<int32_t>(static_cast<uint32_t>(__ldg(xr + t)) -
                                 static_cast<uint32_t>(pred));
  }
}

}  // namespace

// x, out: [rows, ns] int32; coefs: [rows, npu] int32 (wire order: c[j] pairs
// with y[t-npu+j]); rshift: [rows] int32. All device pointers, contiguous.
// Launches on `stream` and does not synchronise. Returns cudaGetLastError().
extern "C" int linne_synthesize_rows(const int32_t* x, const int32_t* coefs,
                                     const int32_t* rshift, int32_t* out,
                                     int rows, int ns, int npu, void* stream) {
  const int blocks = (rows + kThreadsPerBlock - 1) / kThreadsPerBlock;
  synth_rows_kernel<<<blocks, kThreadsPerBlock, 0,
                      static_cast<cudaStream_t>(stream)>>>(x, coefs, rshift,
                                                           out, rows, ns, npu);
  return static_cast<int>(cudaGetLastError());
}

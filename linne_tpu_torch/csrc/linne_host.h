/* linne_host — C ABI of the native host runtime (linne_host.so).
 *
 * This is the embeddable analog of the reference's decode-only `linnedec`
 * static-library target (reference: CMakeLists.txt:5-29): the whole-stream
 * decoder, payload pack/unpack, CRC and the integer filters are exported
 * with C linkage and no dependency beyond libc/libpthread, so a non-Python
 * host can link the .so directly. The Python package binds the same symbols
 * via ctypes (linne_tpu_torch/native.py; this is the port's own copy of
 * native/linne_host.h).
 *
 * Build:  g++ -O3 -fwrapv -fPIC -shared -std=c++17 -pthread \
 *             linne_host.cpp -o linne_host.so
 *
 * All multi-channel arrays are row-major [nch][...] as annotated. Huffman
 * tree arrays (node0/node1/root) and the per-preset code tables come from
 * the preset's 256-entry coefficient frequency table; see
 * linne_tpu_torch/format/huffman.py for the builder and docs/FORMAT.md for the
 * wire layout.
 */
#ifndef LINNE_HOST_H
#define LINNE_HOST_H

#include <stdint.h>

/* Symbol visibility: building the Windows DLL needs an explicit export
 * attribute (MSVC exports nothing by default); everywhere else the default
 * visibility already exposes the C symbols. */
#if defined(_WIN32) && defined(LINNE_HOST_BUILD_DLL)
#define LINNE_HOST_API __declspec(dllexport)
#else
#define LINNE_HOST_API
#endif

#ifdef __cplusplus
extern "C" {
#endif

/* CRC16-IBM (poly 0xA001 reflected), init 0 — the per-block checksum. */
LINNE_HOST_API uint16_t linne_crc16(const uint8_t* data, uint64_t size);

/* Serialize one COMPRESS block payload (preemph state, unit/rshift/Huffman
 * coefficient side info, partitioned recursive-Rice residual planes).
 * Returns payload byte size, or -1 if out_cap is too small. */
LINNE_HOST_API int64_t linne_pack_compress_payload(
    const int32_t* residuals,     /* [nch][n] */
    const int32_t* coefs,         /* [nch][total_order] */
    const int32_t* log2_units,    /* [nch][nlayers] */
    const int32_t* rshifts,       /* [nch][nlayers] */
    const int32_t* preemph_prev,  /* [nch][nstages] */
    const int32_t* preemph_coef,  /* [nch][nstages] */
    const int32_t* porder,        /* [nch] */
    const int32_t* k2s,           /* [nch][max_parts] */
    const uint32_t* huff_codes,   /* [256] */
    const uint8_t* huff_lens,     /* [256] */
    int32_t nch, int32_t n, int32_t bps, int32_t nlayers,
    const int32_t* orders, int32_t nstages, int32_t max_parts,
    uint8_t* out, int64_t out_cap);

/* Parse one COMPRESS block payload. Returns consumed (byte-aligned) byte
 * count, or -1 on malformed input. */
LINNE_HOST_API int64_t linne_unpack_compress_payload(
    const uint8_t* data, int64_t size,
    const int16_t* huff_node0, const int16_t* huff_node1, int32_t huff_root,
    int32_t num_symbols,
    int32_t nch, int32_t n, int32_t bps, int32_t nlayers,
    const int32_t* orders, int32_t nstages,
    int32_t* residuals,     /* [nch][n] */
    int32_t* coefs,         /* [nch][total_order] */
    int32_t* log2_units,    /* [nch][nlayers] */
    int32_t* rshifts,       /* [nch][nlayers] */
    int32_t* preemph_prev,  /* [nch][nstages] */
    int32_t* preemph_coef); /* [nch][nstages] */

/* Reconstruct one block in place from residual planes: reversed layer
 * cascade (unit IIR synthesis), two-stage de-emphasis, MS->LR. */
LINNE_HOST_API void linne_synthesize_block(
    int32_t* chdata,              /* [nch][n] residuals -> samples */
    const int32_t* coefs, const int32_t* log2_units, const int32_t* rshifts,
    const int32_t* preemph_prev, const int32_t* preemph_coef,
    int32_t nch, int32_t n, int32_t nlayers, const int32_t* orders,
    int32_t nstages, int32_t ms);

/* Standalone fused multi-stage de-emphasis of one channel plane. */
LINNE_HOST_API void linne_deemphasis(int32_t* data, int32_t n, const int32_t* prevs,
                      const int32_t* coefs, int32_t nstages);

/* Pooled-decoder finishing for one stream: for each of nb blocks, copy its
 * nch consecutive synthesized rows (row0[b] .. row0[b]+nch-1, each rowlen
 * int32 wide, first n valid) from the device download matrix into
 * out[ch][starts[b] : +n], then run the fused de-emphasis + MS inverse in
 * place. pprev/pcoef are [nb][nch][nstages]; out is [nch][ch_stride]. */
LINNE_HOST_API void linne_finish_rows(
    const int32_t* rows, int64_t rowlen, const int32_t* row0,
    const int64_t* starts, int32_t n, const int32_t* pprev,
    const int32_t* pcoef, int32_t nb, int32_t nch, int32_t nstages,
    int32_t ms, int32_t* out, int64_t ch_stride);

/* Whole-stream decode: scan all block frames of a .lnn body (bytes after
 * the 30-byte global header), verify sync/CRC, entropy-decode and
 * synthesize every block, threaded over independent blocks (num_threads
 * <= 0 selects hardware concurrency). Output planes are out[ch][sample].
 * Returns 0 ok, -1 malformed stream, -2 CRC mismatch, -3 corrupt payload. */
LINNE_HOST_API int32_t linne_decode_stream(
    const uint8_t* data, int64_t size, int64_t total_samples,
    const int16_t* huff_node0, const int16_t* huff_node1, int32_t huff_root,
    int32_t num_symbols,
    int32_t nch, int32_t bps, int32_t nlayers, const int32_t* orders,
    int32_t nstages, int32_t ms, int32_t check_crc, int32_t num_threads,
    int32_t* out);

/* Encoder-side integer predict cascade for one layer (residual[t] =
 * data[t] + (rounded >> rshift) prediction), unit-split semantics of
 * linne_lpc_predict.c. */
LINNE_HOST_API void linne_predict_layer(const int32_t* data, int32_t* residual, int32_t n,
                         const int32_t* coef, int32_t order, int32_t rshift,
                         int32_t num_units);

/* Exact float64 analysis helpers: strict left-to-right accumulation per
 * output (fp contraction disabled at the function level), bit-identical to
 * the ExactEncoder's numpy oracles — see linne_host.cpp for the chain
 * semantics. autocorr: out[lag] = serial sum_i x[i]*x[i+lag], lag < nlags.
 * unit_predict: out[t] = (include_base ? x[t] : 0) + serial
 * sum_j x[t-npu+j]*params[unit(t)*npu+j] with +0.0 left context; requires
 * num_units | n. */
LINNE_HOST_API void linne_exact_autocorr(const double* x, int64_t n, int32_t nlags,
                          double* out);
LINNE_HOST_API void linne_exact_unit_predict(const double* x, int64_t n,
                              const double* params, int32_t num_units,
                              int32_t npu, int32_t include_base,
                              double* out);

/* IRLS normal equations + in-place Cholesky solve with the exact
 * accumulation order of the encoder's auxiliary-function method. obj
 * receives the raw (undivided) serial residual sum; cholesky returns 0 or
 * -1 on a non-positive pivot. */
LINNE_HOST_API void linne_exact_af_normal(const double* data, int64_t n, const double* a,
                           int32_t order, double eps, double* r_mat,
                           double* r_vec, double* obj);
LINNE_HOST_API int32_t linne_exact_cholesky_solve(double* A, const double* b, int32_t dim,
                                   double* x);

/* Trainer layer backward (exact chains of the oracle): writes dparams and
 * accumulates the input gradient into grad_inout (which arrives holding
 * the incoming gradient; dout is a read-only copy of it). Requires
 * num_units | n. */
LINNE_HOST_API void linne_exact_layer_backward(const double* din, const double* dout,
                                double* grad_inout, const double* params,
                                int32_t num_units, int32_t npu, int64_t n,
                                double* dparams);

/* Whole-trainer loop (exact arithmetic of the encoder's -l learning):
 * full-batch momentum gradient descent on the L1 loss of the layer
 * cascade. params/dparams/momentum are the per-layer arrays concatenated
 * (momentum zeroed by the caller); work holds (num_layers + 3) * n
 * doubles of scratch. Requires num_units[l] | n for every layer. */
LINNE_HOST_API void linne_exact_train(
    const double* data, int64_t n, int32_t num_layers,
    const int32_t* num_units, const int32_t* num_params, double* params,
    double* dparams, double* momentum, int32_t max_iterations,
    double learning_rate, double loss_epsilon, double alpha,
    double flt_max, double* work);

/* Whole-layer model fit (exact arithmetic of the encoder's per-layer
 * fitting loop): power-of-two unit-count search scored by mean |residual|,
 * then a final per-unit refit with num_af_iterations IRLS steps. weights
 * holds the caller's Welch windows for every level, concatenated (level l
 * at weights + w_off[l], length n / level_units[l]); level_units must list
 * the valid unit counts in ascending order (powers of two dividing both
 * num_params and n). buffer/auto_corr/lpc_coef/parcor_coef are the
 * caller's long-lived analysis scratch (mutated with the encoder's exact
 * write extents; stale contents are semantically significant). Writes
 * params_out[0:num_params] (per-unit time-reversed taps) and
 * pred_scratch[0:n]; returns the chosen unit count, or -1 when the
 * arguments fall outside the supported envelope (num_params > 258, empty
 * level list, non-dividing level, or an IRLS refit with no residual
 * samples). */
LINNE_HOST_API int32_t linne_exact_fit_layer(
    const double* data, int64_t n, int32_t num_params,
    int32_t num_af_iterations, double regular_term, double flt_eps,
    double flt_max, const double* weights, const int64_t* w_off,
    const int32_t* level_units, int32_t num_levels, double* buffer,
    double* auto_corr, double* lpc_coef, double* parcor_coef,
    double* params_out, double* pred_scratch);

/* Whole-network ridge sweep (exact arithmetic of the encoder's full model
 * search for one block-channel): for each ridge candidate, fit every layer
 * (linne_exact_fit_layer) and forward the residual, scoring the serial mean
 * |residual|; the winner is refit with num_af_iterations. Level tables are
 * the per-layer tables concatenated: layer l's levels occupy
 * level_units[level_off[l] .. +level_cnt[l]) and w_off entries are absolute
 * offsets into weights. Writes params_out (per-layer taps concatenated),
 * units_out[num_layers], data_buffer[0:n] (final residual) and
 * pred_scratch[0:n]. Returns 0, or -1 on an unsupported envelope — callers
 * must precheck (num_params[l] in (0, 258] and n > num_params[l] for every
 * layer, level tables built like the encoder's) because a mid-sweep bail
 * leaves the analysis scratch part-mutated. */
LINNE_HOST_API int32_t linne_exact_fit_network(
    const double* data, int64_t n, int32_t num_layers,
    const int32_t* num_params, int32_t num_af_iterations,
    const double* ridge_terms, int32_t num_ridges, double flt_eps,
    double flt_max, const double* weights, const int64_t* w_off,
    const int32_t* level_units, const int32_t* level_off,
    const int32_t* level_cnt, double* buffer, double* auto_corr,
    double* lpc_coef, double* parcor_coef, double* params_out,
    int32_t* units_out, double* data_buffer, double* pred_scratch);

/* Partitioned-Rice parameter search (exact arithmetic of the encoder's
 * search): writes the winning per-partition k2 into k2s[0 : 1 << porder]
 * (caller provides room for 1024) and returns the winning porder. */
LINNE_HOST_API int32_t linne_exact_rice_search(const int32_t* data, int64_t n,
                                int32_t* k2s);

/* Levinson-Durbin with the oracle's exact op order: writes
 * lpc_coef[0:order] and parcor_coef[0:order]; the degenerate |ac[0]| <
 * flt_eps path zeroes [0:order+1] of both. order must be <= 258 (no-op
 * beyond). */
LINNE_HOST_API void linne_exact_levinson(const double* ac, int32_t order, double flt_eps,
                          double* lpc_coef, double* parcor_coef);

/* Unpack a W-bit two's-complement sample plane (the slim device->host
 * residual transfer) into int32 samples; rows are independent.
 *
 * n must be a multiple of the plane's packing group size g = 32/gcd(width,32)
 * — the sample count whose bits fill whole words (callers in this repo pass
 * roundup(n, g)). A sample straddling a word boundary reads the next word,
 * which is in-bounds only under that alignment. Requires a little-endian
 * host (compile-time enforced). */
LINNE_HOST_API void linne_unpack_bits(const uint32_t* words, int64_t nrows,
                       int32_t words_per_row, int32_t width, int32_t n,
                       int32_t* out);

#ifdef __cplusplus
}
#endif

#endif /* LINNE_HOST_H */

// linne_host — native host runtime of linne_tpu_torch.
//
// The card owns the numeric analysis/synthesis; this library owns the serial,
// data-dependent host stage: bit-level entropy packing/unpacking of .lnn
// block payloads, CRC16 framing, and the integer synthesis cascade for the
// streaming/CLI decode path.
//
// Wire format identical to the reference codec (see SURVEY.md §2); the
// implementation is independent and word-oriented: a 64-bit staging
// accumulator bit writer/reader (the reference uses a 32-bit one,
// libs/bit_stream/include/bit_stream.h:240-351), run-length emission via
// whole-byte stores, and LUT-free tree-walk Huffman decode fed from arrays
// supplied by the Python layer.
//
// Exposed as a plain C ABI for ctypes — and for non-Python embedders via
// linne_host.h (the decode-only `linnedec` deployment analog); including
// the header here makes any declaration/definition drift a compile error.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#if defined(__AVX512F__) || (defined(__PCLMUL__) && defined(__SSE2__))
#include <immintrin.h>
#endif

#include "linne_host.h"

// ---- compiler portability shims (MSVC lacks the GCC builtins) -------------
#if defined(_MSC_VER) && !defined(__clang__)
#include <intrin.h>
#include <stdlib.h>
static inline uint64_t linne_bswap64(uint64_t x) { return _byteswap_uint64(x); }
static inline int linne_clz64(uint64_t x) {       // x != 0
    unsigned long i; _BitScanReverse64(&i, x); return 63 - (int)i;
}
static inline int linne_clz32(uint32_t x) {       // x != 0
    unsigned long i; _BitScanReverse(&i, x); return 31 - (int)i;
}
#else
static inline uint64_t linne_bswap64(uint64_t x) { return __builtin_bswap64(x); }
static inline int linne_clz64(uint64_t x) { return __builtin_clzll(x); }
static inline int linne_clz32(uint32_t x) { return __builtin_clz(x); }
#endif

// The bulk CRC16 fold, the 8-byte bit-writer commit / bit-reader refill, and
// the unpack fast paths all memcpy words and index bytes via shifts assuming
// byte 0 is the low-order lane. Guard the assumption so a big-endian embedder
// gets a compile error instead of silently wrong CRCs/payloads.
#if defined(__BYTE_ORDER__) && (__BYTE_ORDER__ != __ORDER_LITTLE_ENDIAN__)
#error "linne_host requires a little-endian host (see word-staging paths)"
#endif

namespace {

// ---------------------------------------------------------------- bit writer

struct BitWriter {
    uint8_t* buf;
    int64_t cap;
    int64_t pos = 0;       // bytes committed
    uint64_t acc = 0;      // pending bits, left-aligned count in nbits
    int nbits = 0;
    bool overflow = false;

    inline void commit() {
        if (nbits >= 8 && pos + 8 <= cap) {
            // bulk store: left-align the pending bits and write all whole
            // bytes in one 8-byte store (the extra trailing byte is
            // overwritten by the next commit or by flush_byte_align)
            int nbytes = nbits >> 3;
            uint64_t w = linne_bswap64(acc << (64 - nbits));
            std::memcpy(buf + pos, &w, 8);
            pos += nbytes;
            nbits -= nbytes * 8;
            acc &= (nbits ? ((1ULL << nbits) - 1) : 0ULL);
            return;
        }
        while (nbits >= 8) {
            if (pos >= cap) { overflow = true; return; }
            nbits -= 8;
            buf[pos++] = static_cast<uint8_t>(acc >> nbits);
        }
        acc &= (nbits ? ((1ULL << nbits) - 1) : 0ULL);
    }

    inline void put(uint32_t val, int n) {
        if (n == 0 || overflow) return;  // overflowed writes are void anyway
        if (nbits + n > 64) commit();  // keeps nbits < 8
        acc = (acc << n) | (val & (n >= 32 ? 0xFFFFFFFFu : ((1u << n) - 1)));
        nbits += n;
        if (nbits >= 56) commit();
    }

    inline void put_zeros(int64_t n) {
        // flush pending to byte boundary mentally: emit in chunks; bail as
        // soon as the buffer overflows (a corrupt-input giant run would
        // otherwise spin millions of no-op puts before pack returns -1)
        while (n >= 32) {
            if (overflow) return;
            put(0, 32);
            n -= 32;
        }
        if (n > 0) put(0, static_cast<int>(n));
    }

    inline void flush_byte_align() {
        commit();
        if (nbits > 0) {
            if (pos >= cap) { overflow = true; return; }
            buf[pos++] = static_cast<uint8_t>(acc << (8 - nbits));
            acc = 0;
            nbits = 0;
        }
    }
};

// ---------------------------------------------------------------- bit reader

struct BitReader {
    const uint8_t* buf;
    int64_t size;
    int64_t pos = 0;
    uint64_t acc = 0;
    int nbits = 0;
    bool error = false;

    inline void fill() {
        if (pos + 8 <= size) {
            // bulk top-up: one unaligned big-endian load instead of up to
            // seven byte appends (the Rice decode loop refills constantly)
            uint64_t w;
            std::memcpy(&w, buf + pos, 8);
            w = linne_bswap64(w);
            int take = (63 - nbits) >> 3;  // bytes, keeps nbits <= 63
            if (take == 0) return;         // guards the shift below
            acc = (acc << (take * 8)) | (w >> (64 - take * 8));
            nbits += take * 8;
            pos += take;
            return;
        }
        while (nbits <= 56 && pos < size) {
            acc = (acc << 8) | buf[pos++];
            nbits += 8;
        }
    }

    inline uint32_t get(int n) {
        if (n == 0) return 0;
        if (nbits < n) fill();
        if (nbits < n) { error = true; return 0; }
        nbits -= n;
        uint32_t v = static_cast<uint32_t>(
            (acc >> nbits) & (n >= 32 ? 0xFFFFFFFFu : ((1ULL << n) - 1)));
        acc &= (nbits ? ((1ULL << nbits) - 1) : 0ULL);
        return v;
    }

    inline uint32_t get_zero_run() {
        uint32_t run = 0;
        for (;;) {
            if (nbits == 0) {
                fill();
                if (nbits == 0) { error = true; return run; }
            }
            if (acc == 0) {
                run += nbits;
                nbits = 0;
                continue;
            }
            // highest set bit position within nbits
            int top = 63 - linne_clz64(acc);
            run += static_cast<uint32_t>(nbits - 1 - top);
            nbits = top;
            acc &= (nbits ? ((1ULL << nbits) - 1) : 0ULL);
            return run;
        }
    }

    inline int64_t aligned_pos() const {
        return pos - (nbits >> 3);
    }

    // absolute bit offset of the next unread bit (acc always holds the
    // last nbits consumed-but-unread bits, so this is exact)
    inline int64_t bit_position() const { return pos * 8 - nbits; }

    // reposition to an absolute bit offset (re-primes the staging register)
    inline void seek_bit(int64_t bitpos) {
        pos = bitpos >> 3;
        int off = static_cast<int>(bitpos & 7);
        if (off && pos < size) {
            acc = buf[pos] & ((1u << (8 - off)) - 1);
            nbits = 8 - off;
            pos++;
        } else {
            acc = 0;
            nbits = 0;
        }
    }
};

// -------------------------------------------------------------- primitives

inline uint32_t zigzag_enc(int32_t v) {
    return (static_cast<uint32_t>(v) << 1) ^ static_cast<uint32_t>(v >> 31);
}

inline int32_t zigzag_dec(uint32_t u) {
    return static_cast<int32_t>(u >> 1) ^ -static_cast<int32_t>(u & 1);
}

inline void gamma_put(BitWriter& w, uint32_t val) {
    if (val == 0) { w.put(1, 1); return; }
    int ndigit = 32 - linne_clz32(val + 1);
    w.put_zeros(ndigit - 1);
    w.put(val + 1, ndigit);
}

inline uint32_t gamma_get(BitReader& r) {
    uint32_t run = r.get_zero_run();
    if (run == 0) return 0;
    if (run >= 32) {  // corrupt: every gamma code in this format fits 32 bits
        r.error = true;
        return 0;
    }
    uint32_t rest = r.get(static_cast<int>(run));
    return (1u << run) + rest - 1;
}

inline void rice_put(BitWriter& w, uint32_t k1, uint32_t k2, uint32_t uval) {
    if (k1 >= 32) {
        // k2=31 (reachable from the unclamped MLE on extreme residuals):
        // every uval is "small"; emit the terminator and 32 payload bits
        w.put(1, 1);
        w.put(uval, 32);
        return;
    }
    uint32_t k1pow = 1u << k1;
    if (uval < k1pow) {
        w.put((1u << k1) | uval, static_cast<int>(k1 + 1));
    } else {
        uval -= k1pow;
        w.put_zeros(1 + (uval >> k2));
        w.put(1, 1);
        w.put(uval & ((1u << k2) - 1), static_cast<int>(k2));
    }
}

inline uint32_t rice_get(BitReader& r, uint32_t k1, uint32_t k2) {
    // fast path: resolve the whole symbol (q zeros + terminator + k payload
    // bits) from one left-aligned 64-bit window — one refill check and one
    // extraction instead of three bit-op calls with their own refills
    if (r.nbits < 48) r.fill();
    if (r.nbits > 0) {
        uint64_t win = r.acc << (64 - r.nbits);
        if (win != 0) {
            int q = linne_clz64(win);
            uint32_t k = (q == 0) ? k1 : k2;
            int need = q + 1 + static_cast<int>(k);
            if (need <= r.nbits) {
                r.nbits -= need;
                uint32_t payload = static_cast<uint32_t>(
                    (r.acc >> r.nbits) & ((k >= 32) ? ~0u
                                          : ((1ULL << k) - 1)));
                r.acc &= (r.nbits ? ((1ULL << r.nbits) - 1) : 0ULL);
                if (q == 0) return payload;
                // wrap-safe: k1 can be 32 (k2=31 wire value), 1u<<32 is UB
                return payload + static_cast<uint32_t>(1ull << k1)
                    + ((static_cast<uint32_t>(q) - 1) << k2);
            }
        }
    }
    uint32_t quot = r.get_zero_run();
    if (quot == 0) return r.get(static_cast<int>(k1));
    return r.get(static_cast<int>(k2)) + static_cast<uint32_t>(1ull << k1)
        + ((quot - 1) << k2);
}

// Bulk Rice(k2+1, k2) symbol decode for one partition: tracks an absolute
// bit position and drains a left-aligned 57+-bit window loaded with ONE
// unaligned load+bswap — typically 3-5 symbols per load, so the serial
// chain is clz -> shift in registers with no staging-register bookkeeping
// or refill branches. A symbol whose zero run spans the window (transient
// outlier) is resolved inline by walking the run across loads, so one
// outlier no longer drops the partition remainder to the generic path.
// Decodes zigzag-mapped residuals straight into out[]; returns the number
// of symbols done (the caller finishes the remainder — only near the
// buffer end — through the generic path). Leaves r positioned after the
// last decoded symbol.
inline int rice_run(BitReader& r, uint32_t k2, int nsmpl, int32_t* out) {
    int64_t bitpos = r.bit_position();
    const uint8_t* buf = r.buf;
    const int64_t max_byte = r.size - 8;  // 8-byte loads stay in bounds
    const uint32_t k1 = k2 + 1;
    const uint32_t k1pow = static_cast<uint32_t>(1ull << k1);  // k1 <= 32
    int s = 0;
    while (s < nsmpl) {
        int64_t byte = bitpos >> 3;
        if (byte > max_byte) break;  // near buffer end: generic path
        uint64_t w;
        std::memcpy(&w, buf + byte, 8);
        int shift = static_cast<int>(bitpos & 7);
        w = linne_bswap64(w) << shift;
        int avail = 64 - shift;  // every loaded bit past the shift is valid
        int used = 0;
        while (s < nsmpl) {
            int q = linne_clz64(w | 1);
            uint32_t k = q ? k2 : k1;
            int need = q + 1 + static_cast<int>(k);
            // strict <: a symbol exactly filling the window would shift by
            // 64 below (UB); it falls to the positional walk instead
            if (used + need >= avail) break;
            // ((.. >> (63-k)) >> 1) == >> (64-k) without the k==0 UB
            uint32_t payload = static_cast<uint32_t>(
                ((w << (q + 1)) >> (63 - static_cast<int>(k))) >> 1);
            uint32_t uval = q ? payload + k1pow
                                    + ((static_cast<uint32_t>(q) - 1) << k2)
                              : payload;
            out[s++] = zigzag_dec(uval);
            w <<= need;
            used += need;
        }
        bitpos += used;
        if (used == 0) {
            // zero run spans the whole window: walk it across loads, then
            // read terminator + payload positionally
            int64_t p = bitpos;
            int64_t q = 0;
            for (;;) {
                int64_t b2 = p >> 3;
                if (b2 > max_byte) { r.seek_bit(bitpos); return s; }
                uint64_t w2;
                std::memcpy(&w2, buf + b2, 8);
                int sh2 = static_cast<int>(p & 7);
                w2 = linne_bswap64(w2) << sh2;
                int av2 = 64 - sh2;
                if (w2 == 0) { q += av2; p += av2; continue; }
                int z = linne_clz64(w2);
                q += z;
                p += z + 1;
                break;
            }
            // branch on the WRAPPED run like the generic path (rice_get via
            // get_zero_run wraps at 2^32), so pathological corrupt-stream
            // runs decode identically on both paths
            uint32_t qw = static_cast<uint32_t>(q);
            uint32_t k = qw ? k2 : k1;
            uint32_t payload = 0;
            if (k) {
                int64_t b3 = p >> 3;
                if (b3 > max_byte) { r.seek_bit(bitpos); return s; }
                uint64_t w3;
                std::memcpy(&w3, buf + b3, 8);
                w3 = linne_bswap64(w3) << (p & 7);
                payload = static_cast<uint32_t>(w3 >> (64 - k));
            }
            p += k;
            uint32_t uval = qw ? payload + k1pow + ((qw - 1) << k2)
                               : payload;
            out[s++] = zigzag_dec(uval);
            bitpos = p;
        }
    }
    r.seek_bit(bitpos);
    return s;
}

const int kPreemphShift = 5;
const int kLog2NumUnitsBits = 3;  // wire width of the log2(num_units) field
const int kMaxNumChannels = 8;    // format limit (linne.h MAX_NUM_CHANNELS)

// Core compress-payload unpack with an arbitrary per-channel residual
// stride, so the stream decoder can write straight into the output planes.
// Returns consumed byte count (byte-aligned), or -1 on error.
int64_t unpack_compress_core(
    const uint8_t* data, int64_t size,
    const int16_t* huff_node0, const int16_t* huff_node1, int32_t huff_root,
    int32_t num_symbols,
    int32_t nch, int32_t n, int32_t bps, int32_t nlayers,
    const int32_t* orders, int32_t nstages,
    int32_t* residuals, int64_t res_stride,
    int32_t* coefs, int32_t* log2_units, int32_t* rshifts,
    int32_t* preemph_prev, int32_t* preemph_coef) {
    BitReader r{data, size};
    int32_t total_order = 0;
    for (int l = 0; l < nlayers; l++) total_order += orders[l];

    for (int ch = 0; ch < nch; ch++) {
        for (int s = 0; s < nstages; s++) {
            preemph_prev[ch * nstages + s] = zigzag_dec(r.get(bps + 1));
            preemph_coef[ch * nstages + s] =
                static_cast<int32_t>(r.get(kPreemphShift - 1));
        }
    }
    for (int ch = 0; ch < nch; ch++) {
        int32_t* ccoef = coefs + ch * total_order;
        for (int l = 0; l < nlayers; l++) {
            log2_units[ch * nlayers + l] =
                static_cast<int32_t>(r.get(kLog2NumUnitsBits));
            rshifts[ch * nlayers + l] = static_cast<int32_t>(r.get(4));
            for (int i = 0; i < orders[l]; i++) {
                int node = huff_root;
                while (node >= num_symbols) {
                    node = r.get(1) ? huff_node1[node] : huff_node0[node];
                }
                *ccoef++ = zigzag_dec(static_cast<uint32_t>(node));
            }
        }
    }
    for (int ch = 0; ch < nch; ch++) {
        int32_t* res = residuals + ch * res_stride;
        int po = static_cast<int>(r.get(10));
        if (po > 10) return -1;
        int nparts = 1 << po;
        int nsmpl = n >> po;
        // valid streams only use porders that divide n (the encoder's
        // max_porder rule); a corrupt po would otherwise leave residual
        // tails unwritten yet "succeed"
        if ((static_cast<int64_t>(nsmpl) << po) != n) return -1;
        int k2 = 0;
        for (int part = 0; part < nparts; part++) {
            if (part == 0) {
                k2 = static_cast<int>(r.get(5));
            } else {
                k2 += zigzag_dec(gamma_get(r));
            }
            // corrupt streams (decoded without CRC checking) must not drive
            // undefined shifts; the 5-bit wire field allows k2 up to 31
            // (the decode paths handle k1 = 32 with wrap-safe shifts)
            if (k2 < 0 || k2 > 31) return -1;
            uint32_t uk1 = static_cast<uint32_t>(k2 + 1);
            uint32_t uk2 = static_cast<uint32_t>(k2);
            int32_t* pres = res + part * nsmpl;
            int done = rice_run(r, uk2, nsmpl, pres);
            for (int s = done; s < nsmpl; s++) {
                pres[s] = zigzag_dec(rice_get(r, uk1, uk2));
            }
            if (r.error) return -1;
        }
    }
    return r.aligned_pos();
}

}  // namespace

extern "C" {

// ------------------------------------------------------------------- crc16

namespace {
struct Crc16Table {
    // slicing-by-8: t[0] is the classic reflected table, t[k][b] advances
    // byte b by k additional zero bytes, so 8 input bytes fold per step
    uint16_t t[8][256];
    Crc16Table() {
        for (uint32_t b = 0; b < 256; b++) {
            uint16_t crc = static_cast<uint16_t>(b);
            for (int i = 0; i < 8; i++)
                crc = (crc & 1) ? static_cast<uint16_t>((crc >> 1) ^ 0xA001)
                                : static_cast<uint16_t>(crc >> 1);
            t[0][b] = crc;
        }
        for (int k = 1; k < 8; k++)
            for (uint32_t b = 0; b < 256; b++)
                t[k][b] = static_cast<uint16_t>(
                    (t[k - 1][b] >> 8) ^ t[0][t[k - 1][b] & 0xFF]);
    }
};
}  // namespace

namespace {
uint16_t crc16_table_path(const uint8_t* data, uint64_t size, uint16_t crc) {
    // C++11 magic-static init: thread-safe for the decode worker pool
    static const Crc16Table table;
    while (size >= 8) {
        uint64_t w;
        std::memcpy(&w, data, 8);
        w ^= crc;  // reflected CRC: fold into the low-order input bytes
        crc = static_cast<uint16_t>(
            table.t[7][w & 0xFF] ^ table.t[6][(w >> 8) & 0xFF] ^
            table.t[5][(w >> 16) & 0xFF] ^ table.t[4][(w >> 24) & 0xFF] ^
            table.t[3][(w >> 32) & 0xFF] ^ table.t[2][(w >> 40) & 0xFF] ^
            table.t[1][(w >> 48) & 0xFF] ^ table.t[0][(w >> 56) & 0xFF]);
        data += 8;
        size -= 8;
    }
    for (uint64_t i = 0; i < size; i++)
        crc = static_cast<uint16_t>(
            (crc >> 8) ^ table.t[0][(crc ^ data[i]) & 0xFF]);
    return crc;
}
}  // namespace

#if defined(__PCLMUL__) && defined(__SSE2__)
namespace {
// 128-bit carry-less folding for the reflected CRC-16 (poly 0x8005).
// Layout: a 16-byte little-endian block holds message bit j at int bit j,
// i.e. polynomial degree 127-j; the LOW qword carries the HIGH degrees.
// Advancing state F by n zero bits: Poly_F*x^n = Hd*x^(n+64) + Ld*x^n with
// each x^m reduced mod P to a 16-bit constant C; in the reflected domain
//   F' = clmul(F_lo, reflect16(C_{n+64}) << 49)
//      ^ clmul(F_hi, reflect16(C_n)     << 49) ^ D.
// A constant whose reflect16 has bit 15 set does not fit <<49 in 64 bits;
// those folds use <<48 operands and shift the xor of the products left by
// one ((a<<1)^(b<<1) == (a^b)<<1). Five lanes (80-byte stride, fold
// distance 640) are the smallest count whose BOTH hot constants fit <<49.
// The finisher feeds the residual 16-byte state + tail to the table path —
// the state IS the residual message, so no Barrett reduction is needed.
// Constants and the exact structure are derived+verified against the table
// CRC in simulation; equality is regression-tested
// across sizes and against streams in the format/golden suites.
inline __m128i crc_shl128_1(__m128i x) {
    __m128i carry = _mm_srli_epi64(_mm_slli_si128(x, 8), 63);
    return _mm_or_si128(_mm_slli_epi64(x, 1), carry);
}

inline __m128i crc_fold(__m128i F, __m128i D, __m128i K) {
    __m128i t1 = _mm_clmulepi64_si128(F, K, 0x00);  // F_lo * K_lo
    __m128i t2 = _mm_clmulepi64_si128(F, K, 0x11);  // F_hi * K_hi
    return _mm_xor_si128(_mm_xor_si128(t1, t2), D);
}

// fold with <<48 operands: products need one extra left shift
inline __m128i crc_fold48(__m128i F, __m128i K) {
    __m128i t1 = _mm_clmulepi64_si128(F, K, 0x00);
    __m128i t2 = _mm_clmulepi64_si128(F, K, 0x11);
    return crc_shl128_1(_mm_xor_si128(t1, t2));
}
}  // namespace

uint16_t linne_crc16(const uint8_t* data, uint64_t size) {
    if (size < 96) return crc16_table_path(data, size, 0);
    // hot fold constants (distance 640): reflect16(x^704 mod P) = 0x37fc,
    // reflect16(x^640 mod P) = 0x7840 — both fit <<49
    const __m128i KH = _mm_set_epi64x(0x7840LL << 49, 0x37fcLL << 49);
    __m128i F0 = _mm_loadu_si128(reinterpret_cast<const __m128i*>(data));
    __m128i F1 = _mm_loadu_si128(reinterpret_cast<const __m128i*>(data + 16));
    __m128i F2 = _mm_loadu_si128(reinterpret_cast<const __m128i*>(data + 32));
    __m128i F3 = _mm_loadu_si128(reinterpret_cast<const __m128i*>(data + 48));
    __m128i F4 = _mm_loadu_si128(reinterpret_cast<const __m128i*>(data + 64));
    uint64_t pos = 80;
    while (pos + 80 <= size) {
        const uint8_t* p = data + pos;
        F0 = crc_fold(F0, _mm_loadu_si128(
                              reinterpret_cast<const __m128i*>(p)), KH);
        F1 = crc_fold(F1, _mm_loadu_si128(
                              reinterpret_cast<const __m128i*>(p + 16)), KH);
        F2 = crc_fold(F2, _mm_loadu_si128(
                              reinterpret_cast<const __m128i*>(p + 32)), KH);
        F3 = crc_fold(F3, _mm_loadu_si128(
                              reinterpret_cast<const __m128i*>(p + 48)), KH);
        F4 = crc_fold(F4, _mm_loadu_si128(
                              reinterpret_cast<const __m128i*>(p + 64)), KH);
        pos += 80;
    }
    // combine the 5 lanes (lane i sits (4-i)*128 bits ahead of lane 4);
    // reflect16 pairs: (x^576,x^512)=(0x6228,0xe081),
    // (x^448,x^384)=(0x5552,0xf649), (x^320,x^256)=(0xc4c9,0x8801) via
    // <<48 folds (a member of each pair has bit 15 set);
    // (x^192,x^128)=(0x6668,0x6080) fits <<49
    const __m128i K0 = _mm_set_epi64x(0xe081LL << 48, 0x6228LL << 48);
    const __m128i K1 = _mm_set_epi64x(0xf649LL << 48, 0x5552LL << 48);
    const __m128i K2 = _mm_set_epi64x(0x8801LL << 48, 0xc4c9LL << 48);
    const __m128i K3 = _mm_set_epi64x(0x6080LL << 49, 0x6668LL << 49);
    __m128i G = _mm_xor_si128(
        _mm_xor_si128(crc_fold48(F0, K0), crc_fold48(F1, K1)),
        _mm_xor_si128(crc_fold48(F2, K2),
                      crc_fold(F3, F4, K3)));
    alignas(16) uint8_t resid[16];
    _mm_store_si128(reinterpret_cast<__m128i*>(resid), G);
    uint16_t crc = crc16_table_path(resid, 16, 0);
    return crc16_table_path(data + pos, size - pos, crc);
}
#else
uint16_t linne_crc16(const uint8_t* data, uint64_t size) {
    return crc16_table_path(data, size, 0);
}
#endif

// ------------------------------------------------------- payload packing

// Returns payload byte size, or -1 on buffer overflow.
int64_t linne_pack_compress_payload(
    const int32_t* residuals,     // [nch][n]
    const int32_t* coefs,         // [nch][total_order]
    const int32_t* log2_units,    // [nch][nlayers]
    const int32_t* rshifts,       // [nch][nlayers]
    const int32_t* preemph_prev,  // [nch][nstages]
    const int32_t* preemph_coef,  // [nch][nstages]
    const int32_t* porder,        // [nch]
    const int32_t* k2s,           // [nch][max_parts]
    const uint32_t* huff_codes,   // [256]
    const uint8_t* huff_lens,     // [256]
    int32_t nch, int32_t n, int32_t bps, int32_t nlayers,
    const int32_t* orders, int32_t nstages, int32_t max_parts,
    uint8_t* out, int64_t out_cap) {
    BitWriter w{out, out_cap};
    int32_t total_order = 0;
    for (int l = 0; l < nlayers; l++) total_order += orders[l];

    for (int ch = 0; ch < nch; ch++) {
        for (int s = 0; s < nstages; s++) {
            w.put(zigzag_enc(preemph_prev[ch * nstages + s]), bps + 1);
            w.put(static_cast<uint32_t>(preemph_coef[ch * nstages + s]),
                  kPreemphShift - 1);
        }
    }
    for (int ch = 0; ch < nch; ch++) {
        const int32_t* ccoef = coefs + ch * total_order;
        for (int l = 0; l < nlayers; l++) {
            w.put(static_cast<uint32_t>(log2_units[ch * nlayers + l]),
                  kLog2NumUnitsBits);
            w.put(static_cast<uint32_t>(rshifts[ch * nlayers + l]), 4);
            for (int i = 0; i < orders[l]; i++) {
                uint32_t sym = zigzag_enc(*ccoef++) & 0xFF;
                w.put(huff_codes[sym], huff_lens[sym]);
            }
        }
    }
    for (int ch = 0; ch < nch; ch++) {
        const int32_t* res = residuals + static_cast<int64_t>(ch) * n;
        int po = porder[ch];
        w.put(static_cast<uint32_t>(po), 10);
        int nparts = 1 << po;
        int nsmpl = n >> po;
        int prevk2 = 0;
        const int32_t* kk = k2s + static_cast<int64_t>(ch) * max_parts;
        for (int part = 0; part < nparts; part++) {
            int k2 = kk[part];
            if (part == 0) {
                w.put(static_cast<uint32_t>(k2), 5);
            } else {
                gamma_put(w, zigzag_enc(k2 - prevk2));
            }
            prevk2 = k2;
            uint32_t uk1 = static_cast<uint32_t>(k2 + 1);
            uint32_t uk2 = static_cast<uint32_t>(k2);
            for (int s = 0; s < nsmpl; s++) {
                rice_put(w, uk1, uk2, zigzag_enc(res[part * nsmpl + s]));
            }
            if (w.overflow) return -1;
        }
    }
    w.flush_byte_align();
    if (w.overflow) return -1;
    return w.pos;
}

// ------------------------------------------------------ payload unpacking

// Returns consumed byte count (byte-aligned), or -1 on error.
int64_t linne_unpack_compress_payload(
    const uint8_t* data, int64_t size,
    const int16_t* huff_node0, const int16_t* huff_node1, int32_t huff_root,
    int32_t num_symbols,
    int32_t nch, int32_t n, int32_t bps, int32_t nlayers,
    const int32_t* orders, int32_t nstages,
    int32_t* residuals,     // [nch][n]
    int32_t* coefs,         // [nch][total_order]
    int32_t* log2_units,    // [nch][nlayers]
    int32_t* rshifts,       // [nch][nlayers]
    int32_t* preemph_prev,  // [nch][nstages]
    int32_t* preemph_coef)  // [nch][nstages]
{
    return unpack_compress_core(
        data, size, huff_node0, huff_node1, huff_root, num_symbols,
        nch, n, bps, nlayers, orders, nstages,
        residuals, static_cast<int64_t>(n),
        coefs, log2_units, rshifts, preemph_prev, preemph_coef);
}

// ------------------------------------------------- integer synthesis path

}  // extern "C" — C++ helpers below (templates can't take C linkage)

// One unit-split IIR layer, in place (wire semantics of
// linne_lpc_synthesize.c:8-83; implementation is chunk-split, see below).

// Straight recurrence — correctness oracle and fallback for odd orders.
static void synth_unit_plain(int32_t* data, int n, const int32_t* coef,
                             int npu, int rshift) {
    // corrupt streams may carry rshift=0 (4-bit field); 1<<-1 is UB
    int32_t half = rshift >= 1 ? (1 << (rshift - 1)) : 0;
    for (int t = 0; t < n - npu; t++) {
        int32_t pred = half;
        for (int j = 0; j < npu; j++) pred += coef[j] * data[t + j];
        data[t + npu] -= pred >> rshift;
    }
}

// Small-order recurrence with the tap window held in registers: the plain
// loop's critical chain runs through a store->load forward of the previous
// output (measured ~5x slower at npu=4); rotating the window in registers
// leaves just imul+add+sar+sub on the chain.
template <int NPU>
static void synth_unit_reg(int32_t* data, int n, const int32_t* coef,
                           int rshift) {
    // corrupt streams may carry rshift=0 (4-bit field); 1<<-1 is UB
    int32_t half = rshift >= 1 ? (1 << (rshift - 1)) : 0;
    int32_t c[NPU], d[NPU];
    for (int j = 0; j < NPU; j++) {
        c[j] = coef[j];
        d[j] = data[j];
    }
    int npred = n - NPU;
    for (int t = 0; t < npred; t++) {
        int32_t pred = half;
        for (int j = 0; j < NPU; j++) pred += c[j] * d[j];
        int32_t y = data[t + NPU] - (pred >> rshift);
        data[t + NPU] = y;
        for (int j = 0; j < NPU - 1; j++) d[j] = d[j + 1];
        d[NPU - 1] = y;
    }
}

// W independent equal-shape recurrences interleaved in one loop: each
// stream's serial chain (imul+add+sar+sub, ~7 cycles/sample) hides the
// others' latency, and the j-outer/w-inner accumulation vectorizes across
// the W lanes. Per 504 block-channels of 10240 samples vs the single-stream
// reg kernel (synthbench5, best of 5, per-stream rshift): npu=1 19.3->3.3 ms
// (W=6), npu=2 19.5->6.4 ms (W=4), npu=4 24.9->9.6 ms (W=2), npu=8
// 32.1->15.4 ms (W=2), npu=16 61->31.2 ms (W=2).
template <int NPU, int W>
static void synth_unit_regW(int32_t** data, int n, const int32_t** coef,
                            const int32_t* rshift) {
    int32_t half[W], c[W][NPU], d[W][NPU];
    for (int w = 0; w < W; w++) {
        // corrupt streams may carry rshift=0 (4-bit field); 1<<-1 is UB
        half[w] = rshift[w] >= 1 ? (1 << (rshift[w] - 1)) : 0;
        for (int j = 0; j < NPU; j++) {
            c[w][j] = coef[w][j];
            d[w][j] = data[w][j];
        }
    }
    int npred = n - NPU;
    for (int t = 0; t < npred; t++) {
        int32_t p[W];
        for (int w = 0; w < W; w++) p[w] = half[w];
        for (int j = 0; j < NPU; j++)
            for (int w = 0; w < W; w++) p[w] += c[w][j] * d[w][j];
        for (int w = 0; w < W; w++) {
            int32_t y = data[w][t + NPU] - (p[w] >> rshift[w]);
            data[w][t + NPU] = y;
            for (int j = 0; j < NPU - 1; j++) d[w][j] = d[w][j + 1];
            d[w][NPU - 1] = y;
        }
    }
}

// Large-order recurrence, requires npu >= K: each K-output chunk first
// accumulates FULL-length dots against the stale (pre-chunk) window — a
// fixed-shape convolution the autovectorizer turns into clean K-lane
// multiply-adds with no horizontal reductions — then serially corrects each
// output for the taps that landed on in-chunk outputs, using the in-register
// deltas. Bit-exact: int32 multiplication distributes over wrapped addition
// under -fwrapv, so stale-dot + coef*delta == fresh dot mod 2^32.
template <int K>
static void synth_unit_stale(int32_t* data, int n, const int32_t* coef,
                             int npu, int rshift) {
    // corrupt streams may carry rshift=0 (4-bit field); 1<<-1 is UB
    int32_t half = rshift >= 1 ? (1 << (rshift - 1)) : 0;
    int npred = n - npu;
    int t = 0;
    int32_t pre[K], delta[K];
    for (; t + K <= npred; t += K) {
        for (int m = 0; m < K; m++) pre[m] = 0;
        const int32_t* base = data + t;
        for (int j = 0; j < npu; j++) {
            int32_t cj = coef[j];
            const int32_t* dj = base + j;
            for (int m = 0; m < K; m++) pre[m] += cj * dj[m];
        }
        int32_t* y = data + t + npu;
        for (int m = 0; m < K; m++) {
            int32_t s = pre[m] + half;
            // outputs i<m sit at taps j=npu-m+i (>=0 because m<=K<=npu)
            const int32_t* ct = coef + npu - m;
            for (int i = 0; i < m; i++) s += ct[i] * delta[i];
            int32_t dlt = -(s >> rshift);
            delta[m] = dlt;
            y[m] += dlt;
        }
    }
    for (; t < npred; t++) {
        int32_t pred = half;
        for (int j = 0; j < npu; j++) pred += coef[j] * data[t + j];
        data[t + npu] -= pred >> rshift;
    }
}

// Two independent large-order recurrences interleaved, K=16 chunks: the
// stale dots are load/port-bound and the 16-step in-chunk correction chain
// is latency-bound, so running a second stream in the same loop hides each
// stream's correction chain under the other's work. Interleaved A/B per 500
// block-channels of 10240 samples vs synth_unit_stale<16> singles (ab128,
// on the host CPU): npu=32 43.6->26.3 ms (1.65x), npu=64 52.9->37.0 (1.43x),
// npu=128 65.6->53.4 (1.23x). Bit-exact: identical per-stream operation
// set; int32 wrap arithmetic is order-independent.
static void synth_unit_stale_x2(int32_t* dA, int32_t* dB, int n,
                                const int32_t* cA, const int32_t* cB,
                                int npu, int rsA, int rsB) {
#if defined(__AVX512F__)
    int32_t halfA = rsA >= 1 ? (1 << (rsA - 1)) : 0;
    int32_t halfB = rsB >= 1 ? (1 << (rsB - 1)) : 0;
    int npred = n - npu;
    int t = 0;
    alignas(64) int32_t preA[16], preB[16];
    int32_t deltaA[16], deltaB[16];
    for (; t + 16 <= npred; t += 16) {
        const int32_t* baseA = dA + t;
        const int32_t* baseB = dB + t;
        __m512i a0 = _mm512_setzero_si512();
        __m512i b0 = _mm512_setzero_si512();
        for (int j = 0; j < npu; j++) {
            __m512i va = _mm512_loadu_si512(
                reinterpret_cast<const void*>(baseA + j));
            __m512i vb = _mm512_loadu_si512(
                reinterpret_cast<const void*>(baseB + j));
            a0 = _mm512_add_epi32(
                a0, _mm512_mullo_epi32(va, _mm512_set1_epi32(cA[j])));
            b0 = _mm512_add_epi32(
                b0, _mm512_mullo_epi32(vb, _mm512_set1_epi32(cB[j])));
        }
        _mm512_store_si512(preA, a0);
        _mm512_store_si512(preB, b0);
        int32_t* yA = dA + t + npu;
        int32_t* yB = dB + t + npu;
        for (int m = 0; m < 16; m++) {
            int32_t sA = preA[m] + halfA;
            int32_t sB = preB[m] + halfB;
            const int32_t* ctA = cA + npu - m;
            const int32_t* ctB = cB + npu - m;
            for (int i = 0; i < m; i++) {
                sA += ctA[i] * deltaA[i];
                sB += ctB[i] * deltaB[i];
            }
            int32_t dltA = -(sA >> rsA);
            int32_t dltB = -(sB >> rsB);
            deltaA[m] = dltA;
            deltaB[m] = dltB;
            yA[m] += dltA;
            yB[m] += dltB;
        }
    }
    for (; t < npred; t++) {
        int32_t pA = halfA, pB = halfB;
        for (int j = 0; j < npu; j++) {
            pA += cA[j] * dA[t + j];
            pB += cB[j] * dB[t + j];
        }
        dA[t + npu] -= pA >> rsA;
        dB[t + npu] -= pB >> rsB;
    }
#else
    synth_unit_stale<16>(dA, n, cA, npu, rsA);
    synth_unit_stale<16>(dB, n, cB, npu, rsB);
#endif
}

// valid streams always have pow-2 npu (orders 2..128, pow-2 units);
// each shape gets the kernel that measured fastest (bench2/bench3, r3)
static void synth_unit_single(int32_t* d, int ns, const int32_t* c, int npu,
                              int rshift) {
    switch (npu) {
        case 1: synth_unit_reg<1>(d, ns, c, rshift); break;
        case 2: synth_unit_reg<2>(d, ns, c, rshift); break;
        case 4: synth_unit_reg<4>(d, ns, c, rshift); break;
        case 8: synth_unit_reg<8>(d, ns, c, rshift); break;
        case 16: synth_unit_reg<16>(d, ns, c, rshift); break;
        default:
            if (npu >= 32) synth_unit_stale<16>(d, ns, c, npu, rshift);
            else synth_unit_plain(d, ns, c, npu, rshift);
    }
}

// Drain cnt same-shape independent unit recurrences in the widest lane
// count that measured fastest for this npu, narrower for the remainder.
static void synth_units_group(int32_t** d, const int32_t** c,
                              const int32_t* r, int cnt, int ns, int npu) {
    int i = 0;
    switch (npu) {
        case 1:
            for (; i + 6 <= cnt; i += 6)
                synth_unit_regW<1, 6>(d + i, ns, c + i, r + i);
            for (; i + 4 <= cnt; i += 4)
                synth_unit_regW<1, 4>(d + i, ns, c + i, r + i);
            for (; i + 2 <= cnt; i += 2)
                synth_unit_regW<1, 2>(d + i, ns, c + i, r + i);
            break;
        case 2:
            for (; i + 4 <= cnt; i += 4)
                synth_unit_regW<2, 4>(d + i, ns, c + i, r + i);
            for (; i + 2 <= cnt; i += 2)
                synth_unit_regW<2, 2>(d + i, ns, c + i, r + i);
            break;
        case 4:
            for (; i + 2 <= cnt; i += 2)
                synth_unit_regW<4, 2>(d + i, ns, c + i, r + i);
            break;
        case 8:
            for (; i + 2 <= cnt; i += 2)
                synth_unit_regW<8, 2>(d + i, ns, c + i, r + i);
            break;
        case 16:
            for (; i + 2 <= cnt; i += 2)
                synth_unit_regW<16, 2>(d + i, ns, c + i, r + i);
            break;
        default:
            if (npu >= 32)
                for (; i + 2 <= cnt; i += 2)
                    synth_unit_stale_x2(d[i], d[i + 1], ns, c[i], c[i + 1],
                                        npu, r[i], r[i + 1]);
            break;  // npu == 0 / odd remainder: singles
    }
    for (; i < cnt; i++) synth_unit_single(d[i], ns, c[i], npu, r[i]);
}

// One independent channel plane for the layer cascade: its data, its coef
// base, and its per-layer unit-split/rshift side info. Channels from
// DIFFERENT blocks qualify too — every block carries its full model state,
// so all planes in a collection are mutually independent until de-emphasis.
struct SynthChan {
    int32_t* data;
    const int32_t* coefs;      // [total_order]
    const int32_t* log2u;      // [nlayers]
    const int32_t* rsh;        // [nlayers]
};

// The reversed layer cascade over any set of independent channel planes of
// equal length (wire semantics of linne_lpc_synthesize.c:8-83, applied
// per channel). Units within a layer are independent by construction, so
// every unit recurrence of every collected channel that picked the same
// unit split (identical npu AND unit length) drains through the
// interleaved kernels — covering the u>=2 within-channel case, the stereo
// same-split case, and (when the caller collects a window of blocks)
// cross-block pairing that mops up the odd singles.
static void synth_layers_multi(const SynthChan* chans, int nchans, int n,
                               int nlayers, const int32_t* orders) {
    // kCap bounds one DRAIN batch, not the collection: a 4-block window at
    // the format maximum (8 ch x 128 units) produces 4x kCap tasks and
    // relies on the cnt==kCap mid-loop drain below — do not remove it
    constexpr int kCap = kMaxNumChannels * 128;
    int32_t* task_d[kCap];
    const int32_t* task_c[kCap];
    int32_t task_r[kCap];
    for (int l = nlayers - 1; l >= 0; l--) {
        int32_t coef_off = 0;
        for (int k = 0; k < l; k++) coef_off += orders[k];
        int order = orders[l];
        for (int lu = 0; lu < (1 << kLog2NumUnitsBits); lu++) {
            int num_units = 1 << lu;
            int npu = order / num_units;
            int ns = n / num_units;
            if (ns <= npu) continue;
            int cnt = 0;
            for (int c = 0; c < nchans; c++) {
                if (chans[c].log2u[l] != lu) continue;
                int rshift = chans[c].rsh[l];
                int32_t* dch = chans[c].data;
                const int32_t* cch = chans[c].coefs + coef_off;
                for (int u = 0; u < num_units; u++) {
                    if (cnt == kCap) {
                        synth_units_group(task_d, task_c, task_r, cnt, ns,
                                          npu);
                        cnt = 0;
                    }
                    task_d[cnt] = dch + u * ns;
                    task_c[cnt] = cch + u * npu;
                    task_r[cnt] = rshift;
                    cnt++;
                }
            }
            if (cnt) synth_units_group(task_d, task_c, task_r, cnt, ns, npu);
        }
    }
}

// De-emphasis + optional MS->LR for one block (runs after the cascade).
static void deemph_ms_block(int32_t* chdata, int64_t stride,
                            const int32_t* preemph_prev,
                            const int32_t* preemph_coef, int32_t nch,
                            int32_t n, int32_t nstages, int32_t ms) {
    for (int ch = 0; ch < nch; ch++) {
        int32_t* d = chdata + ch * stride;
        // de-emphasis: stage (nstages-1) inverse then ... stage 0 inverse.
        // The two-stage case (the format's constant) fuses into one pass:
        // stage s at time t needs only stage s+1's output at t plus its own
        // t-1 state, and coef==0 reduces to the identity, so the fused loop
        // is sample-exact with the skipped-pass semantics while halving
        // memory traffic (and the two multiply chains overlap).
        if (nstages == 2) {
            int32_t c1 = preemph_coef[ch * nstages + 1];
            int32_t c0 = preemph_coef[ch * nstages];
            if (c0 != 0 || c1 != 0) {
                int32_t p1 = preemph_prev[ch * nstages + 1];
                int32_t p0 = preemph_prev[ch * nstages];
                for (int t = 0; t < n; t++) {
                    p1 = d[t] + ((p1 * c1) >> kPreemphShift);
                    p0 = p1 + ((p0 * c0) >> kPreemphShift);
                    d[t] = p0;
                }
            }
        } else {
            for (int s = nstages - 1; s >= 0; s--) {
                int32_t coef = preemph_coef[ch * nstages + s];
                if (coef == 0) continue;
                int32_t prev = preemph_prev[ch * nstages + s];
                for (int t = 0; t < n; t++) {
                    prev = d[t] + ((prev * coef) >> kPreemphShift);
                    d[t] = prev;
                }
            }
        }
    }
    if (ms && nch >= 2) {
        int32_t* m = chdata;
        int32_t* s = chdata + stride;
        for (int t = 0; t < n; t++) {
            m[t] -= s[t] >> 1;
            s[t] += m[t];
        }
    }
}

// Fill SynthChan descriptors for one block's channels.
static void fill_synth_chans(SynthChan* out, int32_t* chdata, int64_t stride,
                             const int32_t* coefs, const int32_t* log2_units,
                             const int32_t* rshifts, int nch, int nlayers,
                             int32_t total_order) {
    for (int ch = 0; ch < nch; ch++) {
        out[ch].data = chdata + ch * stride;
        out[ch].coefs = coefs + ch * total_order;
        out[ch].log2u = log2_units + ch * nlayers;
        out[ch].rsh = rshifts + ch * nlayers;
    }
}

extern "C" {

// Full block reconstruction: reversed layer cascade + two-stage de-emphasis
// + optional MS->LR. Channel ch's plane is chdata + ch*stride, length n
// (residuals in, samples out).
static void synthesize_block_core(
    int32_t* chdata, int64_t stride, const int32_t* coefs,
    const int32_t* log2_units, const int32_t* rshifts,
    const int32_t* preemph_prev, const int32_t* preemph_coef, int32_t nch,
    int32_t n, int32_t nlayers, const int32_t* orders, int32_t nstages,
    int32_t ms) {
    int32_t total_order = 0;
    for (int l = 0; l < nlayers; l++) total_order += orders[l];
    // layer-major so same-shape unit recurrences pair across channels too;
    // chunk channel counts beyond the format maximum (embedder safety)
    SynthChan chans[kMaxNumChannels];
    for (int c0 = 0; c0 < nch; c0 += kMaxNumChannels) {
        int cn = nch - c0 < kMaxNumChannels ? nch - c0 : kMaxNumChannels;
        fill_synth_chans(chans, chdata + c0 * stride, stride,
                         coefs + c0 * total_order,
                         log2_units + c0 * nlayers, rshifts + c0 * nlayers,
                         cn, nlayers, total_order);
        synth_layers_multi(chans, cn, n, nlayers, orders);
    }
    deemph_ms_block(chdata, stride, preemph_prev, preemph_coef, nch, n,
                    nstages, ms);
}

void linne_synthesize_block(
    int32_t* chdata, const int32_t* coefs, const int32_t* log2_units,
    const int32_t* rshifts, const int32_t* preemph_prev,
    const int32_t* preemph_coef, int32_t nch, int32_t n, int32_t nlayers,
    const int32_t* orders, int32_t nstages, int32_t ms) {
    synthesize_block_core(chdata, static_cast<int64_t>(n), coefs, log2_units,
                          rshifts, preemph_prev, preemph_coef, nch, n,
                          nlayers, orders, nstages, ms);
}

// Standalone two-stage de-emphasis (for a batch decoder that
// runs layer synthesis on the device and the short integer recursions here).
void linne_deemphasis(int32_t* data, int32_t n, const int32_t* prevs,
                      const int32_t* coefs, int32_t nstages) {
    for (int s = nstages - 1; s >= 0; s--) {
        int32_t coef = coefs[s];
        if (coef == 0) continue;
        int32_t prev = prevs[s];
        for (int t = 0; t < n; t++) {
            prev = data[t] + ((prev * coef) >> kPreemphShift);
            data[t] = prev;
        }
    }
}

// Pooled-decoder finishing: scatter the synthesized rows of one stream's
// blocks (nch consecutive rows per block in the device download matrix)
// into the stream's output planes, then de-emphasis + MS inverse per block
// — ONE GIL-released call per (stream, block-length group). The pooled
// device decode path's host stage must stay off the Python interpreter to
// survive core contention (codec/tpu_decoder.py): per-(block, channel)
// round trips each pay a GIL scheduler wait when another thread loads the
// core.
void linne_finish_rows(const int32_t* rows, int64_t rowlen,
                       const int32_t* row0, const int64_t* starts, int32_t n,
                       const int32_t* pprev, const int32_t* pcoef,
                       int32_t nb, int32_t nch, int32_t nstages, int32_t ms,
                       int32_t* out, int64_t ch_stride) {
    for (int b = 0; b < nb; b++) {
        int32_t* dst = out + starts[b];
        for (int c = 0; c < nch; c++) {
            std::memcpy(dst + c * ch_stride,
                        rows + (static_cast<int64_t>(row0[b]) + c) * rowlen,
                        static_cast<size_t>(n) * sizeof(int32_t));
        }
        deemph_ms_block(dst, ch_stride,
                        pprev + static_cast<int64_t>(b) * nch * nstages,
                        pcoef + static_cast<int64_t>(b) * nch * nstages,
                        nch, n, nstages, ms);
    }
}

// ------------------------------------------------------- stream decoding

// Whole-stream decode: block scan + per-block (CRC, entropy decode,
// synthesis) with optional threading over independent blocks — every block
// carries its full model state, so block decode order is free
// (reference decodes serially: libs/linne_decoder/src/linne_decoder.c, the
// block loop in LINNEDecoder_DecodeWhole; this runtime exploits the
// block-standalone property instead).
//
// `data` is the stream body starting at the first block (after the global
// header). Output planes are out + ch*total_samples. Returns 0 on success,
// -1 malformed stream, -2 CRC mismatch, -3 corrupt payload.

namespace {

struct BlockRec {
    int64_t off;      // offset of the sync word
    int64_t start;    // first output sample index
    int32_t type;
    int32_t n;        // num_samples
    int32_t bsize;    // stored block_size (payload + 5)
};

inline uint16_t be16(const uint8_t* p) {
    return static_cast<uint16_t>((p[0] << 8) | p[1]);
}
inline uint32_t be32(const uint8_t* p) {
    return (static_cast<uint32_t>(p[0]) << 24) |
           (static_cast<uint32_t>(p[1]) << 16) |
           (static_cast<uint32_t>(p[2]) << 8) | p[3];
}

int32_t decode_raw_payload(const uint8_t* p, int64_t psize, int32_t nch,
                           int32_t n, int32_t bps, int32_t* out,
                           int64_t stride) {
    // the read loop consumes 1/2/3 bytes for bps 8/16/other — size the
    // bounds check by what is actually consumed, and reject widths the
    // raw layout doesn't define (a crafted header with e.g. bps=12 would
    // otherwise pass a 12/8=1-byte check but read 3 bytes per sample)
    if (bps != 8 && bps != 16 && bps != 24) return -3;
    int bytes_per = bps / 8;
    if (psize < static_cast<int64_t>(nch) * n * bytes_per) return -3;
    for (int64_t t = 0; t < n; t++) {
        for (int ch = 0; ch < nch; ch++) {
            uint32_t u;
            if (bps == 8) {
                u = *p++;
            } else if (bps == 16) {
                u = be16(p);
                p += 2;
            } else {  // 24
                u = (static_cast<uint32_t>(p[0]) << 16) |
                    (static_cast<uint32_t>(p[1]) << 8) | p[2];
                p += 3;
            }
            out[ch * stride + t] = zigzag_dec(u);
        }
    }
    return 0;
}

struct StreamParams {
    const uint8_t* data;
    const int16_t* huff_node0;
    const int16_t* huff_node1;
    int32_t huff_root, num_symbols;
    int32_t nch, bps, nlayers;
    const int32_t* orders;
    int32_t nstages, ms, check_crc;
    int32_t* out;
    int64_t total_samples;
    int32_t total_order;
};

// Blocks per synthesis window: each worker entropy-decodes a run of
// consecutive blocks, then one layer-cascade collection spans all their
// channels. Cross-block pairing mops up the same-shape singles the
// per-block collection leaves (e.g. the order-128 u=1 unit when a block's
// channels disagree on the split: 69% paired per block -> ~100% per window
// on the bench stream). 4 blocks x 8ch x 40KB stays L2-resident.
constexpr int kSynthWindow = 4;

// Decode a window of up to kSynthWindow consecutive blocks. Scratch
// regions hold kSynthWindow independent slots laid out [slot][channel...]:
// coefs + k*per_coef, (log2u|rshifts) + k*per_l, (pprev|pcoef) + k*per_s.
int32_t decode_window(const StreamParams& sp, const BlockRec* bs, int cnt,
                      int32_t* coefs, int32_t* log2u, int32_t* rshifts,
                      int32_t* pprev, int32_t* pcoef, int per_coef,
                      int per_l, int per_s) {
    SynthChan chans[kSynthWindow * kMaxNumChannels];
    int grp_slot[kSynthWindow];
    int ng = 0, nchans = 0;
    int32_t group_n = -1;
    const int64_t stride = sp.total_samples;
    for (int k = 0; k < cnt; k++) {
        const BlockRec& b = bs[k];
        const uint8_t* blk = sp.data + b.off;
        if (sp.check_crc) {
            uint16_t stored = be16(blk + 6);
            uint16_t actual = linne_crc16(blk + 8, b.bsize - 2);
            if (stored != actual) return -2;
        }
        int32_t* planes = sp.out + b.start;
        const uint8_t* payload = blk + 11;
        int64_t psize = static_cast<int64_t>(b.bsize) - 5;
        if (b.type == 1) {  // silent
            for (int ch = 0; ch < sp.nch; ch++)
                std::memset(planes + ch * stride, 0, sizeof(int32_t) * b.n);
            continue;
        }
        if (b.type == 2) {  // raw
            int32_t st = decode_raw_payload(payload, psize, sp.nch, b.n,
                                            sp.bps, planes, stride);
            if (st) return st;
            continue;
        }
        int32_t* kcoefs = coefs + k * per_coef;
        int32_t* klog2u = log2u + k * per_l;
        int32_t* krsh = rshifts + k * per_l;
        int32_t* kpprev = pprev + k * per_s;
        int32_t* kpcoef = pcoef + k * per_s;
        int64_t consumed = unpack_compress_core(
            payload, psize, sp.huff_node0, sp.huff_node1, sp.huff_root,
            sp.num_symbols, sp.nch, b.n, sp.bps, sp.nlayers, sp.orders,
            sp.nstages, planes, stride, kcoefs, klog2u, krsh, kpprev,
            kpcoef);
        if (consumed < 0) return -3;
        if (group_n < 0) group_n = b.n;
        if (b.n != group_n || sp.nch > kMaxNumChannels) {
            // odd length (tail block) or oversized embedder channel count:
            // full per-block path, bit-identical to the grouped one
            synthesize_block_core(planes, stride, kcoefs, klog2u, krsh,
                                  kpprev, kpcoef, sp.nch, b.n, sp.nlayers,
                                  sp.orders, sp.nstages, sp.ms);
            continue;
        }
        fill_synth_chans(chans + nchans, planes, stride, kcoefs, klog2u,
                         krsh, sp.nch, sp.nlayers, sp.total_order);
        nchans += sp.nch;
        grp_slot[ng++] = k;
    }
    if (nchans) {
        synth_layers_multi(chans, nchans, group_n, sp.nlayers, sp.orders);
        for (int g = 0; g < ng; g++) {
            int k = grp_slot[g];
            const BlockRec& b = bs[k];
            deemph_ms_block(sp.out + b.start, stride, pprev + k * per_s,
                            pcoef + k * per_s, sp.nch, b.n, sp.nstages,
                            sp.ms);
        }
    }
    return 0;
}

}  // namespace

int32_t linne_decode_stream(
    const uint8_t* data, int64_t size, int64_t total_samples,
    const int16_t* huff_node0, const int16_t* huff_node1, int32_t huff_root,
    int32_t num_symbols,
    int32_t nch, int32_t bps, int32_t nlayers, const int32_t* orders,
    int32_t nstages, int32_t ms, int32_t check_crc, int32_t num_threads,
    int32_t* out) {
    int32_t total_order = 0;
    for (int l = 0; l < nlayers; l++) total_order += orders[l];

    // 1) serial block scan (headers only)
    std::vector<BlockRec> blocks;
    int64_t pos = 0, progress = 0;
    while (progress < total_samples && pos < size) {
        if (size - pos < 11) return -1;
        if (be16(data + pos) != 0xFFFF) return -1;
        int64_t bsize = be32(data + pos + 2);
        int32_t type = data[pos + 8];
        int32_t ns = be16(data + pos + 9);
        if (bsize < 5 || pos + 6 + bsize > size) return -1;
        if (type > 2) return -1;
        if (progress + ns > total_samples) return -1;
        blocks.push_back(BlockRec{pos, progress, type, ns,
                                  static_cast<int32_t>(bsize)});
        pos += bsize + 6;
        progress += ns;
    }
    // a cleanly-truncated body must not report success with an unwritten
    // output tail (the header promised total_samples)
    if (progress < total_samples) return -1;

    StreamParams sp{data,    huff_node0, huff_node1, huff_root,
                    num_symbols, nch,    bps,        nlayers,
                    orders,  nstages,    ms,         check_crc,
                    out,     total_samples, total_order};

    int nthreads = num_threads;
    if (nthreads <= 0) {
        nthreads = static_cast<int>(std::thread::hardware_concurrency());
        if (nthreads <= 0) nthreads = 1;
    }
    if (nthreads > 32) nthreads = 32;
    // work items are kSynthWindow-block windows, not blocks
    size_t nwindows = (blocks.size() + kSynthWindow - 1) / kSynthWindow;
    if (static_cast<size_t>(nthreads) > nwindows)
        nthreads = static_cast<int>(nwindows);

    const int per_coef = nch * total_order;
    const int per_l = nch * nlayers;
    const int per_s = nch * nstages;
    const int scratch = kSynthWindow * (per_coef + 2 * per_l + 2 * per_s);
    if (nthreads <= 1) {
        std::vector<int32_t> s(scratch);
        int32_t* coefs = s.data();
        int32_t* log2u = coefs + kSynthWindow * per_coef;
        int32_t* rsh = log2u + kSynthWindow * per_l;
        int32_t* pprev = rsh + kSynthWindow * per_l;
        int32_t* pcoef = pprev + kSynthWindow * per_s;
        for (size_t i = 0; i < blocks.size(); i += kSynthWindow) {
            int cnt = static_cast<int>(
                blocks.size() - i < kSynthWindow ? blocks.size() - i
                                                 : kSynthWindow);
            int32_t st = decode_window(sp, blocks.data() + i, cnt, coefs,
                                       log2u, rsh, pprev, pcoef, per_coef,
                                       per_l, per_s);
            if (st) return st;
        }
        return 0;
    }

    std::atomic<size_t> next{0};
    std::atomic<int32_t> err{0};
    auto worker = [&]() {
        std::vector<int32_t> s(scratch);
        int32_t* coefs = s.data();
        int32_t* log2u = coefs + kSynthWindow * per_coef;
        int32_t* rsh = log2u + kSynthWindow * per_l;
        int32_t* pprev = rsh + kSynthWindow * per_l;
        int32_t* pcoef = pprev + kSynthWindow * per_s;
        for (;;) {
            size_t i = next.fetch_add(kSynthWindow,
                                      std::memory_order_relaxed);
            if (i >= blocks.size()) break;
            if (err.load(std::memory_order_relaxed)) break;
            int cnt = static_cast<int>(
                blocks.size() - i < kSynthWindow ? blocks.size() - i
                                                 : kSynthWindow);
            int32_t st = decode_window(sp, blocks.data() + i, cnt, coefs,
                                       log2u, rsh, pprev, pcoef, per_coef,
                                       per_l, per_s);
            if (st) {
                int32_t expect = 0;
                err.compare_exchange_strong(expect, st);
                break;
            }
        }
    };
    std::vector<std::thread> pool;
    pool.reserve(nthreads - 1);
    for (int i = 0; i < nthreads - 1; i++) pool.emplace_back(worker);
    worker();
    for (auto& t : pool) t.join();
    return err.load();
}

// Unpack a W-bit two's-complement sample plane (the slim device->host
// residual transfer, see codec/encoder.py _finish) into int32 samples.
// rows are independent; layout per row: groups of g samples in g*W/32
// little-endian 32-bit words, W in [2, 32).
void linne_unpack_bits(const uint32_t* words, int64_t nrows,
                       int32_t words_per_row, int32_t width, int32_t n,
                       int32_t* out) {
    const uint32_t mask = (width < 32) ? ((1u << width) - 1u) : ~0u;
    const int32_t sign = 1 << (width - 1);
    for (int64_t r = 0; r < nrows; r++) {
        const uint32_t* w = words + r * words_per_row;
        int32_t* o = out + r * n;
        int64_t bit = 0;
        for (int32_t i = 0; i < n; i++, bit += width) {
            int64_t k = bit >> 5;
            int off = (int)(bit & 31);
            uint32_t v = w[k] >> off;
            if (off + width > 32) v |= w[k + 1] << (32 - off);
            v &= mask;
            o[i] = (int32_t)((v ^ (uint32_t)sign) - (uint32_t)sign);
        }
    }
}

// ---- exact float64 analysis helpers (the ExactEncoder hot loops) --------
//
// Strict left-to-right accumulation per output chain, matching the numpy
// oracle's mul-then-cumsum evaluation (exact/lpc.py:_serial_sum): every
// product is rounded BEFORE the add, so fp contraction must stay off —
// enforced per-function with the optimize attribute so sanitizer/test
// builds with other flag sets stay bit-identical too. Chains for different
// outputs are independent, so blocks of 4 run together to hide the ~4-cycle
// add latency; lanes never reorder adds within a chain.

#if defined(__clang__)
// clang ignores the GCC optimize attribute; this file-scope pragma turns
// contraction off for everything below it regardless of build flags
#pragma clang fp contract(off)
#define LINNE_EXACT_FP
#elif defined(_MSC_VER)
// MSVC: no per-function attribute; the file-scope pragma disables
// contraction for every function below this point (the exact helpers)
#pragma fp_contract(off)
#define LINNE_EXACT_FP
#else
#define LINNE_EXACT_FP __attribute__((optimize("fp-contract=off")))
#endif

// out[lag] = sum_i x[i] * x[i + lag], i serial, for lag in [0, nlags)
// (oracle: exact/lpc.py:autocorrelation; reference: lpc.c:215-249).
LINNE_EXACT_FP
void linne_exact_autocorr(const double* x, int64_t n, int32_t nlags,
                          double* out) {
    int32_t lag = 0;
#if defined(__AVX512F__)
    // Packed form of the same chains: lane l of an accumulator carries the
    // serial chain for lag+l (vaddpd/vmulpd are lane-wise, so each chain's
    // rounding sequence is untouched — no FMA, products still rounded
    // before the add). 32 chains in flight hide the 4-cycle add latency;
    // each chain's tail (i >= common) continues scalar FROM the lane value.
    for (; lag + 32 <= nlags; lag += 32) {
        __m512d a0 = _mm512_setzero_pd(), a1 = _mm512_setzero_pd();
        __m512d a2 = _mm512_setzero_pd(), a3 = _mm512_setzero_pd();
        int64_t common = n - (lag + 31);
        if (common < 0) common = 0;
        for (int64_t i = 0; i < common; i++) {
            const __m512d xi = _mm512_set1_pd(x[i]);
            const double* b = x + i + lag;
            a0 = _mm512_add_pd(a0, _mm512_mul_pd(xi, _mm512_loadu_pd(b)));
            a1 = _mm512_add_pd(a1, _mm512_mul_pd(xi, _mm512_loadu_pd(b + 8)));
            a2 = _mm512_add_pd(a2, _mm512_mul_pd(xi, _mm512_loadu_pd(b + 16)));
            a3 = _mm512_add_pd(a3, _mm512_mul_pd(xi, _mm512_loadu_pd(b + 24)));
        }
        double acc[32];
        _mm512_storeu_pd(acc, a0);
        _mm512_storeu_pd(acc + 8, a1);
        _mm512_storeu_pd(acc + 16, a2);
        _mm512_storeu_pd(acc + 24, a3);
        for (int32_t l = 0; l < 32; l++) {
            double a = acc[l];
            for (int64_t i = common; i < n - (lag + l); i++)
                a += x[i] * x[i + lag + l];
            out[lag + l] = a;
        }
    }
    for (; lag + 8 <= nlags; lag += 8) {
        __m512d a0 = _mm512_setzero_pd();
        int64_t common = n - (lag + 7);
        if (common < 0) common = 0;
        for (int64_t i = 0; i < common; i++) {
            const __m512d xi = _mm512_set1_pd(x[i]);
            a0 = _mm512_add_pd(
                a0, _mm512_mul_pd(xi, _mm512_loadu_pd(x + i + lag)));
        }
        double acc[8];
        _mm512_storeu_pd(acc, a0);
        for (int32_t l = 0; l < 8; l++) {
            double a = acc[l];
            for (int64_t i = common; i < n - (lag + l); i++)
                a += x[i] * x[i + lag + l];
            out[lag + l] = a;
        }
    }
#endif
    for (; lag + 4 <= nlags; lag += 4) {
        double a0 = 0.0, a1 = 0.0, a2 = 0.0, a3 = 0.0;
        int64_t common = n - (lag + 3);  // all four lags in range
        if (common < 0) common = 0;
        int64_t i = 0;
        for (; i < common; i++) {
            double xi = x[i];
            a0 += xi * x[i + lag];
            a1 += xi * x[i + lag + 1];
            a2 += xi * x[i + lag + 2];
            a3 += xi * x[i + lag + 3];
        }
        for (i = common; i < n - lag; i++) a0 += x[i] * x[i + lag];
        for (i = common; i < n - (lag + 1); i++) a1 += x[i] * x[i + lag + 1];
        for (i = common; i < n - (lag + 2); i++) a2 += x[i] * x[i + lag + 2];
        out[lag] = a0; out[lag + 1] = a1; out[lag + 2] = a2;
        out[lag + 3] = a3;
    }
    for (; lag < nlags; lag++) {
        double a = 0.0;
        for (int64_t i = 0; i < n - lag; i++) a += x[i] * x[i + lag];
        out[lag] = a;
    }
}

// out[t] = base_t + sum_j x[t - npu + j] * params[unit(t)*npu + j], j
// serial, unit(t) = t / (n / num_units); x has implicit +0.0 left context
// (the products against it are computed, preserving signed-zero behavior).
// base_t = x[t] when include_base (unit-search scoring) else 0.0 (layer
// forward). Oracle: exact/network.py:_unit_predictions; reference:
// linne_network.c:165-210,319-335. Requires num_units | n (callers
// guarantee; the python wrapper falls back otherwise).
LINNE_EXACT_FP
void linne_exact_unit_predict(const double* x, int64_t n,
                              const double* params, int32_t num_units,
                              int32_t npu, int32_t include_base,
                              double* out) {
    int64_t ns = n / num_units;
    for (int32_t u = 0; u < num_units; u++) {
        const double* p = params + (int64_t)u * npu;
        int64_t t0 = (int64_t)u * ns, t1 = t0 + ns;
        int64_t t = t0;
        // left edge (unit 0 only): window reaches before x[0]
        for (; t < t1 && t < npu; t++) {
            double acc = include_base ? x[t] : 0.0;
            for (int32_t j = 0; j < npu; j++) {
                double xv = (t - npu + j) >= 0 ? x[t - npu + j] : 0.0;
                acc += xv * p[j];
            }
            out[t] = acc;
        }
#if defined(__AVX512F__)
        // Packed form of the same chains: lane k of an accumulator carries
        // output t+k's serial tap sum (lane-wise mul/add keep each chain's
        // rounding order; no FMA). Two accumulators in flight halve the
        // add-latency stall.
        for (; t + 16 <= t1; t += 16) {
            const double* w = x + t - npu;
            __m512d a0 = include_base ? _mm512_loadu_pd(x + t)
                                      : _mm512_setzero_pd();
            __m512d a1 = include_base ? _mm512_loadu_pd(x + t + 8)
                                      : _mm512_setzero_pd();
            for (int32_t j = 0; j < npu; j++) {
                const __m512d pj = _mm512_set1_pd(p[j]);
                a0 = _mm512_add_pd(a0,
                                   _mm512_mul_pd(pj, _mm512_loadu_pd(w + j)));
                a1 = _mm512_add_pd(
                    a1, _mm512_mul_pd(pj, _mm512_loadu_pd(w + j + 8)));
            }
            _mm512_storeu_pd(out + t, a0);
            _mm512_storeu_pd(out + t + 8, a1);
        }
        for (; t + 8 <= t1; t += 8) {
            const double* w = x + t - npu;
            __m512d a0 = include_base ? _mm512_loadu_pd(x + t)
                                      : _mm512_setzero_pd();
            for (int32_t j = 0; j < npu; j++) {
                const __m512d pj = _mm512_set1_pd(p[j]);
                a0 = _mm512_add_pd(a0,
                                   _mm512_mul_pd(pj, _mm512_loadu_pd(w + j)));
            }
            _mm512_storeu_pd(out + t, a0);
        }
#endif
        for (; t + 4 <= t1; t += 4) {
            const double* w = x + t - npu;
            double a0 = include_base ? x[t] : 0.0;
            double a1 = include_base ? x[t + 1] : 0.0;
            double a2 = include_base ? x[t + 2] : 0.0;
            double a3 = include_base ? x[t + 3] : 0.0;
            for (int32_t j = 0; j < npu; j++) {
                double pj = p[j];
                a0 += w[j] * pj;
                a1 += w[j + 1] * pj;
                a2 += w[j + 2] * pj;
                a3 += w[j + 3] * pj;
            }
            out[t] = a0; out[t + 1] = a1; out[t + 2] = a2; out[t + 3] = a3;
        }
        for (; t < t1; t++) {
            const double* w = x + t - npu;
            double acc = include_base ? x[t] : 0.0;
            for (int32_t j = 0; j < npu; j++) acc += w[j] * p[j];
            out[t] = acc;
        }
    }
}

// Levinson-Durbin recursion with the oracle's exact operation order
// (exact/lpc.py:levinson_durbin; reference: lpc.c:252-324). Writes
// lpc_coef[0:order] and parcor_coef[0:order] on success; the degenerate
// ac[0] path zeroes [0:order+1] of both — and nothing else is touched,
// preserving the arena's stale-scratch semantics (the code-length
// estimator deliberately reads parcor_coef[order]). flt_eps is the
// caller's FLT_EPSILON constant so Python stays the single source.
LINNE_EXACT_FP
void linne_exact_levinson(const double* ac, int32_t order, double flt_eps,
                          double* lpc_coef, double* parcor_coef) {
    if (order <= 0) return;  // the prologue reads ac[1] / writes parcor[0]
    if (order + 2 > 260) return;  // scratch cap; wrapper falls back first
    if (std::fabs(ac[0]) < flt_eps) {
        for (int32_t i = 0; i <= order; i++) lpc_coef[i] = 0.0;
        for (int32_t i = 0; i <= order; i++) parcor_coef[i] = 0.0;
        return;
    }
    // order <= 128+1 in this codec; cap generously for embedders
    double a[260], u[260], v[260];
    for (int32_t i = 0; i < order + 2; i++) a[i] = u[i] = v[i] = 0.0;
    a[0] = 1.0;
    double ek = ac[0];
    a[1] = -ac[1] / ac[0];
    parcor_coef[0] = ac[1] / ek;
    ek += ac[1] * a[1];
    for (int32_t k = 1; k < order; k++) {
        double gamma = 0.0;  // serial: sum_i a[i] * ac[k+1-i]
        for (int32_t i = 0; i <= k; i++) gamma += a[i] * ac[k + 1 - i];
        gamma /= -ek;
        ek *= 1.0 - gamma * gamma;
        for (int32_t i = 1; i <= k; i++) u[i] = a[i];
        for (int32_t i = 1; i <= k; i++) v[i] = a[k + 1 - i];
        u[0] = 1.0; u[k + 1] = 0.0;
        v[0] = 0.0; v[k + 1] = 1.0;
        for (int32_t i = 0; i <= k + 1; i++) a[i] = u[i] + gamma * v[i];
        parcor_coef[k] = -gamma;
    }
    for (int32_t i = 0; i < order; i++) lpc_coef[i] = a[i + 1];
}

// IRLS (auxiliary-function) normal equations with the oracle's exact
// arithmetic (exact/lpc.py:_af_matrix_and_vector; reference:
// lpc.c:452-509): X[t,i] = data[order+t-1-i]; residual[t] =
// |data[order+t] + serial_i a[i]*X[t,i]|; obj = serial_t residual;
// inv[t] = 1/max(residual, eps); r_vec[i] = -serial_t (d*xi)*inv;
// r_mat[i][j] = serial_t (xi*xj)*inv (two rounded multiplies per term).
// Chains run serially over their own accumulation axis; independent
// outputs run 4-wide to hide add latency.
LINNE_EXACT_FP
void linne_exact_af_normal(const double* data, int64_t n, const double* a,
                           int32_t order, double eps, double* r_mat,
                           double* r_vec, double* obj) {
    const int64_t nres = n - order;
    const double* d = data + order;
    std::vector<double> inv(static_cast<size_t>(nres));
    double ob = 0.0;
    int64_t t0 = 0;
#if defined(__AVX512F__)
    // Lane l carries residual t+l's serial tap chain (X[t+l, i] lanes are
    // ascending-contiguous loads); |.| / compare / div are lane-wise IEEE
    // ops identical to the scalar path. The obj accumulation stays a
    // single serial chain over t, folded below from the stored residuals.
    {
        const __m512d absmask = _mm512_castsi512_pd(
            _mm512_set1_epi64(0x7fffffffffffffffLL));
        const __m512d veps = _mm512_set1_pd(eps);
        const __m512d one = _mm512_set1_pd(1.0);
        for (; t0 + 8 <= nres; t0 += 8) {
            __m512d acc = _mm512_loadu_pd(d + t0);
            const double* w = data + order + t0 - 1;  // w[l - i] = X[t0+l, i]
            for (int32_t i = 0; i < order; i++) {
                const __m512d ai = _mm512_set1_pd(a[i]);
                acc = _mm512_add_pd(
                    acc, _mm512_mul_pd(ai, _mm512_loadu_pd(w - i)));
            }
            const __m512d r = _mm512_and_pd(acc, absmask);
            // np.maximum semantics: NaN propagates (r < eps false for NaN)
            const __mmask8 lt = _mm512_cmp_pd_mask(r, veps, _CMP_LT_OQ);
            const __m512d den = _mm512_mask_blend_pd(lt, r, veps);
            _mm512_storeu_pd(&inv[t0], _mm512_div_pd(one, den));
            // stash |residual| for the serial obj fold below: reuse the
            // r_vec buffer? no — keep a local spill per block
            double rr[8];
            _mm512_storeu_pd(rr, r);
            for (int32_t l = 0; l < 8; l++) ob += rr[l];
        }
    }
#endif
    for (int64_t t = t0; t < nres; t++) {
        const double* w = data + order + t - 1;  // w[-i] = X[t, i]
        double acc = d[t];
        for (int32_t i = 0; i < order; i++) acc += a[i] * w[-i];
        double r = std::fabs(acc);
        ob += r;
        // np.maximum semantics: NaN propagates (r < eps is false for NaN)
        inv[t] = 1.0 / (r < eps ? eps : r);
    }
    *obj = ob;
#if defined(__AVX512F__)
    // Lane l of a block carries the serial chain for output j+l (r_vec:
    // i+l). X[t, j+l] lanes are DESCENDING-contiguous — one load + a
    // reverse permute; both products stay lane-wise rounded in the
    // oracle's order: (xi * xj) * inv.
    if (order >= 8) {
        // X[t, j+l] lanes are descending-contiguous; instead of reversing
        // every load, lane l accumulates output j+7-l (its own serial
        // chain, untouched) and ONE reverse permute runs at store time.
        // Two j-blocks per t amortize the d/inv broadcasts.
        const __m512i rev = _mm512_set_epi64(0, 1, 2, 3, 4, 5, 6, 7);
        int32_t i = 0;
        for (; i + 8 <= order; i += 8) {
            const double* xi_nat = data + order - 8 - i;  // lane l: i+7-l
            __m512d v = _mm512_setzero_pd();
            for (int64_t t = 0; t < nres; t++) {
                const __m512d dt = _mm512_set1_pd(d[t]);
                const __m512d it = _mm512_set1_pd(inv[t]);
                v = _mm512_add_pd(
                    v, _mm512_mul_pd(
                           _mm512_mul_pd(dt, _mm512_loadu_pd(xi_nat + t)),
                           it));
            }
            double vv[8];
            _mm512_storeu_pd(vv, _mm512_permutexvar_pd(rev, v));
            for (int32_t l = 0; l < 8; l++) r_vec[i + l] = -vv[l];
        }
        for (; i < order; i++) {
            const double* xi = data + order - 1 - i;
            double v = 0.0;
            for (int64_t t = 0; t < nres; t++) v += (d[t] * xi[t]) * inv[t];
            r_vec[i] = -v;
        }
        for (i = 0; i < order; i++) {
            const double* xi = data + order - 1 - i;
            double* row = r_mat + static_cast<int64_t>(i) * order;
            int32_t j = i;
            for (; j + 16 <= order; j += 16) {
                const double* x0 = data + order - 8 - j;   // lanes j+7-l
                const double* x1 = x0 - 8;                 // lanes j+15-l
                __m512d s0 = _mm512_setzero_pd();
                __m512d s1 = _mm512_setzero_pd();
                for (int64_t t = 0; t < nres; t++) {
                    const __m512d xit = _mm512_set1_pd(xi[t]);
                    const __m512d it = _mm512_set1_pd(inv[t]);
                    s0 = _mm512_add_pd(
                        s0, _mm512_mul_pd(
                                _mm512_mul_pd(xit, _mm512_loadu_pd(x0 + t)),
                                it));
                    s1 = _mm512_add_pd(
                        s1, _mm512_mul_pd(
                                _mm512_mul_pd(xit, _mm512_loadu_pd(x1 + t)),
                                it));
                }
                _mm512_storeu_pd(row + j, _mm512_permutexvar_pd(rev, s0));
                _mm512_storeu_pd(row + j + 8,
                                 _mm512_permutexvar_pd(rev, s1));
            }
            for (; j + 8 <= order; j += 8) {
                const double* x0 = data + order - 8 - j;
                __m512d s0 = _mm512_setzero_pd();
                for (int64_t t = 0; t < nres; t++) {
                    const __m512d xit = _mm512_set1_pd(xi[t]);
                    const __m512d it = _mm512_set1_pd(inv[t]);
                    s0 = _mm512_add_pd(
                        s0, _mm512_mul_pd(
                                _mm512_mul_pd(xit, _mm512_loadu_pd(x0 + t)),
                                it));
                }
                _mm512_storeu_pd(row + j, _mm512_permutexvar_pd(rev, s0));
            }
            for (; j < order; j++) {
                const double* xj = data + order - 1 - j;
                double s = 0.0;
                for (int64_t t = 0; t < nres; t++)
                    s += (xi[t] * xj[t]) * inv[t];
                row[j] = s;
            }
        }
        for (int32_t ii = 0; ii < order; ii++)
            for (int32_t j = ii + 1; j < order; j++)
                r_mat[j * order + ii] = r_mat[ii * order + j];
        return;
    }
#endif
    for (int32_t i = 0; i < order; i++) {
        const double* xi = data + order - 1 - i;
        double v = 0.0;
        for (int64_t t = 0; t < nres; t++) v += (d[t] * xi[t]) * inv[t];
        r_vec[i] = -v;
        int32_t j = i;
        for (; j + 4 <= order; j += 4) {
            const double* x0 = data + order - 1 - j;
            double s0 = 0.0, s1 = 0.0, s2 = 0.0, s3 = 0.0;
            for (int64_t t = 0; t < nres; t++) {
                double xit = xi[t];
                double it = inv[t];
                s0 += (xit * x0[t]) * it;
                s1 += (xit * x0[t - 1]) * it;
                s2 += (xit * x0[t - 2]) * it;
                s3 += (xit * x0[t - 3]) * it;
            }
            r_mat[i * order + j] = s0;
            r_mat[i * order + j + 1] = s1;
            r_mat[i * order + j + 2] = s2;
            r_mat[i * order + j + 3] = s3;
        }
        for (; j < order; j++) {
            const double* xj = data + order - 1 - j;
            double s = 0.0;
            for (int64_t t = 0; t < nres; t++) s += (xi[t] * xj[t]) * inv[t];
            r_mat[i * order + j] = s;
        }
    }
    for (int32_t i = 0; i < order; i++)
        for (int32_t j = i + 1; j < order; j++)
            r_mat[j * order + i] = r_mat[i * order + j];
}

// In-place Cholesky solve with the oracle's exact order (exact/lpc.py:
// _cholesky_solve; reference: lpc.c:402-448): descending-k inner
// subtractions, pow(sum, -0.5) diagonal. A is row-major [dim, dim],
// mutated like the oracle. Returns 0, or -1 on a non-positive pivot.
LINNE_EXACT_FP
int32_t linne_exact_cholesky_solve(double* A, const double* b, int32_t dim,
                                   double* x) {
    std::vector<double> inv_diag(static_cast<size_t>(dim));
    for (int32_t i = 0; i < dim; i++) {
        double* Ai = A + static_cast<int64_t>(i) * dim;
        double s = Ai[i];
        for (int32_t k = i - 1; k >= 0; k--) s -= Ai[k] * Ai[k];
        if (s <= 0.0) return -1;
        inv_diag[i] = std::pow(s, -0.5);
        for (int32_t j = i + 1; j < dim; j++) {
            double* Aj = A + static_cast<int64_t>(j) * dim;
            double s2 = Ai[j];
            for (int32_t k = i - 1; k >= 0; k--) s2 -= Ai[k] * Aj[k];
            Aj[i] = s2 * inv_diag[i];
        }
    }
    for (int32_t i = 0; i < dim; i++) {
        const double* Ai = A + static_cast<int64_t>(i) * dim;
        double s = b[i];
        for (int32_t k = i - 1; k >= 0; k--) s -= Ai[k] * x[k];
        x[i] = s * inv_diag[i];
    }
    for (int32_t i = dim - 1; i >= 0; i--) {
        double s = x[i];
        for (int32_t k = i + 1; k < dim; k++)
            s -= A[static_cast<int64_t>(k) * dim + i] * x[k];
        x[i] = s * inv_diag[i];
    }
    return 0;
}

// Trainer layer backward with the oracle's exact chains
// (exact/network.py:LayerState.backward; reference: linne_network.c:
// 213-265). Per unit (pin/pout/pback are the unit's ns-long slices,
// p its npu taps):
//   dparams[i] = serial_j pin[j] * pout[npu-i+j],   j < ns-npu+i
//   pback[i]  += (serial_m p[m] * pout[npu+i-m]) / npu,
//                m in [max(0, npu+i-ns+1), npu)
// grad_inout arrives holding the incoming gradient (pout is a separate
// read-only copy of it) and leaves holding the input gradient.
LINNE_EXACT_FP
void linne_exact_layer_backward(const double* din, const double* dout,
                                double* grad_inout, const double* params,
                                int32_t num_units, int32_t npu, int64_t n,
                                double* dparams) {
    const int64_t ns = n / num_units;
    const double inpu = static_cast<double>(npu);
    for (int32_t u = 0; u < num_units; u++) {
        const double* pin = din + u * ns;
        const double* pout = dout + u * ns;
        double* pback = grad_inout + u * ns;
        const double* p = params + static_cast<int64_t>(u) * npu;
        double* pdp = dparams + static_cast<int64_t>(u) * npu;
        int32_t i = 0;
#if defined(__AVX512F__)
        // Lane l carries dparams[i+7-l]'s serial chain (descending-index
        // lanes load contiguously; ONE reverse permute at store time).
        // Chains share the prefix j < jn(i); lane i+l's extra terms
        // j in [jn(i), jn(i)+l) finish scalar from the lane value.
        for (; i + 8 <= npu && ns - npu + i >= 0; i += 8) {
            const int64_t jn = ns - npu + i;       // shortest chain (lane 7)
            const double* q = pout + npu - i - 7;  // q[j + l] hits lane l
            __m512d s = _mm512_setzero_pd();
            for (int64_t j = 0; j < jn; j++) {
                s = _mm512_add_pd(
                    s, _mm512_mul_pd(_mm512_set1_pd(pin[j]),
                                     _mm512_loadu_pd(q + j)));
            }
            double acc[8];
            const __m512i rev = _mm512_set_epi64(0, 1, 2, 3, 4, 5, 6, 7);
            _mm512_storeu_pd(acc, _mm512_permutexvar_pd(rev, s));
            for (int32_t l = 0; l < 8; l++) {
                double a = acc[l];
                const double* ql = pout + npu - (i + l);
                for (int64_t j = jn; j < ns - npu + i + l; j++)
                    a += pin[j] * ql[j];
                pdp[i + l] = a;
            }
        }
#endif
        for (; i + 4 <= npu; i += 4) {
            // chains share j; lanes differ in the pout offset npu-i
            const int64_t jn = ns - npu + i;  // lane k adds its last k
            const double* q = pout + npu - i;  // q[-k + j] for lane k
            double s0 = 0.0, s1 = 0.0, s2 = 0.0, s3 = 0.0;
            int64_t j = 0;
            for (; j < jn; j++) {
                double pj = pin[j];
                s0 += pj * q[j];
                s1 += pj * q[j - 1];
                s2 += pj * q[j - 2];
                s3 += pj * q[j - 3];
            }
            pdp[i] = s0;
            s1 += pin[jn] * q[jn - 1];
            pdp[i + 1] = s1;
            s2 += pin[jn] * q[jn - 2];
            s2 += pin[jn + 1] * q[jn - 1];
            pdp[i + 2] = s2;
            s3 += pin[jn] * q[jn - 3];
            s3 += pin[jn + 1] * q[jn - 2];
            s3 += pin[jn + 2] * q[jn - 1];
            pdp[i + 3] = s3;
        }
        for (; i < npu; i++) {
            const int64_t jn = ns - npu + i;
            const double* q = pout + npu - i;
            double s = 0.0;
            for (int64_t j = 0; j < jn; j++) s += pin[j] * q[j];
            pdp[i] = s;
        }
        // input gradient: independent chains across output samples
        int64_t t = 0;
#if defined(__AVX512F__)
        // lane l carries output t+l's serial tap chain (ascending-
        // contiguous loads); the edge region t > ns-npu-1 (clipped m0)
        // stays scalar below
        {
            const __m512d vnpu = _mm512_set1_pd(inpu);
            for (; t + 8 <= ns - npu; t += 8) {
                const double* qo = pout + npu + t;  // qo[l - m] per lane
                __m512d s = _mm512_setzero_pd();
                for (int32_t m = 0; m < npu; m++) {
                    s = _mm512_add_pd(
                        s, _mm512_mul_pd(_mm512_set1_pd(p[m]),
                                         _mm512_loadu_pd(qo - m)));
                }
                _mm512_storeu_pd(
                    pback + t,
                    _mm512_add_pd(_mm512_loadu_pd(pback + t),
                                  _mm512_div_pd(s, vnpu)));
            }
        }
#endif
        for (; t < ns; t++) {
            int32_t m0 = 0;
            int64_t over = npu + t - ns + 1;
            if (over > 0) m0 = static_cast<int32_t>(over);
            const double* qo = pout + npu + t;
            double s = 0.0;
            for (int32_t m = m0; m < npu; m++) s += p[m] * qo[-m];
            pback[t] += s / inpu;
        }
    }
}

// Whole-trainer loop: full-batch momentum gradient descent on the L1 loss
// (oracle: exact/network.py:TrainerState.train + NetworkState._calculate_
// gradient; reference: linne_network.c:805-873) in one native call — the
// oracle's per-iteration Python pass dominated the -l profile. Exact
// arithmetic: per iteration the signal is re-propagated through every
// layer (same unit-predict chains as the oracle), loss is the serial
// |residual| fold over samples divided by n, the L1 subgradient is
// sign(x)/n with sign(+-0)=+0 and NaN->+0, the backward pass reuses the
// exact layer-backward chains, and the momentum update is the oracle's
// elementwise m = m*alpha + lr*dg; p -= m. Convergence: |loss - prev| <
// loss_epsilon checked AFTER the update, prev seeded with flt_max.
// params/dparams/momentum are the per-layer arrays concatenated; work
// must hold (num_layers + 3) * n doubles. Requires num_units[l] | n for
// every layer (caller falls back otherwise).
LINNE_EXACT_FP
void linne_exact_train(
    const double* data, int64_t n, int32_t num_layers,
    const int32_t* num_units, const int32_t* num_params, double* params,
    double* dparams, double* momentum, int32_t max_iterations,
    double learning_rate, double loss_epsilon, double alpha,
    double flt_max, double* work) {
    double* buf = work;
    double* dout = work + n;
    double* pred = work + 2 * n;
    double* din = work + 3 * n;  // num_layers rows of n
    const double nd = static_cast<double>(n);
    double prev_loss = flt_max;
    for (int32_t it = 0; it < max_iterations; it++) {
        std::memcpy(buf, data, sizeof(double) * static_cast<size_t>(n));
        // forward: residual in place, per-layer input saved for backward
        int64_t poff = 0;
        for (int32_t l = 0; l < num_layers; l++) {
            double* dl = din + static_cast<int64_t>(l) * n;
            std::memcpy(dl, buf, sizeof(double) * static_cast<size_t>(n));
            linne_exact_unit_predict(dl, n, params + poff, num_units[l],
                                     num_params[l] / num_units[l], 0, pred);
            for (int64_t t = 1; t < n; t++) buf[t] += pred[t];
            poff += num_params[l];
        }
        double loss = 0.0;  // serial |residual| fold, sample order
        for (int64_t t = 0; t < n; t++) loss += std::fabs(buf[t]);
        loss /= nd;
        // L1 subgradient: sign(x)/n, sign(+-0)=+0, NaN->+0 (np.where)
        for (int64_t t = 0; t < n; t++) {
            const double v = buf[t];
            const double s = (v > 0.0) ? 1.0 : ((v < 0.0) ? -1.0 : 0.0);
            buf[t] = s / nd;
        }
        for (int32_t l = num_layers - 1; l >= 0; l--) {
            poff -= num_params[l];
            std::memcpy(dout, buf, sizeof(double) * static_cast<size_t>(n));
            linne_exact_layer_backward(
                din + static_cast<int64_t>(l) * n, dout, buf, params + poff,
                num_units[l], num_params[l] / num_units[l], n,
                dparams + poff);
        }
        int64_t k = 0;
        for (int32_t l = 0; l < num_layers; l++) {
            for (int32_t c = 0; c < num_params[l]; c++, k++) {
                double m = momentum[k] * alpha;
                m += learning_rate * dparams[k];
                momentum[k] = m;
                params[k] -= m;
            }
        }
        if (std::fabs(loss - prev_loss) < loss_epsilon) break;
        prev_loss = loss;
    }
}

// One windowed AF fit: Welch window -> autocorrelation -> ridge ->
// Levinson-Durbin -> optional IRLS refinement — the per-unit body of the
// layer fit below, bit-identical to exact/lpc.py:calculate_coef_af with
// WINDOW_WELCH (reference: lpc.c:327-366,578-661). The caller supplies the
// oracle's cached Welch weights so Python stays the single source of window
// truth; an odd-length window never writes the middle sample (the arena
// keeps its stale value, exact/lpc.py:apply_window). Arena write extents
// match the oracle exactly: the ns<npu and |ac[0]|<eps degenerate paths
// zero [0:npu+1] of their targets, the singular-Cholesky path zeroes
// lpc_coef[0:npu] only. Writes coef_out[0:npu]. Returns 0, or -1 on the
// one oracle-divergent corner (IRLS requested with no residual samples,
// where the oracle raises) so the caller can fall back.
LINNE_EXACT_FP
static int32_t exact_fit_unit(const double* data, int64_t ns, int32_t npu,
                              int32_t af_iters, const double* w,
                              double regular_term, double flt_eps,
                              double flt_max, double* buffer,
                              double* auto_corr, double* lpc_coef,
                              double* parcor_coef, double* coef_out,
                              double* r_mat, double* r_vec, double* x_vec,
                              double* a_vec) {
    const int64_t mid = ns >> 1;
    if (ns & 1) {
        for (int64_t i = 0; i < ns; i++)
            if (i != mid) buffer[i] = data[i] * w[i];
    } else {
        for (int64_t i = 0; i < ns; i++) buffer[i] = data[i] * w[i];
    }
    linne_exact_autocorr(buffer, ns, npu + 1, auto_corr);
    if (ns < npu) {
        for (int32_t i = 0; i <= npu; i++) lpc_coef[i] = 0.0;
        for (int32_t i = 0; i <= npu; i++) parcor_coef[i] = 0.0;
    } else {
        auto_corr[0] *= 1.0 + regular_term;
        linne_exact_levinson(auto_corr, npu, flt_eps, lpc_coef, parcor_coef);
    }
    for (int32_t i = 0; i < npu; i++) a_vec[i] = lpc_coef[i];
    if (std::fabs(auto_corr[0]) < flt_eps) {
        for (int32_t i = 0; i <= npu; i++) lpc_coef[i] = 0.0;
        for (int32_t i = 0; i < npu; i++) coef_out[i] = 0.0;
        return 0;
    }
    if (af_iters > 0 && ns - npu <= 0) return -1;  // oracle divides by nres
    double prev_obj = flt_max;
    for (int32_t it = 0; it < af_iters; it++) {
        double raw = 0.0;
        linne_exact_af_normal(data, ns, a_vec, npu, 1e-6, r_mat, r_vec,
                              &raw);
        const double obj = raw / static_cast<double>(ns - npu);
        if (linne_exact_cholesky_solve(r_mat, r_vec, npu, x_vec) != 0) {
            for (int32_t i = 0; i < npu; i++) lpc_coef[i] = 0.0;
            for (int32_t i = 0; i < npu; i++) coef_out[i] = 0.0;
            return 0;
        }
        for (int32_t i = 0; i < npu; i++) a_vec[i] = x_vec[i];
        if (std::fabs(prev_obj - obj) < 1e-8) break;
        prev_obj = obj;
    }
    for (int32_t i = 0; i < npu; i++) lpc_coef[i] = a_vec[i];
    for (int32_t i = 0; i < npu; i++) coef_out[i] = a_vec[i];
    return 0;
}

// Whole-layer model fit: the power-of-two unit-count search scored by mean
// |residual| plus the final refit with the caller's AF iteration count —
// the per-layer body of the encoder's fitting loop (oracle:
// exact/network.py:_search_optimal_num_units/_set_parameter; reference:
// linne_network.c:268-376). One call replaces the ~2*sum(level units)
// per-unit Python->C crossings whose ctypes overhead dominated the
// ExactEncoder profile. The arena pointers are the caller's long-lived
// LpcState arrays, mutated with the oracle's exact write extents so
// stale-scratch semantics survive across calls. weights holds the oracle's
// cached Welch windows for every level, concatenated: level l starts at
// weights + w_off[l] with length n / level_units[l]; level_units must be
// the oracle's valid-level list (ascending powers of two dividing both
// num_params and n). Writes params_out[0:num_params] (per-unit
// time-reversed taps) and pred_scratch[0:n]; returns the chosen unit
// count, or -1 when the call can't reproduce the oracle (caller falls
// back to the Python path).
LINNE_EXACT_FP
int32_t linne_exact_fit_layer(
    const double* data, int64_t n, int32_t num_params,
    int32_t num_af_iterations, double regular_term, double flt_eps,
    double flt_max, const double* weights, const int64_t* w_off,
    const int32_t* level_units, int32_t num_levels, double* buffer,
    double* auto_corr, double* lpc_coef, double* parcor_coef,
    double* params_out, double* pred_scratch) {
    if (num_params <= 0 || num_params > 258 || num_levels <= 0 || n <= 0)
        return -1;
    std::vector<double> scratch(
        static_cast<size_t>(num_params) * num_params + 4 * num_params);
    double* r_mat = scratch.data();
    double* r_vec = r_mat + static_cast<int64_t>(num_params) * num_params;
    double* x_vec = r_vec + num_params;
    double* a_vec = x_vec + num_params;
    double* coef_tmp = a_vec + num_params;

    double min_loss = flt_max;
    int32_t best = 0;
    for (int32_t l = 0; l < num_levels; l++) {
        const int32_t nunits = level_units[l];
        if (nunits <= 0 || num_params % nunits || n % nunits) return -1;
        const int32_t npu = num_params / nunits;
        const int64_t ns = n / nunits;
        const double* w = weights + w_off[l];
        for (int32_t u = 0; u < nunits; u++) {
            if (exact_fit_unit(data + static_cast<int64_t>(u) * ns, ns, npu,
                               0, w, regular_term, flt_eps, flt_max, buffer,
                               auto_corr, lpc_coef, parcor_coef, coef_tmp,
                               r_mat, r_vec, x_vec, a_vec) != 0)
                return -1;
            double* p = params_out + static_cast<int64_t>(u) * npu;
            for (int32_t j = 0; j < npu; j++) p[j] = coef_tmp[npu - 1 - j];
        }
        linne_exact_unit_predict(data, n, params_out, nunits, npu, 1,
                                 pred_scratch);
        double s = 0.0;  // serial |residual| sum skipping sample 0
        for (int64_t t = 1; t < n; t++) s += std::fabs(pred_scratch[t]);
        const double mean_loss = s / static_cast<double>(n);
        if (mean_loss < min_loss) {
            min_loss = mean_loss;
            best = nunits;
        }
    }
    if (best == 0) return -1;  // oracle asserts; caller falls back
    int32_t bl = 0;
    while (level_units[bl] != best) bl++;
    const int32_t npu = num_params / best;
    const int64_t ns = n / best;
    const double* w = weights + w_off[bl];
    for (int32_t u = 0; u < best; u++) {
        if (exact_fit_unit(data + static_cast<int64_t>(u) * ns, ns, npu,
                           num_af_iterations, w, regular_term, flt_eps,
                           flt_max, buffer, auto_corr, lpc_coef,
                           parcor_coef, coef_tmp, r_mat, r_vec, x_vec,
                           a_vec) != 0)
            return -1;
        double* p = params_out + static_cast<int64_t>(u) * npu;
        for (int32_t j = 0; j < npu; j++) p[j] = coef_tmp[npu - 1 - j];
    }
    return best;
}

// Whole-network ridge sweep: the encoder's full per-(block, channel) model
// search (oracle: exact/network.py:set_units_and_parameters; reference:
// linne_network.c:582-630) in ONE native call. For every ridge candidate it
// copies the signal into data_buffer, fits each layer in turn
// (linne_exact_fit_layer, arena semantics preserved) and forwards the
// residual (out-of-place unit predict added in [1, n)), scoring the serial
// mean |residual|; the best candidate (strict <, first minimum) is then
// refit with the caller's AF iteration count. Folding the sweep removes the
// remaining per-(ridge x layer) Python->C crossings and the oracle's numpy
// forward glue, which dominated the ExactEncoder profile after the
// per-layer fold. Level tables are the per-layer oracle caches concatenated:
// layer l's levels live at level_units[level_off[l] : +level_cnt[l]] with
// Welch windows at weights + w_off[same slice] (w_off entries are absolute
// into weights). Writes params_out (per-layer taps, concatenated),
// units_out[num_layers], data_buffer[0:n] (the final residual, matching the
// oracle's post-state) and pred_scratch[0:n]. Returns 0, or -1 when a layer
// fit can't reproduce the oracle. Callers MUST precheck the bail conditions
// (num_params in (0, 258], n > num_params per layer, oracle-built level
// tables) before calling: a mid-sweep -1 leaves the arena part-mutated, and
// the stale-scratch reads make a restarted fallback diverge from the
// oracle. With those prechecks, -1 is only reachable on inputs where the
// oracle itself asserts (all-NaN losses leave best == 0).
LINNE_EXACT_FP
int32_t linne_exact_fit_network(
    const double* data, int64_t n, int32_t num_layers,
    const int32_t* num_params, int32_t num_af_iterations,
    const double* ridge_terms, int32_t num_ridges, double flt_eps,
    double flt_max, const double* weights, const int64_t* w_off,
    const int32_t* level_units, const int32_t* level_off,
    const int32_t* level_cnt, double* buffer, double* auto_corr,
    double* lpc_coef, double* parcor_coef, double* params_out,
    int32_t* units_out, double* data_buffer, double* pred_scratch) {
    if (num_layers <= 0 || num_ridges <= 0 || n <= 0) return -1;
    double min_loss = flt_max;
    int32_t best_i = 0;
    // sweep pass i = 0..num_ridges-1 scores candidate i with af=0; pass
    // num_ridges is the final refit of the winner (oracle line order)
    for (int32_t pass = 0; pass <= num_ridges; pass++) {
        const int32_t ridge_i = (pass < num_ridges) ? pass : best_i;
        const int32_t af = (pass < num_ridges) ? 0 : num_af_iterations;
        const double term = ridge_terms[ridge_i];
        std::memcpy(data_buffer, data, sizeof(double) * size_t(n));
        int64_t poff = 0;
        for (int32_t l = 0; l < num_layers; l++) {
            const int32_t lo = level_off[l];
            const int32_t units = linne_exact_fit_layer(
                data_buffer, n, num_params[l], af, term, flt_eps, flt_max,
                weights, w_off + lo, level_units + lo, level_cnt[l], buffer,
                auto_corr, lpc_coef, parcor_coef, params_out + poff,
                pred_scratch);
            if (units <= 0) return -1;
            units_out[l] = units;
            // forward: residual += prediction, sample 0 untouched
            // (oracle: exact/network.py:LayerState.forward)
            linne_exact_unit_predict(data_buffer, n, params_out + poff,
                                     units, num_params[l] / units, 0,
                                     pred_scratch);
            for (int64_t t = 1; t < n; t++) data_buffer[t] += pred_scratch[t];
            poff += num_params[l];
        }
        if (pass < num_ridges) {
            double s = 0.0;  // serial |residual| fold, sample order
            for (int64_t t = 0; t < n; t++) s += std::fabs(data_buffer[t]);
            const double loss = s / static_cast<double>(n);
            if (loss < min_loss) {
                min_loss = loss;
                best_i = pass;
            }
        }
    }
    return 0;
}

// Partitioned-Rice parameter search with the oracle's exact arithmetic
// (format/rice.py:choose_partition; reference: linne_coder.c:217-279):
// uint64 finest partition sums, float64 halving-merge means, libm log for
// the MLE k2, exact per-sample code lengths accumulated mod 2^32, strict-<
// first-minimum over ascending porder. Writes the winning per-partition k2
// into k2s[0 : 1 << porder] and returns porder.
LINNE_EXACT_FP
int32_t linne_exact_rice_search(const int32_t* data, int64_t n,
                                int32_t* k2s) {
    if (n <= 0) {  // the divisibility loop below never exits for n == 0
        k2s[0] = 0;
        return 0;
    }
    // wire constants (format/rice.py): OPTX root and 5-bit parameter field.
    // kLogOptx goes through the same libm log() the oracle's math.log uses,
    // so the two paths share every bit of the constant.
    static const double kLogOptx = std::log(
        0.5127629514437670454896078808815218508243560791015625);
    static const double kInvLoge2 = 1.4426950408889634;
    int32_t max_porder = 0;
    {
        int32_t p = 1;
        while ((n % (int64_t(1) << p)) == 0) p++;
        max_porder = p - 1;
        if (max_porder > 10) max_porder = 10;
    }
    const int32_t max_parts = 1 << max_porder;
    const int64_t finest_ns = n / max_parts;

    // zigzag once
    std::vector<uint32_t> u(static_cast<size_t>(n));
    for (int64_t i = 0; i < n; i++) u[i] = zigzag_enc(data[i]);

    // finest sums (uint64, exact) -> float64 means, halving merges upward
    std::vector<double> means[11];
    {
        std::vector<double>& m = means[max_porder];
        m.resize(max_parts);
        for (int32_t part = 0; part < max_parts; part++) {
            uint64_t s = 0;
            const uint32_t* pu = u.data() + part * finest_ns;
            for (int64_t i = 0; i < finest_ns; i++) s += pu[i];
            m[part] = static_cast<double>(s) / static_cast<double>(finest_ns);
        }
        for (int32_t p = max_porder - 1; p >= 0; p--) {
            std::vector<double>& up = means[p + 1];
            means[p].resize(size_t(1) << p);
            for (size_t i = 0; i < means[p].size(); i++)
                means[p][i] = (up[2 * i] + up[2 * i + 1]) / 2.0;
        }
    }

    int32_t best_porder = 0;
    uint32_t min_bits = 0xFFFFFFFFu;
    std::vector<int32_t> k2_best, k2_cur;
    for (int32_t porder = 0; porder <= max_porder; porder++) {
        const int64_t nsmpl = n >> porder;
        uint32_t bits = 0;
        int32_t prevk2 = 0;
        const int32_t nparts = 1 << porder;
        k2_cur.resize(nparts);
        for (int32_t part = 0; part < nparts; part++) {
            double mean = means[porder][part];
            // optimal_rice_params (format/rice.py:38-53)
            int32_t k2;
            double rho = 1.0 / (1.0 + mean);
            double omr = 1.0 - rho;
            if (omr <= 0.0) {
                k2 = 0;
            } else {
                double ratio = kLogOptx / std::log(omr);
                if (ratio <= 0.0) {
                    k2 = 0;
                } else {
                    double k2f = std::floor(std::log(ratio) * kInvLoge2);
                    k2 = k2f < 0.0 ? 0 : static_cast<int32_t>(k2f);
                }
            }
            k2_cur[part] = k2;
            const uint32_t k1 = static_cast<uint32_t>(k2) + 1;
            const uint32_t* pu = u.data() + part * nsmpl;
            if (k2 <= 30) {
                // all terms fit uint32 and the sum is taken mod 2^32
                // anyway, so accumulate in uint32 — branchless and
                // autovectorizable (16 lanes), exact by ring arithmetic
                const uint32_t k1p = uint32_t(1) << k1;
                const uint32_t small_cost = k1 + 1;
                const uint32_t base = static_cast<uint32_t>(k2) + 2;
                uint32_t t32 = 0;
                for (int64_t i = 0; i < nsmpl; i++) {
                    const uint32_t v = pu[i];
                    t32 += (v < k1p) ? small_cost
                                     : (((v - k1p) >> k2) + base);
                }
                bits += t32;
            } else {  // k1 = 32: 1 << k1 needs the 64-bit form
                const uint64_t k1pow = uint64_t(1) << k1;
                uint64_t total = 0;
                for (int64_t i = 0; i < nsmpl; i++) {
                    uint64_t v = pu[i];
                    total += (v < k1pow) ? (k1 + 1)
                                         : (((v - k1pow) >> k2) + (k2 + 2));
                }
                bits += static_cast<uint32_t>(total);
            }
            if (part == 0) {
                bits += 5;  // RICE_PARAMETER_BITS
            } else {
                int32_t delta = k2 - prevk2;
                uint32_t zz = (static_cast<uint32_t>(delta) << 1) ^
                              static_cast<uint32_t>(delta >> 31);
                // gamma bits: 1 for 0, else 2*bit_length(zz+1) - 1
                bits += (zz == 0)
                    ? 1u
                    : (2u * (32 - linne_clz32(zz + 1)) - 1u);
            }
            prevk2 = k2;
        }
        // porder 0 seeds unconditionally: a wrapped total can equal the
        // 0xFFFFFFFF initializer, which must still produce valid params
        if (porder == 0 || min_bits > bits) {
            min_bits = bits;
            best_porder = porder;
            k2_best = k2_cur;
        }
    }
    for (size_t i = 0; i < k2_best.size(); i++) k2s[i] = k2_best[i];
    return best_porder;
}

// Encoder-side integer predict stage. Unlike decode synthesis this is a
// pure FIR (reads only `data`, linne_lpc_predict.c:7-38), so the time axis
// vectorizes directly: lane l carries sample t+l, every op is wrapping
// int32 (mullo/add/sra match the scalar's -fwrapv arithmetic exactly, so
// the SIMD path is bit-equal by construction).
void linne_predict_layer(const int32_t* data, int32_t* residual, int32_t n,
                         const int32_t* coef, int32_t order, int32_t rshift,
                         int32_t num_units) {
    std::memcpy(residual, data, sizeof(int32_t) * n);
    int npu = order / num_units;
    int ns = n / num_units;
    if (ns <= npu) return;
    // corrupt streams may carry rshift=0 (4-bit field); 1<<-1 is UB
    int32_t half = rshift >= 1 ? (1 << (rshift - 1)) : 0;
    for (int u = 0; u < num_units; u++) {
        const int32_t* in = data + u * ns;
        int32_t* out = residual + u * ns;
        const int32_t* c = coef + u * npu;
        const int nres = ns - npu;
        int t = 0;
#if defined(__AVX512F__)
        {
            const __m512i vhalf = _mm512_set1_epi32(half);
            const __m128i vsh = _mm_cvtsi32_si128(rshift);
            for (; t + 16 <= nres; t += 16) {
                __m512i pred = vhalf;
                for (int j = 0; j < npu; j++) {
                    pred = _mm512_add_epi32(
                        pred, _mm512_mullo_epi32(
                                  _mm512_set1_epi32(c[j]),
                                  _mm512_loadu_si512(
                                      (const void*)(in + t + j))));
                }
                __m512i cur = _mm512_loadu_si512((const void*)(out + t + npu));
                _mm512_storeu_si512(
                    (void*)(out + t + npu),
                    _mm512_add_epi32(cur, _mm512_sra_epi32(pred, vsh)));
            }
        }
#endif
        for (; t < nres; t++) {
            int32_t pred = half;
            for (int j = 0; j < npu; j++) pred += c[j] * in[t + j];
            out[t + npu] += pred >> rshift;
        }
    }
}

// 4-bit pre-emphasis coefficient from the lag-0/lag-1 autocorrelation of
// int32 samples, one fused pass (oracle:
// exact/filters.py:preemphasis_calculate_coefficient; reference:
// linne_utility.c:158-193). Each corr is its own serial f64 chain with
// per-term rounded multiplies — same sequence as the oracle's
// mul-then-cumsum (the two chains are independent, so they interleave
// without reordering either). Starting at 0.0 is bit-neutral: corr0's
// terms are squares (never -0.0 first) and an all-zero corr1 only occurs
// when corr0 == 0.0, which short-circuits to coef = 0.
LINNE_EXACT_FP
int32_t linne_preemph_coef(const int32_t* x, int64_t n) {
    if (n <= 1) return 0;
    double c0 = 0.0, c1 = 0.0;
    for (int64_t i = 0; i + 1 < n; i++) {
        const double d = (double)x[i];
        c0 += d * d;
        c1 += d * (double)x[i + 1];
    }
    if (c0 < 1e-6) return 0;
    const double r = c1 / c0;
    if (r < 0.0) return 0;
    const double scaled = r * 32.0;  // pow(2.0f, 5)
    const double rounded = std::floor(scaled + 0.5);  // r >= 0 here
    // clamp before the int cast: the ratio can exceed int32 range (growing
    // signals), where the oracle's arbitrary-precision int still clamps
    if (rounded >= 16.0) return 15;  // (1 << (PREEMPH_COEF_SHIFT - 1)) - 1
    return (int32_t)rounded;
}

}  // extern "C"

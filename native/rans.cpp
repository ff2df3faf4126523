// Interleaved-state rANS Nx16 codec (see rans.h for format notes).
//
// This is an original implementation written for fqzcomp5-tpu from the
// wire-format behaviour of htscodecs' rANS_static4x16pr family
// (rANS_static4x16pr.c, rANS_static32x16pr.c, rANS_static16_int.h,
// rANS_word.h, pack.c, rle.c).  Every encoder decision that affects
// output bytes (frequency normalisation rounding, 10-vs-12-bit shift
// estimation, tie-breaking, transform fallbacks) matches the reference.

#include "rans.h"

#include <cmath>
#include <cstring>

#if defined(__SSE2__)
#include <immintrin.h>
#include <ctime>
#include <cstdio>
#include <cstdlib>
#include <memory>
#endif

namespace fqz5 {
namespace {

#if defined(__SSE2__)
// Transpose a 16x16 byte tile with the classic 4-level unpack network:
// src rows are 16 bytes at stride src_stride; dst rows land at stride
// dst_stride.  Used to un-transpose the SIMD O1 decoder's (isz x 32)
// lane buffer — a scalar byte-strided walk re-reads every cache line
// 32 times and was the dominant cost of the X_32 order-1 decode path.
inline void transpose16x16(const uint8_t* src, size_t src_stride,
                           uint8_t* dst, size_t dst_stride) {
    __m128i v[16];
    for (int r = 0; r < 16; r++)
        v[r] = _mm_loadu_si128(
            (const __m128i*)(src + size_t(r) * src_stride));
    __m128i w[16];
    for (int r = 0; r < 8; r++) {
        w[2 * r] = _mm_unpacklo_epi8(v[2 * r], v[2 * r + 1]);
        w[2 * r + 1] = _mm_unpackhi_epi8(v[2 * r], v[2 * r + 1]);
    }
    for (int r = 0; r < 4; r++) {
        v[4 * r] = _mm_unpacklo_epi16(w[4 * r], w[4 * r + 2]);
        v[4 * r + 1] = _mm_unpackhi_epi16(w[4 * r], w[4 * r + 2]);
        v[4 * r + 2] = _mm_unpacklo_epi16(w[4 * r + 1], w[4 * r + 3]);
        v[4 * r + 3] = _mm_unpackhi_epi16(w[4 * r + 1], w[4 * r + 3]);
    }
    for (int r = 0; r < 2; r++) {
        w[8 * r] = _mm_unpacklo_epi32(v[8 * r], v[8 * r + 4]);
        w[8 * r + 1] = _mm_unpackhi_epi32(v[8 * r], v[8 * r + 4]);
        w[8 * r + 2] = _mm_unpacklo_epi32(v[8 * r + 1], v[8 * r + 5]);
        w[8 * r + 3] = _mm_unpackhi_epi32(v[8 * r + 1], v[8 * r + 5]);
        w[8 * r + 4] = _mm_unpacklo_epi32(v[8 * r + 2], v[8 * r + 6]);
        w[8 * r + 5] = _mm_unpackhi_epi32(v[8 * r + 2], v[8 * r + 6]);
        w[8 * r + 6] = _mm_unpacklo_epi32(v[8 * r + 3], v[8 * r + 7]);
        w[8 * r + 7] = _mm_unpackhi_epi32(v[8 * r + 3], v[8 * r + 7]);
    }
    for (int r = 0; r < 8; r++) {
        v[2 * r] = _mm_unpacklo_epi64(w[r], w[r + 8]);
        v[2 * r + 1] = _mm_unpackhi_epi64(w[r], w[r + 8]);
    }
    for (int r = 0; r < 16; r++)
        _mm_storeu_si128((__m128i*)(dst + size_t(r) * dst_stride),
                         v[r]);
}
#endif  // __SSE2__

// ---------------------------------------------------------------------
// Order-byte flags (file format, rANS_static4x16.h:66-103)
constexpr int kPack = 0x80;
constexpr int kRle = 0x40;
constexpr int kCat = 0x20;
constexpr int kNosz = 0x10;
constexpr int kStripe = 0x08;
constexpr int kX32 = 0x04;
constexpr int kStripeNo0 = 1 << 16;
constexpr int kSimdAuto = 1 << 17;

constexpr int kShift = 12;            // TF_SHIFT (order-0)
constexpr uint32_t kTot = 1u << kShift;
extern "C" int fqz5_have_avx2();
extern "C" int fqz5_have_avx512();

// Decode-tier pick: FQZ5_DEC_SIMD=avx2|avx512 overrides (the decode
// walks' emulated-gather AVX2 form and the expand-renorm AVX-512 form
// trade blows within a few % depending on table size; the duel
// harness sweeps both).
static int fqz5_dec_avx512() {
    static int v = -1;
    if (v < 0) {
        const char* e = getenv("FQZ5_DEC_SIMD");
        if (e && !strcmp(e, "avx2"))
            v = 0;
        else
            v = fqz5_have_avx512();
    }
    return v;
}
extern "C" void fqz5_simd512_dec_o0_32(const uint32_t*, int,
                                       const uint8_t**, const uint8_t*,
                                       uint32_t*, uint8_t*, uint32_t);
extern "C" void fqz5_simd512_dec_o1_32(const uint32_t*, int,
                                       const uint8_t**,
                                       const uint8_t*, uint32_t*,
                                       uint8_t*, uint8_t*, uint32_t);
extern "C" void fqz5_simd512_enc_o0_32(const uint8_t*, uint32_t,
                                       const uint32_t*, const uint32_t*,
                                       const uint32_t*, const uint32_t*,
                                       uint32_t*, uint8_t**);
extern "C" void fqz5_simd512_enc_o1_32(const uint8_t*, uint32_t,
                                       int64_t, const uint8_t*,
                                       const uint32_t*, const uint32_t*,
                                       const uint32_t*, const uint32_t*,
                                       uint32_t*, uint8_t**);
extern "C" void fqz5_simd_dec_o0_32(const uint32_t*, int, const uint8_t**,
                                    const uint8_t*, uint32_t*, uint8_t*,
                                    uint32_t);
extern "C" void fqz5_simd_dec_o1_32(const uint32_t*, int,
                                    const uint8_t**, const uint8_t*,
                                    uint32_t*, uint8_t*, uint8_t*,
                                    uint32_t);

constexpr int kShiftO1 = 12;          // TF_SHIFT_O1
constexpr int kShiftO1Fast = 10;      // TF_SHIFT_O1_FAST
constexpr uint32_t kRansL = 1u << 15; // RANS_BYTE_L

// ---------------------------------------------------------------------
// varints (big-endian base-128; htscodecs/varint.h)
int put_uv(uint8_t* cp, uint32_t v) {
    uint8_t tmp[8];
    int n = 0;
    tmp[n++] = v & 0x7f;
    while (v >>= 7) tmp[n++] = uint8_t(v & 0x7f) | 0x80;
    for (int i = 0; i < n; i++) cp[i] = tmp[n - 1 - i];
    return n;
}

int get_uv(const uint8_t* cp, const uint8_t* end, uint32_t* v) {
    uint32_t j = 0;
    int n = 5;
    const uint8_t* op = cp;
    uint8_t c;
    do {
        if (cp >= end) return 0;
        c = *cp++;
        j = (j << 7) | (c & 0x7f);
    } while ((c & 0x80) && n-- > 0);
    *v = j;
    return int(cp - op);
}

// ---------------------------------------------------------------------
// Frequency normalisation (rANS_static16_int.h:97-163)
uint32_t round2(uint32_t v) {
    v--;
    v |= v >> 1; v |= v >> 2; v |= v >> 4; v |= v >> 8; v |= v >> 16;
    return v + 1;
}

int normalise_freq(uint32_t* F, int size, uint32_t tot) {
    if (!size) return 0;
    int loop = 0;
    for (;;) {
        uint64_t tr = ((uint64_t(tot) << 31) / size) + ((1u << 30) / size);
        int m = 0, M = 0;
        size = 0;
        for (int j = 0; j < 256; j++) {
            if (!F[j]) continue;
            if (m < int(F[j])) m = F[j], M = j;
            if ((F[j] = uint32_t((F[j] * tr) >> 31)) == 0) F[j] = 1;
            size += F[j];
        }
        int adjust = int(tot) - size;
        if (adjust > 0) {
            F[M] += adjust;
        } else if (adjust < 0) {
            if (int(F[M]) > -adjust && (loop == 1 || int(F[M]) / 2 >= -adjust)) {
                F[M] += adjust;
            } else {
                if (loop < 1) {
                    loop++;
                    continue;  // retry with already-scaled freqs
                }
                adjust += F[M] - 1;
                F[M] = 1;
                for (int j = 0; adjust && j < 256; j++) {
                    if (F[j] < 2) continue;
                    int d = int(F[j]) > -adjust;
                    int mv = d ? adjust : 1 - int(F[j]);
                    F[j] += mv;
                    adjust -= mv;
                }
            }
        }
        return F[M] > 0 ? 0 : -1;
    }
}

void normalise_freq_shift(uint32_t* F, uint32_t size, uint32_t max_tot) {
    if (size == 0 || size == max_tot) return;
    int shift = 0;
    while (size < max_tot) size *= 2, shift++;
    for (int i = 0; i < 256; i++) F[i] <<= shift;
}

// ---------------------------------------------------------------------
// Alphabet & frequency (de)serialization (rANS_static16_int.h:165-276)
int encode_alphabet(uint8_t* cp, const uint32_t* F) {
    uint8_t* op = cp;
    int rle = 0;
    for (int j = 0; j < 256; j++) {
        if (!F[j]) continue;
        if (rle) {
            rle--;
        } else {
            *cp++ = uint8_t(j);
            if (!rle && j && F[j - 1]) {
                for (rle = j + 1; rle < 256 && F[rle]; rle++)
                    ;
                rle -= j + 1;
                *cp++ = uint8_t(rle);
            }
        }
    }
    *cp++ = 0;
    return int(cp - op);
}

int decode_alphabet(const uint8_t* cp, const uint8_t* cp_end, uint32_t* F) {
    // NB: do-while — a leading 0 byte is symbol 0 (always present as the
    // order-1 terminator context), not an empty alphabet.
    if (cp == cp_end) return 0;
    const uint8_t* op = cp;
    int rle = 0;
    int j = *cp++;
    if (cp + 2 < cp_end) {
        do {
            F[j] = 1;
            if (!rle && j + 1 == *cp) {
                j = *cp++;
                rle = *cp++;
            } else if (rle) {
                rle--;
                j++;
                if (j > 255) return 0;
            } else {
                j = *cp++;
            }
        } while (j && cp + 2 < cp_end);
    }
    if (j) {
        do {
            F[j] = 1;
            if (cp >= cp_end) return 0;
            if (!rle && j + 1 == *cp) {
                if (cp + 1 >= cp_end) return 0;
                j = *cp++;
                rle = *cp++;
            } else if (rle) {
                rle--;
                j++;
                if (j > 255) return 0;
            } else {
                if (cp >= cp_end) return 0;
                j = *cp++;
            }
        } while (j && cp < cp_end);
    }
    return int(cp - op);
}

int encode_freq(uint8_t* cp, const uint32_t* F) {
    uint8_t* op = cp;
    cp += encode_alphabet(cp, F);
    for (int j = 0; j < 256; j++)
        if (F[j]) cp += put_uv(cp, F[j]);
    return int(cp - op);
}

int decode_freq(const uint8_t* cp, const uint8_t* cp_end, uint32_t* F,
                uint32_t* fsum) {
    if (cp == cp_end) return 0;
    const uint8_t* op = cp;
    int asz = decode_alphabet(cp, cp_end, F);
    if (!asz) return 0;
    cp += asz;
    uint32_t tot = 0;
    for (int j = 0; j < 256; j++) {
        if (F[j]) {
            int n = get_uv(cp, cp_end, &F[j]);
            if (!n) return 0;
            cp += n;
            tot += F[j];
        }
    }
    *fsum = tot;
    return int(cp - op);
}

// Order-1 row serialization, zero runs collapsed (encode_freq_d)
int encode_freq_row(uint8_t* cp, const uint32_t* present, const uint32_t* F) {
    uint8_t* op = cp;
    int dz = 0;
    for (int j = 0; j < 256; j++) {
        if (!present[j]) continue;
        if (F[j] != 0) {
            if (dz) {
                cp -= dz - 1;
                *cp++ = uint8_t(dz - 1);
            }
            dz = 0;
            cp += put_uv(cp, F[j]);
        } else {
            dz++;
            *cp++ = 0;
        }
    }
    if (dz) {
        cp -= dz - 1;
        *cp++ = uint8_t(dz - 1);
    }
    return int(cp - op);
}

int decode_freq_row(const uint8_t* cp, const uint8_t* cp_end,
                    const uint32_t* present, uint32_t* F, uint32_t* total) {
    if (cp == cp_end) return 0;
    const uint8_t* op = cp;
    int dz = 0;
    uint32_t T = 0;
    for (int j = 0; j < 256 && cp < cp_end; j++) {
        if (!present[j]) continue;
        uint32_t f;
        if (dz) {
            f = 0;
            dz--;
        } else {
            if (cp >= cp_end) return 0;
            int n = get_uv(cp, cp_end, &f);
            if (!n) return 0;
            cp += n;
            if (f == 0) {
                if (cp >= cp_end) return 0;
                dz = *cp++;
            }
        }
        F[j] = f;
        T += f;
    }
    if (total) *total = T;
    return int(cp - op);
}

// ---------------------------------------------------------------------
// 10-vs-12 bit shift estimator (rANS_static4x16pr.c:357-420).
// fast_log is the reference's bit-trick approximation (utils.h:69-72);
// the estimate feeds a stored format decision so it must match exactly.
double fast_log(double a) {
    union { double d; long long x; } u = {a};
    return (u.x - 4606921278410026770LL) * 1.539095918623324e-16;
}

int compute_shift(const uint32_t* F0, uint32_t (*F)[256], const uint32_t* T,
                  uint32_t* S) {
    double e10 = 0, e12 = 0;
    int max_tot = 0;
    for (int i = 0; i < 256; i++) {
        if (F0[i] == 0) continue;
        unsigned int max_val = round2(T[i]);
        int ns = 0;
        int sm10 = 0, sm12 = 0;
        for (int j = 0; j < 256; j++) {
            if (F[i][j] && max_val / F[i][j] > (1u << kShiftO1Fast)) sm10++;
            if (F[i][j] && max_val / F[i][j] > (1u << kShiftO1)) sm12++;
        }
        double l10 = log((1 << kShiftO1Fast) + sm10);
        double l12 = log((1 << kShiftO1) + sm12);
        double T_slow = double(1 << kShiftO1) / T[i];
        double T_fast = double(1 << kShiftO1Fast) / T[i];
        for (int j = 0; j < 256; j++) {
            if (F[i][j]) {
                ns++;
                double ff = F[i][j];
                double v10 = ff * T_fast, v12 = ff * T_slow;
                e10 -= ff * (fast_log(v10 > 1 ? v10 : 1) - l10);
                e12 -= ff * (fast_log(v12 > 1 ? v12 : 1) - l12);
                e10 += 1.3;
                e12 += 4.7;
            }
        }
        if (ns < 64 && max_val > 128) max_val /= 2;
        if (max_val > 1024) max_val /= 2;
        if (max_val > (1u << kShiftO1)) max_val = 1u << kShiftO1;
        S[i] = max_val;
        if (max_tot < int(max_val)) max_tot = max_val;
    }
    return (e10 / e12 < 1.01 || max_tot <= (1 << kShiftO1Fast))
               ? kShiftO1Fast
               : kShiftO1;
}

// ---------------------------------------------------------------------
// Core rANS state ops (rANS_word.h)
struct EncSym {
    uint32_t x_max;
    uint32_t rcp;       // ceil(2^(31+sh) / freq), freq >= 2
    uint32_t bias;
    uint16_t cmpl;      // (1<<scale_bits) - freq
    uint16_t rcp_shift;
};

inline void enc_sym_init(EncSym& s, uint32_t start, uint32_t freq,
                         uint32_t scale_bits) {
    // reciprocal-multiply division (rANS_word.h:195-260 scheme): for
    // freq >= 2, q = mulhi32(x, rcp) >> rcp_shift is the exact floor
    // quotient; freq == 1 divides exactly via rcp = 2^32-1, bias+x.
    s.x_max = ((kRansL >> scale_bits) << 16) * freq - 1;
    s.cmpl = uint16_t((1u << scale_bits) - freq);
    if (freq < 2) {
        s.rcp = ~0u;
        s.rcp_shift = 0;
        s.bias = start + (1u << scale_bits) - 1;
    } else {
        uint32_t sh = 0;
        while (freq > (1u << sh)) sh++;
        s.rcp = uint32_t(((uint64_t(1) << (sh + 31)) + freq - 1) / freq);
        s.rcp_shift = uint16_t(sh - 1);
        s.bias = start;
    }
}

inline void enc_put(uint32_t& x, uint8_t*& ptr, const EncSym& s) {
    if (x > s.x_max) {
        ptr -= 2;
        ptr[0] = uint8_t(x);
        ptr[1] = uint8_t(x >> 8);
        x >>= 16;
    }
    uint32_t q = uint32_t((uint64_t(x) * s.rcp) >> 32) >> s.rcp_shift;
    x = x + s.bias + q * s.cmpl;
}

// Branchless renorm variant for the hot encode walks: the 2-byte
// store is unconditional (always lands in the stream gap below ptr —
// callers encode from the end of a generously-bounded buffer) and the
// pointer advances arithmetically.  On high-entropy streams (quals,
// PACK'd DNA) renorm cadence is irregular, so the predicted branch in
// enc_put mispredicts ~once per 2 symbols; this form has no branch at
// all (the reference's HTSCODECS_LITTLE_ENDIAN scheme,
// rANS_word.h:287-308).
inline void enc_put_bl(uint32_t& x, uint8_t*& ptr, const EncSym& s) {
    memcpy(ptr - 2, &x, 2);      // little-endian low 16 bits
    uint32_t gt = uint32_t(x > s.x_max);   // setcc, no jump
    ptr -= 2 * gt;
    x >>= 16 * gt;               // variable shift keeps it branchless
    uint32_t q = uint32_t((uint64_t(x) * s.rcp) >> 32) >> s.rcp_shift;
    x = x + s.bias + q * s.cmpl;
}

inline void enc_flush(uint32_t x, uint8_t*& ptr) {
    ptr -= 4;
    ptr[0] = uint8_t(x);
    ptr[1] = uint8_t(x >> 8);
    ptr[2] = uint8_t(x >> 16);
    ptr[3] = uint8_t(x >> 24);
}

inline uint32_t dec_init(const uint8_t*& ptr) {
    uint32_t x = uint32_t(ptr[0]) | (uint32_t(ptr[1]) << 8) |
                 (uint32_t(ptr[2]) << 16) | (uint32_t(ptr[3]) << 24);
    ptr += 4;
    return x;
}

inline void dec_renorm(uint32_t& x, const uint8_t*& ptr,
                       const uint8_t* limit) {
    if (x < kRansL && ptr + 1 < limit) {
        x = (x << 16) | (uint32_t(ptr[0]) | (uint32_t(ptr[1]) << 8));
        ptr += 2;
    }
}

// Unchecked 16-bit renorm for the fast walks (caller guarantees >= 2
// readable bytes).  gcc lowers the ternary to a branch; on real
// genomic streams the renorm cadence is near-periodic (symbol
// frequencies cluster), so the predicted branch beats forced cmovs
// (measured: an asm-cmov variant ran 25% SLOWER on DNA O0).
inline void dec_renorm16(uint32_t& x, const uint8_t*& cp) {
    uint16_t w;
    memcpy(&w, cp, 2);  // single little-endian 16-bit load
    uint32_t adv = (x < kRansL) * 2;
    uint32_t x2 = (x << 16) | w;
    x = adv ? x2 : x;
    cp += adv;
}

// ---------------------------------------------------------------------
// Order-0 Nx16 core (payload = freq table + rANS stream)

// Free-standing flattened encode walks (NOT inlined into the big
// template bodies): inside rans_enc_o0/o1 gcc runs out of registers
// and spills the states/pointers to the stack, reloading them per
// symbol — the identical loop measured 546 MB/s free-standing vs
// ~190 MB/s inlined on 20MB of qualities.  Same fix as the decode
// side's rans_o1_walk4.
__attribute__((noinline, optimize("no-tree-vectorize",
                                  "no-tree-slp-vectorize")))
static uint8_t* enc_walk4_o0(const uint8_t* in, uint32_t n4,
                             const EncSym* syms, uint32_t* R,
                             uint8_t* ptr) {
    uint32_t r0 = R[0], r1 = R[1], r2 = R[2], r3 = R[3];
    for (uint32_t i = n4; i > 0; i -= 4) {
        const EncSym& s3 = syms[in[i - 1]];
        const EncSym& s2 = syms[in[i - 2]];
        const EncSym& s1 = syms[in[i - 3]];
        const EncSym& s0 = syms[in[i - 4]];
        enc_put_bl(r3, ptr, s3);
        enc_put_bl(r2, ptr, s2);
        enc_put_bl(r1, ptr, s1);
        enc_put_bl(r0, ptr, s0);
    }
    R[0] = r0; R[1] = r1; R[2] = r2; R[3] = r3;
    return ptr;
}

__attribute__((noinline, optimize("no-tree-vectorize",
                                  "no-tree-slp-vectorize")))
static uint8_t* enc_walk4_o1(const uint8_t* in, const EncSym (*syms)[256],
                             uint32_t* R, int64_t* iN, uint8_t* lN,
                             uint8_t* ptr) {
    uint32_t r0 = R[0], r1 = R[1], r2 = R[2], r3 = R[3];
    int64_t i0 = iN[0], i1 = iN[1], i2 = iN[2], i3 = iN[3];
    uint8_t l0 = lN[0], l1 = lN[1], l2 = lN[2], l3 = lN[3];
    for (; i0 >= 0; i0--, i1--, i2--, i3--) {
        uint8_t c3 = in[i3], c2 = in[i2], c1 = in[i1], c0 = in[i0];
        const EncSym& s3 = syms[c3][l3];
        const EncSym& s2 = syms[c2][l2];
        const EncSym& s1 = syms[c1][l1];
        const EncSym& s0 = syms[c0][l0];
        enc_put_bl(r3, ptr, s3);
        enc_put_bl(r2, ptr, s2);
        enc_put_bl(r1, ptr, s1);
        enc_put_bl(r0, ptr, s0);
        l3 = c3; l2 = c2; l1 = c1; l0 = c0;
    }
    enc_put(r3, ptr, syms[0][l3]);
    enc_put(r2, ptr, syms[0][l2]);
    enc_put(r1, ptr, syms[0][l1]);
    enc_put(r0, ptr, syms[0][l0]);
    R[0] = r0; R[1] = r1; R[2] = r2; R[3] = r3;
    return ptr;
}

// 4-way split order-0 histogram: a single table serializes on
// store->load forwarding when the same symbol recurs (always, for
// 40-symbol quality data); independent sub-tables count in parallel
// issue slots (reference utils.h hist8 idea).
//
// Large inputs count u16 PAIRS instead (reference hist8's >500KB
// branch, utils.h:146-178): half the increments per byte, and on real
// section data the live pair set is tiny (46 qual symbols -> ~2K hot
// entries), so the 3x256KB tables stay cache-resident.  Measured:
// the byte-wise form was the bulk of a 1.33x O0-encode gap vs the
// reference on a 24MB quality payload (tools/oracle/duel.c).
inline void hist4(const uint8_t* in, uint32_t in_size, uint32_t* F) {
    if (in_size > 500000) {
        static thread_local std::unique_ptr<uint32_t[]> pairs;
        constexpr size_t kPer = 65536 + 37;   // +37: avoid 4K aliasing
        if (!pairs) pairs.reset(new uint32_t[3 * kPer]);
        uint32_t* f0 = pairs.get();
        uint32_t* f1 = f0 + kPer;
        uint32_t* f2 = f1 + kPer;
        memset(f0, 0, 3 * kPer * sizeof(uint32_t));
        uint32_t i = 0, i16 = in_size & ~15u;
        for (; i < i16; i += 16) {
            uint16_t a[4], b[4];
            memcpy(a, in + i, 8);
            f0[a[0]]++;
            f1[a[1]]++;
            f2[a[2]]++;
            f0[a[3]]++;
            memcpy(b, in + i + 8, 8);
            f1[b[0]]++;
            f0[b[1]]++;
            f1[b[2]]++;
            f2[b[3]]++;
        }
        for (; i < in_size; i++) F[in[i]]++;
        for (uint32_t j = 0; j < 65536; j++) {
            uint32_t c = f0[j] + f1[j] + f2[j];
            if (c) {
                F[j & 0xff] += c;
                F[j >> 8] += c;
            }
        }
        return;
    }
    uint32_t h[7][256] = {{0}};
    uint32_t i = 0;
    for (; i + 8 <= in_size; i += 8) {
        F[in[i]]++;
        h[0][in[i + 1]]++;
        h[1][in[i + 2]]++;
        h[2][in[i + 3]]++;
        h[3][in[i + 4]]++;
        h[4][in[i + 5]]++;
        h[5][in[i + 6]]++;
        h[6][in[i + 7]]++;
    }
    for (; i < in_size; i++) F[in[i]]++;
    for (int j = 0; j < 256; j++)
        F[j] += h[0][j] + h[1][j] + h[2][j] + h[3][j] + h[4][j]
                + h[5][j] + h[6][j];
}

// Zero-copy core-encode result: table and stream spans into the
// per-template thread-local arena (valid until the next call of the
// same core on this thread).  Callers assemble [tab][stream] directly
// into their destination — the old per-call vector staging cost two
// extra full-payload copies on the hot plain-order path.
struct EncSpans {
    const uint8_t* tab = nullptr;
    size_t tab_len = 0;
    const uint8_t* stream = nullptr;
    size_t stream_len = 0;
    size_t size() const { return tab_len + stream_len; }
};

template <int N>
bool rans_enc_o0_sp(const uint8_t* in, uint32_t in_size, EncSpans& eo) {
    // worst case: all renorms + flush + table.  The walk writes into
    // a reused thread-local arena (malloc'd, never zero-initialised:
    // a fresh vector resize memsets the whole bound — ~5ms per 20MB
    // call for bytes the stream immediately overwrites).
    size_t bound = size_t(in_size) + in_size / 2 + N * 4 + 1024 + 16;
    static thread_local std::unique_ptr<uint8_t[]> arena;
    static thread_local size_t arena_cap = 0;
    if (arena_cap < bound) {
        arena.reset(new uint8_t[bound]);
        arena_cap = bound;
    }
    if (in_size == 0) {
        eo = EncSpans{};
        return true;
    }
    uint32_t F[256 + 8] = {0};
    hist4(in, in_size, F);

    uint32_t fsum = in_size;
    uint32_t max_val = round2(fsum);
    if (max_val > kTot) max_val = kTot;
    if (normalise_freq(F, fsum, max_val) < 0) return false;
    fsum = max_val;

    uint8_t* tab = arena.get();
    int tab_size = encode_freq(tab, F);
    if (normalise_freq(F, fsum, kTot) < 0) return false;

    EncSym syms[256];
    for (int j = 0, x = 0; j < 256; j++) {
        if (F[j]) {
            enc_sym_init(syms[j], x, F[j], kShift);
            x += F[j];
        }
    }

    uint8_t* base = arena.get();
    uint8_t* end = base + bound;
    uint8_t* ptr = end;
    uint32_t R[N];
    for (int z = 0; z < N; z++) R[z] = kRansL;

    int rem = in_size & (N - 1);
    for (int z = rem - 1; z >= 0; z--)
        enc_put(R[z], ptr, syms[in[in_size - rem + z]]);
    if (N == 32 && fqz5_have_avx512() && in_size >= 32) {
        alignas(64) uint32_t sxm[256], src_[256], sbi[256], scr[256];
        for (int j = 0; j < 256; j++) {
            sxm[j] = syms[j].x_max;
            src_[j] = syms[j].rcp;
            sbi[j] = syms[j].bias;
            scr[j] = uint32_t(syms[j].cmpl) |
                     (uint32_t(syms[j].rcp_shift) << 16);
        }
        fqz5_simd512_enc_o0_32(in, in_size & ~uint32_t(31), sxm, src_,
                               sbi, scr, R, &ptr);
    } else if (N == 4) {
        ptr = enc_walk4_o0(in, in_size & ~uint32_t(3), syms, R, ptr);
    } else {
        for (uint32_t i = in_size & ~uint32_t(N - 1); i > 0; i -= N)
            for (int z = N - 1; z >= 0; z--)
                enc_put(R[z], ptr, syms[in[i - N + z]]);
    }
    for (int z = N - 1; z >= 0; z--) enc_flush(R[z], ptr);

    eo.tab = base;
    eo.tab_len = size_t(tab_size);
    eo.stream = ptr;
    eo.stream_len = size_t(end - ptr);
    return true;
}

template <int N>
bool rans_enc_o0(const uint8_t* in, uint32_t in_size,
                 std::vector<uint8_t>& out) {
    EncSpans eo;
    if (!rans_enc_o0_sp<N>(in, in_size, eo)) return false;
    out.clear();
    out.reserve(eo.size());
    out.insert(out.end(), eo.tab, eo.tab + eo.tab_len);
    out.insert(out.end(), eo.stream, eo.stream + eo.stream_len);
    return true;
}

// 4-state unrolled O0 decode main walk, free-standing for the same
// register-allocation reason as the encode walks; the renorm bound
// check hoists to once per group (8 renorms consume <= 16 bytes) and
// the renorm itself is branchless (reference
// rANS_static4x16pr.c:309-352, rANS_word.h cmov).
__attribute__((noinline, optimize("no-tree-vectorize",
                                  "no-tree-slp-vectorize")))
static uint32_t dec_walk4_o0(const uint8_t* ssym, const uint16_t* sfreq,
                             const uint16_t* sbase, const uint8_t** cpp,
                             const uint8_t* limit, uint32_t* R,
                             uint8_t* out, uint32_t out_sz) {
    constexpr uint32_t mask = kTot - 1;
    const uint8_t* cp = *cpp;
    uint32_t R0 = R[0], R1 = R[1], R2 = R[2], R3 = R[3];
    const uint8_t* fast_lim = limit - 16;  // 8 renorms per iter
    uint32_t main_sz = out_sz & ~7u;
    uint32_t i = 0;
    for (; i < main_sz && cp < fast_lim; i += 8) {
        for (uint32_t j = 0; j < 8; j += 4) {
            uint32_t m0 = R0 & mask, m1 = R1 & mask;
            out[i + j] = ssym[m0];
            out[i + j + 1] = ssym[m1];
            R0 = sfreq[m0] * (R0 >> kShift) + sbase[m0];
            R1 = sfreq[m1] * (R1 >> kShift) + sbase[m1];
            uint32_t m2 = R2 & mask, m3 = R3 & mask;
            dec_renorm16(R0, cp);
            dec_renorm16(R1, cp);
            R2 = sfreq[m2] * (R2 >> kShift) + sbase[m2];
            R3 = sfreq[m3] * (R3 >> kShift) + sbase[m3];
            dec_renorm16(R2, cp);
            dec_renorm16(R3, cp);
            out[i + j + 2] = ssym[m2];
            out[i + j + 3] = ssym[m3];
        }
    }
    R[0] = R0; R[1] = R1; R[2] = R2; R[3] = R3;
    *cpp = cp;
    return i;
}

template <int N>
bool rans_dec_o0(const uint8_t* in, uint32_t in_size, uint8_t* out,
                 uint32_t out_sz) {
    if (in_size < 16) return false;
    const uint8_t* cp = in;
    const uint8_t* cp_end = in + in_size - 8;  // reference safety margin
    uint32_t F[256] = {0}, fsum = 0;
    int fsz = decode_freq(cp, cp_end, F, &fsum);
    if (!fsz) return false;
    cp += fsz;
    normalise_freq_shift(F, fsum, kTot);

    // Table layout per walk: the SIMD 32-way cores take the merged u32
    // s3 (one gather per symbol); the scalar walk takes SPLIT tables —
    // u8 symbol + u16 freq + u16 base per slot (20 KB, all L1) — so
    // the state update is two small loads and one multiply with no
    // field unpacking (reference rANS_static4x16pr.c:254-283).
    static thread_local std::vector<uint32_t> s3v;
    static thread_local std::vector<uint8_t> ssymv;
    static thread_local std::vector<uint16_t> sfv;
    uint32_t* s3 = nullptr;
    uint8_t* ssym = nullptr;
    uint16_t* sfreq = nullptr;
    uint16_t* sbase = nullptr;
    const bool use_simd =
        N == 32 && (fqz5_have_avx512() || fqz5_have_avx2());
    if (use_simd) {
        s3v.resize(kTot);
        s3 = s3v.data();
        uint32_t x = 0;
        for (int j = 0; j < 256; j++) {
            if (!F[j]) continue;
            if (F[j] > kTot - x) return false;
            uint32_t base = (F[j] << (kShift + 8)) | uint32_t(j);
            for (uint32_t y = 0; y < F[j]; y++, x++) s3[x] = base + (y << 8);
        }
        if (x != kTot) return false;
    } else {
        ssymv.resize(kTot);
        sfv.resize(2 * kTot);
        ssym = ssymv.data();
        sfreq = sfv.data();
        sbase = sfv.data() + kTot;
        uint32_t x = 0;
        for (int j = 0; j < 256; j++) {
            if (!F[j]) continue;
            if (F[j] > kTot - x) return false;
            memset(&ssym[x], j, F[j]);
            for (uint32_t y = 0; y < F[j]; y++, x++) {
                sfreq[x] = uint16_t(F[j]);
                sbase[x] = uint16_t(y);
            }
        }
        if (x != kTot) return false;
    }

    if (cp + 4 * N > in + in_size) return false;
    uint32_t R[N];
    const uint8_t* limit = in + in_size;
    for (int z = 0; z < N; z++) {
        R[z] = dec_init(cp);
        if (R[z] < kRansL) return false;
    }
    constexpr uint32_t mask = kTot - 1;
    uint32_t start = 0;
    if (N == 32 && fqz5_dec_avx512()) {
        uint32_t main_sz = out_sz & ~31u;
        fqz5_simd512_dec_o0_32(s3, kShift, &cp, limit, R, out, main_sz);
        start = main_sz;
    } else if (N == 32 && fqz5_have_avx2()) {
        uint32_t main_sz = out_sz & ~31u;
        fqz5_simd_dec_o0_32(s3, kShift, &cp, limit, R, out, main_sz);
        start = main_sz;
    } else if (N == 4) {
        start = dec_walk4_o0(ssym, sfreq, sbase, &cp, limit, R, out,
                             out_sz);
    }
    for (uint32_t i = start; i < out_sz; i++) {
        int z = i & (N - 1);
        uint32_t m = R[z] & mask;
        uint32_t f, b;
        if (use_simd) {
            uint32_t S = s3[m];
            out[i] = uint8_t(S);
            f = S >> (kShift + 8);
            b = (S >> 8) & mask;
        } else {
            out[i] = ssym[m];
            f = sfreq[m];
            b = sbase[m];
        }
        if (i + (N - z) <= out_sz) {  // all but trailing partial group
            R[z] = f * (R[z] >> kShift) + b;
            dec_renorm(R[z], cp, limit);
        }
    }
    return true;
}

// ---------------------------------------------------------------------
// Order-1 Nx16 core
template <int N>
bool rans_enc_o1_sp(const uint8_t* in, uint32_t in_size, EncSpans& eo) {
    if (N == 32 && in_size < uint32_t(N)) return false;
    size_t bound = size_t(in_size) + in_size / 2 + N * 8 + 257 * 257 * 3 + 64;
    // reused thread-local arena: a fresh vector resize would memset
    // the whole bound (see the O0 note)
    static thread_local std::unique_ptr<uint8_t[]> arena;
    static thread_local size_t arena_cap = 0;
    if (arena_cap < bound) {
        arena.reset(new uint8_t[bound]);
        arena_cap = bound;
    }

    static thread_local std::vector<uint32_t> Fbuf;
    Fbuf.assign(256 * 256, 0);
    uint32_t (*F)[256] = reinterpret_cast<uint32_t(*)[256]>(Fbuf.data());
    uint32_t T[256] = {0};

    // Order-1 histogram (utils.h hist1_4 semantics): ctx 0 precedes
    // in[0].  For large inputs the counts split across two tables so
    // consecutive (ctx,sym) increments hit different cache lines and
    // the store->load dependency chain on recurring pairs is halved.
    {
        uint8_t l = 0;
        uint32_t i = 0;
        if (in_size > 500000) {
            static thread_local std::vector<uint32_t> F2buf;
            F2buf.assign(256 * 256, 0);
            uint32_t (*F2)[256] =
                reinterpret_cast<uint32_t(*)[256]>(F2buf.data());
            for (; i + 4 <= in_size; i += 4) {
                uint8_t c0 = in[i], c1 = in[i + 1];
                uint8_t c2 = in[i + 2], c3 = in[i + 3];
                F[l][c0]++;
                F2[c0][c1]++;
                F[c1][c2]++;
                F2[c2][c3]++;
                l = c3;
            }
            for (; i < in_size; i++) {
                F[l][in[i]]++;
                l = in[i];
            }
            for (int r = 0; r < 256; r++)
                for (int j = 0; j < 256; j++) F[r][j] += F2[r][j];
        } else {
            for (; i < in_size; i++) {
                F[l][in[i]]++;
                l = in[i];
            }
        }
        T[l]++;  // final context gets a phantom count
        for (int r = 0; r < 256; r++) {
            uint32_t tt = 0;
            for (int j = 0; j < 256; j++) tt += F[r][j];
            T[r] += tt;
        }
    }
    uint32_t isz = in_size / N;
    for (int z = 1; z < N; z++) F[0][in[z * isz]]++;
    T[0] += N - 1;

    uint8_t* op = arena.get();
    uint8_t* cp = op;
    uint32_t tmp_T0 = T[0];
    T[0] = 1;
    *cp++ = 0;  // header marker (low bit set later if compressed)
    cp += encode_alphabet(cp, T);
    T[0] = tmp_T0;

    uint32_t S[256] = {0};
    int shift = compute_shift(T, F, T, S);

    static thread_local std::vector<EncSym> symv;
    symv.resize(256 * 256);
    EncSym (*syms)[256] = reinterpret_cast<EncSym(*)[256]>(symv.data());

    for (int i = 0; i < 256; i++) {
        if (T[i] == 0) continue;
        uint32_t max_val = S[i];
        if (shift == kShiftO1Fast && max_val > (1u << kShiftO1Fast))
            max_val = 1u << kShiftO1Fast;
        if (normalise_freq(F[i], T[i], max_val) < 0) return false;
        T[i] = max_val;
        cp += encode_freq_row(cp, T, F[i]);
        normalise_freq_shift(F[i], T[i], 1u << shift);
        T[i] = 1u << shift;
        for (int j = 0, x = 0; j < 256; j++) {
            enc_sym_init(syms[i][j], x, F[i][j], shift);
            x += F[i][j];
        }
    }

    *op = uint8_t(shift << 4);
    if (cp - op > 1000) {
        // try O0 compression of the table itself
        uint32_t u_sz = uint32_t(cp - (op + 1));
        std::vector<uint8_t> ctab;
        if (rans_enc_o0<4>(op + 1, u_sz, ctab) &&
            ctab.size() + 6 < size_t(cp - op)) {
            uint8_t hdr = *op | 1;
            uint8_t* p = op;
            *p++ = hdr;
            p += put_uv(p, u_sz);
            p += put_uv(p, uint32_t(ctab.size()));
            memcpy(p, ctab.data(), ctab.size());
            cp = p + ctab.size();
        }
    }
    size_t tab_size = size_t(cp - op);

    uint8_t* end = op + bound;
    uint8_t* ptr = end;
    uint32_t R[N];
    for (int z = 0; z < N; z++) R[z] = kRansL;

    int64_t iN[N];
    uint8_t lN[N];
    for (int z = 0; z < N; z++) {
        iN[z] = int64_t(z + 1) * isz - 2;
        lN[z] = in[iN[z] + 1];
    }
    // state N-1 takes the tail
    lN[N - 1] = in[in_size - 1];
    for (int64_t i = in_size - 2; i > int64_t(N) * isz - 2; i--) {
        uint8_t c = in[i];
        enc_put(R[N - 1], ptr, syms[c][lN[N - 1]]);
        lN[N - 1] = c;
    }
    if (N == 32) iN[N - 1] = int64_t(N) * isz - 2;

    if (N == 32 && isz >= 8 && fqz5_have_avx512()) {
        // flat (ctx*256+sym) SoA tables; lanes gather their strided
        // chunk bytes directly (no input transpose)
        static thread_local std::vector<uint32_t> soa;
        soa.resize(4 * 65536);
        uint32_t* sxm = soa.data();
        uint32_t* src_ = sxm + 65536;
        uint32_t* sbi = src_ + 65536;
        uint32_t* scr = sbi + 65536;
        // Only contexts that occur in the data are ever gathered
        // (the walk's row index is a data byte), so skip unused rows —
        // for sparse alphabets this cuts the fill from 65536 entries
        // to nsym*256 (the dominant per-call cost on ~1MB inputs).
        for (int i2 = 0; i2 < 256; i2++) {
            if (T[i2] == 0) continue;
            for (int j = 0; j < 256; j++) {
                const EncSym& e = syms[i2][j];
                int k = i2 * 256 + j;
                sxm[k] = e.x_max;
                src_[k] = e.rcp;
                sbi[k] = e.bias;
                scr[k] = uint32_t(e.cmpl) | (uint32_t(e.rcp_shift) << 16);
            }
        }
        // The walk's dword gathers read up to 3 bytes past
        // in[z*isz + i]; run the top columns through the scalar walk
        // until lane 31's read window fits inside the input.  For
        // in_size % 32 >= 2 this loop never executes (the old guard's
        // case); for 32-aligned inputs it runs 1-2 columns.  Emission
        // order (z = 31..0 per column) matches the vector walk's
        // group layout, so the stream stays byte-identical.
        int64_t i_start = int64_t(isz) - 2;
        while (i_start >= 0 &&
               31 * int64_t(isz) + i_start + 3 >= int64_t(in_size)) {
            for (int z = N - 1; z >= 0; z--) {
                uint8_t c = in[size_t(z) * isz + i_start];
                enc_put(R[z], ptr, syms[c][lN[z]]);
                lN[z] = c;
            }
            i_start--;
        }
        fqz5_simd512_enc_o1_32(in, isz, i_start, lN, sxm, src_, sbi,
                               scr, R, &ptr);
    } else if (N == 4) {
        ptr = enc_walk4_o1(in, syms, R, iN, lN, ptr);
    } else {
        for (; iN[0] >= 0;) {
            for (int z = N - 1; z >= 0; z--) {
                uint8_t c = in[iN[z]];
                enc_put(R[z], ptr, syms[c][lN[z]]);
                lN[z] = c;
                iN[z]--;
            }
        }
        for (int z = N - 1; z >= 0; z--)
            enc_put(R[z], ptr, syms[0][lN[z]]);
    }
    for (int z = N - 1; z >= 0; z--) enc_flush(R[z], ptr);

    eo.tab = op;
    eo.tab_len = tab_size;
    eo.stream = ptr;
    eo.stream_len = size_t(end - ptr);
    return true;
}

template <int N>
bool rans_enc_o1(const uint8_t* in, uint32_t in_size,
                 std::vector<uint8_t>& out) {
    EncSpans eo;
    if (!rans_enc_o1_sp<N>(in, in_size, eo)) return false;
    out.clear();
    out.reserve(eo.size());
    out.insert(out.end(), eo.tab, eo.tab + eo.tab_len);
    out.insert(out.end(), eo.stream, eo.stream + eo.stream_len);
    return true;
}

// --- flat 4-state order-1 fast walk ----------------------------------
// Free-standing (not a nested lambda): with the loop body at function
// scope gcc keeps the table pointers, the output pointer and all
// twelve per-state values in hardware registers; the lambda-in-lambda
// form spilled every pointer to the stack and reloaded them per
// symbol.  Caller guarantees >= 8 readable bytes past cp while
// cp < fast_end.  Returns the new symbol index i.
template <uint32_t kSh, bool kMg>
static uint32_t rans_o1_walk4(const uint32_t* s3o1, const uint8_t* sfb,
                              const uint32_t* fb, uint32_t row_stride,
                              uint8_t* out, uint32_t isz, uint32_t i,
                              const uint8_t** cpp,
                              const uint8_t* fast_end, uint32_t* R,
                              uint8_t* l, uint32_t* i4) {
    constexpr uint32_t kMsk = (1u << kSh) - 1;
    const uint8_t* cp = *cpp;
    uint32_t R0 = R[0], R1 = R[1], R2 = R[2], R3 = R[3];
    uint32_t l0 = l[0], l1 = l[1], l2 = l[2], l3 = l[3];
    // The four output cursors advance in lockstep at z*isz + i, so two
    // base pointers plus one register displacement replace the four
    // counters — without this the loop needs 18+ live values and gcc
    // spills the table/output pointers (it even parked lane state in
    // AVX-512 mask registers), reloading them every symbol.
    (void)i;
    uint8_t* p0 = out + i4[0];
    uint8_t* p2 = out + i4[2];
    uint8_t* e0 = out + isz;
    const size_t dz = isz;
#define FQZ5_O1_STEP(Rz, lz)                                           \
    do {                                                               \
        uint32_t m = Rz & kMsk;                                        \
        if (kMg) {                                                     \
            uint32_t sv = s3o1[(lz << kSh) + m];                       \
            lz = sv & 0xFF;                                            \
            Rz = (sv >> (kSh + 8)) * (Rz >> kSh) + ((sv >> 8) & kMsk); \
        } else {                                                       \
            uint32_t c = sfb[lz * row_stride + m];                     \
            uint32_t e = fb[(lz << 8) + c];                            \
            Rz = (e >> 16) * (Rz >> kSh) + m - (e & 0xFFFF);           \
            lz = c;                                                    \
        }                                                              \
    } while (0)
    // Counted inner loop: the 4 renorms consume <= 8 bytes, so
    // min(out room, in room / 8) iterations need NO cp bound check —
    // one loop-carried compare instead of two, and fast_end leaves
    // the register set.
    for (;;) {
        size_t n = size_t(e0 - p0);
        if (cp < fast_end) {
            size_t rin = size_t(fast_end - cp) / 8;
            if (rin < n) n = rin;
        } else {
            n = 0;
        }
        if (!n) break;
        uint8_t* pe = p0 + n;
        for (; p0 < pe; p0++, p2++) {
            FQZ5_O1_STEP(R0, l0);
            FQZ5_O1_STEP(R1, l1);
            p0[0] = uint8_t(l0);
            p0[dz] = uint8_t(l1);
            dec_renorm16(R0, cp);
            dec_renorm16(R1, cp);
            FQZ5_O1_STEP(R2, l2);
            FQZ5_O1_STEP(R3, l3);
            p2[0] = uint8_t(l2);
            p2[dz] = uint8_t(l3);
            dec_renorm16(R2, cp);
            dec_renorm16(R3, cp);
        }
    }
#undef FQZ5_O1_STEP
    R[0] = R0; R[1] = R1; R[2] = R2; R[3] = R3;
    l[0] = uint8_t(l0); l[1] = uint8_t(l1);
    l[2] = uint8_t(l2); l[3] = uint8_t(l3);
    uint32_t idone = uint32_t(p0 - out);
    i4[0] = idone;
    i4[1] = idone + isz;
    i4[2] = idone + 2 * isz;
    i4[3] = idone + 3 * isz;
    *cpp = cp;
    return idone;
}

template <int N>
bool rans_dec_o1(const uint8_t* in, uint32_t in_size, uint8_t* out,
                 uint32_t out_sz) {
    if (in_size < uint32_t(N) * 4) return false;
    const uint8_t* cp = in;
    const uint8_t* cp_end = in + in_size;

    std::vector<uint8_t> c_freq;
    const uint8_t* tab_end = nullptr;
    const uint8_t* c_freq_end = cp_end;
    unsigned int shift = *cp >> 4;
    if (*cp++ & 1) {
        uint32_t u_sz, c_sz;
        int n = get_uv(cp, cp_end, &u_sz);
        if (!n) return false;
        cp += n;
        n = get_uv(cp, cp_end, &c_sz);
        if (!n) return false;
        cp += n;
        if (c_sz > uint32_t(cp_end - cp)) return false;
        tab_end = cp + c_sz;
        c_freq.resize(u_sz);
        if (!rans_dec_o0<4>(cp, c_sz, c_freq.data(), u_sz)) return false;
        cp = c_freq.data();
        c_freq_end = c_freq.data() + u_sz;
    }
    if (shift != kShiftO1 && shift != kShiftO1Fast) return false;

    uint32_t F0[256] = {0};
    int fsz = decode_alphabet(cp, c_freq_end, F0);
    if (!fsz) return false;
    cp += fsz;
    if (cp >= c_freq_end) return false;

    const uint32_t tot = 1u << shift;
    // Table layout is picked by footprint: the per-symbol read is a
    // RANDOM index into a (256 << shift)-entry table, so its size
    // decides the cache-hit rate of the whole walk.
    //  - SIMD 32-way and shift==10: merged u32 s3 — slot
    //    (ctx << shift) + m packs ((f-1) << 20) | (start << 8) | sym,
    //    ONE read per symbol (1 MB at shift 10).
    //  - scalar: merged is 4 MB at shift 12 (spills L2) and 1 MB at
    //    shift 10; the split is a u8 symbol table (1 MB / 256 KB) + a
    //    (ctx, sym)-indexed packed (f << 16 | start) u32 table
    //    (256 KB, and hot: few distinct symbols per context) — a
    //    strictly smaller random-access footprint at either shift.
    //    Reference analog: rANS_static4x16pr.c:601-700 (sfb/fb).
    const bool use_simd =
        N == 32 && out_sz / N && (fqz5_have_avx2() || fqz5_have_avx512());
    // merged single-load wins at shift 10 on big (low-compression)
    // payloads where renorm traffic dominates; the split tables win
    // at shift 12 (4 MB merged spills L2) and on small inputs (less
    // table-build cost) — the reference's s3_fast_on heuristic
    // (rANS_static4x16pr.c:599)
    const bool two_tab =
        !use_simd && (shift == kShiftO1 || in_size < 100000);
    static thread_local std::vector<uint32_t> s3v;
    static thread_local std::vector<uint8_t> sfbv;
    static thread_local std::vector<uint32_t> fbv;
    uint32_t* s3o1 = nullptr;
    uint8_t* sfb = nullptr;
    uint32_t* fb = nullptr;
    // stagger sfb rows by a non-power-of-2 pad so the 256 rows don't
    // alias the same cache sets / 4K pages (reference MAGIC2 tuning,
    // rANS_static4x16pr.c:520-558)
    const uint32_t row_stride = tot + 179;
    if (two_tab) {
        sfbv.resize(size_t(256) * row_stride);
        fbv.assign(256 * 256, 0);
        sfb = sfbv.data();
        fb = fbv.data();
    } else {
        s3v.resize(256 * tot);
        s3o1 = s3v.data();
    }

    for (int i = 0; i < 256; i++) {
        if (F0[i] == 0) continue;
        uint32_t F[256] = {0}, T = 0;
        fsz = decode_freq_row(cp, c_freq_end, F0, F, &T);
        if (!fsz) return false;
        cp += fsz;
        if (!T) continue;
        normalise_freq_shift(F, T, tot);
        uint32_t x = 0;
        for (int j = 0; j < 256; j++) {
            if (!F[j]) continue;
            if (F[j] > tot - x) return false;
            if (two_tab) {
                memset(&sfb[uint32_t(i) * row_stride + x], j, F[j]);
                fb[(uint32_t(i) << 8) + j] = (F[j] << 16) | x;
            } else if (use_simd) {
                // SIMD layout: ((f-1) << 20)|(start << 8)|sym — the
                // f-1 trick fits shift-12 freqs (4096) in 12 bits
                const uint32_t ent = ((F[j] - 1) << 20) | (x << 8)
                                     | uint32_t(j);
                uint32_t* row = &s3o1[i * tot + x];
                for (uint32_t k = 0; k < F[j]; k++) row[k] = ent;
            } else {
                // scalar per-slot packing (F << 18)|(y << 8)|sym:
                // storing the within-run offset y makes the state
                // update a pure mul-add (no -x correction).  Only
                // built at shift 10 (F <= 1024 -> 29 bits; shift 12
                // takes the two-table layout), reference
                // rANS_static4x16pr.c:625-627.
                uint32_t* row = &s3o1[i * tot + x];
                const uint32_t base = (F[j] << (kShiftO1Fast + 8))
                                      | uint32_t(j);
                for (uint32_t k = 0; k < F[j]; k++)
                    row[k] = base + (k << 8);
            }
            x += F[j];
        }
        if (x != tot) return false;
    }
    if (tab_end) cp = tab_end;

    if (cp_end - cp < N * 4) return false;
    uint32_t R[N];
    const uint8_t* limit = in + in_size;
    for (int z = 0; z < N; z++) {
        R[z] = dec_init(cp);
        if (R[z] < kRansL) return false;
    }

    uint32_t isz = out_sz / N;
    uint32_t i4[N];
    uint8_t l[N] = {0};
    for (int z = 0; z < N; z++) i4[z] = z * isz;
    const uint32_t mask = tot - 1;

    if (use_simd) {
        // chunked: the (chunk x 32) transposed buffer stays L2-hot, so
        // the un-transpose pass reads cache instead of re-streaming
        // the whole section from DRAM (round 5: the full-size tbuf
        // cost ~3% of the O1 decode wall on 24MB sections).  The SIMD
        // kernels carry R/last in and out, so chunking is free.
        constexpr uint32_t kChunk = 4096;   // 128KB tile
        static thread_local std::vector<uint8_t> tbuf;
        tbuf.resize(size_t(std::min(isz, kChunk)) * 32);
        for (uint32_t base = 0; base < isz; base += kChunk) {
            uint32_t n = std::min(kChunk, isz - base);
            if (fqz5_dec_avx512())
                fqz5_simd512_dec_o1_32(s3o1, int(shift), &cp, limit,
                                       R, l, tbuf.data(), n);
            else
                fqz5_simd_dec_o1_32(s3o1, int(shift), &cp, limit, R,
                                    l, tbuf.data(), n);
            // un-transpose (n x 32) into the 32 lane chunks
#if defined(__SSE2__)
            uint32_t it = 0;
            for (; it + 16 <= n; it += 16)
                for (int g = 0; g < 2; g++)
                    transpose16x16(
                        tbuf.data() + size_t(it) * 32 + 16 * g, 32,
                        out + i4[16 * g] + base + it, isz);
            for (; it < n; it++)
                for (int z = 0; z < N; z++)
                    out[i4[z] + base + it] = tbuf[size_t(it) * 32 + z];
#else
            for (int z = 0; z < N; z++) {
                uint8_t* dst = out + i4[z] + base;
                const uint8_t* src = tbuf.data() + z;
                for (uint32_t i = 0; i < n; i++)
                    dst[i] = src[size_t(i) * 32];
            }
#endif
        }
        for (int z = 0; z < N; z++) i4[z] += isz;
    } else {
        // Scalar walk.  The fast loop is specialised per shift value
        // and table layout (the reference's "15% faster to specialise
        // for 10/12", rANS_static4x16pr.c:598-640); the bounds check
        // hoists to once per N renorms (each consumes <= 2 bytes),
        // and the renorms are grouped AFTER the N table steps so all
        // N symbol loads issue before the serial cp chain.
        const uint8_t* fast_end = limit - 2 * N;
        uint32_t i = 0;
        if (N == 4) {
            // flat per-(shift, layout) walks — see rans_o1_walk4
            if (!two_tab)  // merged s3 exists only at shift 10
                i = rans_o1_walk4<kShiftO1Fast, true>(
                    s3o1, nullptr, nullptr, 0, out, isz, i, &cp,
                    fast_end, R, l, i4);
            else if (shift == kShiftO1)
                i = rans_o1_walk4<kShiftO1, false>(
                    nullptr, sfb, fb, row_stride, out, isz, i, &cp,
                    fast_end, R, l, i4);
            else
                i = rans_o1_walk4<kShiftO1Fast, false>(
                    nullptr, sfb, fb, row_stride, out, isz, i, &cp,
                    fast_end, R, l, i4);
        } else {
            auto fast_walk = [&](auto shc, auto mgc) {
                constexpr uint32_t kSh = decltype(shc)::value;
                constexpr bool kMg = decltype(mgc)::value;
                constexpr uint32_t kMsk = (1u << kSh) - 1;
                for (; i < isz && cp < fast_end; i++) {
                    for (int z = 0; z < N; z++) {
                        uint32_t m = R[z] & kMsk;
                        uint32_t c;
                        if constexpr (kMg) {
                            uint32_t sv =
                                s3o1[(uint32_t(l[z]) << kSh) + m];
                            c = sv & 0xFF;
                            R[z] = (sv >> (kSh + 8)) * (R[z] >> kSh)
                                   + ((sv >> 8) & kMsk);
                        } else {
                            c = sfb[uint32_t(l[z]) * row_stride + m];
                            uint32_t e = fb[(uint32_t(l[z]) << 8) + c];
                            R[z] = (e >> 16) * (R[z] >> kSh) + m
                                   - (e & 0xFFFF);
                        }
                        out[i4[z]++] = uint8_t(c);
                        l[z] = uint8_t(c);
                        dec_renorm16(R[z], cp);
                    }
                }
            };
            using u32c10 =
                std::integral_constant<uint32_t, kShiftO1Fast>;
            using u32c12 = std::integral_constant<uint32_t, kShiftO1>;
            if (two_tab) {
                if (shift == kShiftO1)
                    fast_walk(u32c12{}, std::false_type{});
                else
                    fast_walk(u32c10{}, std::false_type{});
            } else {
                // merged s3 exists only at shift 10
                fast_walk(u32c10{}, std::true_type{});
            }
        }
        // safe remainder (runtime shift, checked renorm)
        for (; i < isz; i++) {
            for (int z = 0; z < N; z++) {
                uint32_t m = R[z] & mask;
                uint8_t c;
                if (two_tab) {
                    c = sfb[uint32_t(l[z]) * row_stride + m];
                    uint32_t e = fb[(uint32_t(l[z]) << 8) + c];
                    R[z] = (e >> 16) * (R[z] >> shift) + m
                           - (e & 0xFFFF);
                } else if (use_simd) {
                    uint32_t sv = s3o1[(uint32_t(l[z]) << shift) + m];
                    c = uint8_t(sv & 0xFF);
                    R[z] = ((sv >> 20) + 1) * (R[z] >> shift) + m
                           - ((sv >> 8) & 0xFFF);
                } else {
                    uint32_t sv = s3o1[(uint32_t(l[z]) << shift) + m];
                    c = uint8_t(sv & 0xFF);
                    R[z] = (sv >> (shift + 8)) * (R[z] >> shift)
                           + ((sv >> 8) & mask);
                }
                out[i4[z]++] = c;
                l[z] = c;
                dec_renorm(R[z], cp, limit);
            }
        }
    }
    // tail on the last state
    for (uint32_t i = i4[N - 1]; i < out_sz; i++) {
        uint32_t m = R[N - 1] & mask;
        uint8_t c;
        if (two_tab) {
            c = sfb[uint32_t(l[N - 1]) * row_stride + m];
            uint32_t e = fb[(uint32_t(l[N - 1]) << 8) + c];
            R[N - 1] = (e >> 16) * (R[N - 1] >> shift) + m - (e & 0xFFFF);
        } else if (use_simd) {
            uint32_t sv = s3o1[(uint32_t(l[N - 1]) << shift) + m];
            c = uint8_t(sv & 0xFF);
            R[N - 1] = ((sv >> 20) + 1) * (R[N - 1] >> shift) + m
                       - ((sv >> 8) & 0xFFF);
        } else {
            uint32_t sv = s3o1[(uint32_t(l[N - 1]) << shift) + m];
            c = uint8_t(sv & 0xFF);
            R[N - 1] = (sv >> (shift + 8)) * (R[N - 1] >> shift)
                       + ((sv >> 8) & mask);
        }
        out[i] = c;
        l[N - 1] = c;
        dec_renorm(R[N - 1], cp, limit);
    }
    return true;
}

bool core_encode(const uint8_t* in, uint32_t in_size, int simd, int order01,
                 std::vector<uint8_t>& out) {
    if (order01)
        return simd ? rans_enc_o1<32>(in, in_size, out)
                    : rans_enc_o1<4>(in, in_size, out);
    return simd ? rans_enc_o0<32>(in, in_size, out)
                : rans_enc_o0<4>(in, in_size, out);
}

bool core_encode_sp(const uint8_t* in, uint32_t in_size, int simd,
                    int order01, EncSpans& eo) {
    if (order01)
        return simd ? rans_enc_o1_sp<32>(in, in_size, eo)
                    : rans_enc_o1_sp<4>(in, in_size, eo);
    return simd ? rans_enc_o0_sp<32>(in, in_size, eo)
                : rans_enc_o0_sp<4>(in, in_size, eo);
}

bool core_decode(const uint8_t* in, uint32_t in_size, int simd, int order01,
                 uint8_t* out, uint32_t out_sz) {
    if (order01)
        return simd ? rans_dec_o1<32>(in, in_size, out, out_sz)
                    : rans_dec_o1<4>(in, in_size, out, out_sz);
    return simd ? rans_dec_o0<32>(in, in_size, out, out_sz)
                : rans_dec_o0<4>(in, in_size, out, out_sz);
}

// ---------------------------------------------------------------------
// PACK transform (pack.c:56-150)
bool pack_bytes(const uint8_t* in, uint32_t len, std::vector<uint8_t>& meta,
                std::vector<uint8_t>& packed) {
    int p[256] = {0};
    for (uint32_t i = 0; i < len; i++) p[in[i]] = 1;
    int n = 0;
    meta.assign(1, 0);
    for (int i = 0; i < 256; i++) {
        if (p[i]) {
            p[i] = n++;
            meta.push_back(uint8_t(i));
        }
    }
    meta[0] = uint8_t(n);  // 256 wraps to 0
    if (n > 16) return false;

    int vpb = n > 4 ? 2 : n > 2 ? 4 : n > 1 ? 8 : 0;
    // byte-wide LUT + sized output with raw stores (a push_back per
    // packed byte was ~15% of the whole PACK+O1 encode)
    uint8_t pl[256];
    for (int i = 0; i < 256; i++) pl[i] = uint8_t(p[i]);
    packed.clear();
    switch (vpb) {
        case 2: {
            packed.resize((len + 1) / 2);
            uint8_t* o = packed.data();
            uint32_t i = 0;
            for (; i < (len & ~1u); i += 2)
                *o++ = uint8_t(pl[in[i]] | (pl[in[i + 1]] << 4));
            if (len & 1) *o++ = pl[in[len - 1]];
            break;
        }
        case 4: {
            packed.resize((len + 3) / 4);
            uint8_t* o = packed.data();
            uint32_t i = 0;
            for (; i + 4 <= len; i += 4)
                *o++ = uint8_t(pl[in[i]] | (pl[in[i + 1]] << 2) |
                               (pl[in[i + 2]] << 4) | (pl[in[i + 3]] << 6));
            if (i < len) {
                uint8_t b = 0;
                int x = 0;
                for (; i < len; i++, x += 2) b |= pl[in[i]] << x;
                *o++ = b;
            }
            break;
        }
        case 8: {
            packed.resize((len + 7) / 8);
            uint8_t* o = packed.data();
            uint32_t i = 0;
            for (; i + 8 <= len; i += 8) {
                uint8_t b = 0;
                for (int k = 0; k < 8; k++) b |= pl[in[i + k]] << k;
                *o++ = b;
            }
            if (i < len) {
                uint8_t b = 0;
                int x = 0;
                for (; i < len; i++, x++) b |= pl[in[i]] << x;
                *o++ = b;
            }
            break;
        }
        case 0:
            break;  // single symbol: nothing stored
    }
    return true;
}

int unpack_meta(const uint8_t* data, uint32_t data_len, uint8_t* map,
                int* nsym) {
    if (data_len == 0) return 0;
    unsigned int n = data[0];
    if (n == 0) n = 256;
    if (n <= 1)
        *nsym = 0;
    else if (n <= 2)
        *nsym = 8;
    else if (n <= 4)
        *nsym = 4;
    else if (n <= 16)
        *nsym = 2;
    else {
        *nsym = 1;
        return 1;
    }
    if (data_len <= 1) return 0;
    unsigned int j = 1, c = 0;
    do {
        map[c++] = data[j++];
    } while (c < n && j < data_len);
    return c < n ? 0 : int(j);
}

bool unpack_bytes(const uint8_t* data, uint32_t len, uint8_t* out,
                  uint64_t out_len, int nsym, const uint8_t* map) {
    if (nsym == 1) {
        // memmove: the zero-copy decode path stages `data` in the tail
        // of `out` itself (rans_uncompress_into), so ranges may overlap
        memmove(out, data, len);
        return true;
    }
    // Each packed byte expands through a 256-entry pre-expanded LUT
    // with one wide store — the per-symbol scalar form ran at ~1
    // byte/cycle and dominated the PACK-decode paths.
    switch (nsym) {
        case 8: {
            if ((out_len + 7) / 8 > len) return false;
            uint64_t lut[256];
            for (int c = 0; c < 256; c++) {
                uint8_t b8[8];
                for (int k = 0; k < 8; k++) b8[k] = map[(c >> k) & 1];
                memcpy(&lut[c], b8, 8);
            }
            uint64_t i = 0, j = 0;
            for (; i + 8 <= out_len; i += 8)
                memcpy(out + i, &lut[data[j++]], 8);
            if (i < out_len) {
                uint8_t c = data[j++];
                for (; i < out_len; i++, c >>= 1) out[i] = map[c & 1];
            }
            return true;
        }
        case 4: {
            if ((out_len + 3) / 4 > len) return false;
            uint32_t lut[256];
            for (int c = 0; c < 256; c++) {
                uint8_t b4[4] = {map[c & 3], map[(c >> 2) & 3],
                                 map[(c >> 4) & 3], map[(c >> 6) & 3]};
                memcpy(&lut[c], b4, 4);
            }
            uint64_t i = 0, j = 0;
            for (; i + 4 <= out_len; i += 4)
                memcpy(out + i, &lut[data[j++]], 4);
            if (i < out_len) {
                uint8_t c = data[j++];
                for (; i < out_len; i++, c >>= 2) out[i] = map[c & 3];
            }
            return true;
        }
        case 2: {
            if ((out_len + 1) / 2 > len) return false;
            uint16_t lut[256];
            for (int c = 0; c < 256; c++) {
                uint8_t b2[2] = {map[c & 15], map[(c >> 4) & 15]};
                memcpy(&lut[c], b2, 2);
            }
            uint64_t i = 0, j = 0;
            for (; i + 2 <= out_len; i += 2)
                memcpy(out + i, &lut[data[j++]], 2);
            if (i < out_len) out[i] = map[data[j] & 15];
            return true;
        }
        case 0: {
            memset(out, map[0], out_len);
            return true;
        }
    }
    return false;
}

// ---------------------------------------------------------------------
// RLE transform (rle.c)
void rle_encode(const uint8_t* in, uint64_t len, std::vector<uint8_t>& runs,
                std::vector<uint8_t>& lits, uint8_t* rle_syms,
                int* rle_nsyms) {
    // Same counting rule as rle.c: +1 when a byte repeats its
    // predecessor, -1 otherwise.  4-way split tables break the
    // store-forward serialization on runs of one symbol (the common
    // case on quality data) — same trick as hist4 above.
    int64_t saved[256] = {0};
    if (len) {
        int64_t s4[4][256] = {{0}};
        saved[in[0]]--;
        uint64_t i = 1;
        for (; i + 4 <= len; i += 4) {
            s4[0][in[i]] += in[i] == in[i - 1] ? 1 : -1;
            s4[1][in[i + 1]] += in[i + 1] == in[i] ? 1 : -1;
            s4[2][in[i + 2]] += in[i + 2] == in[i + 1] ? 1 : -1;
            s4[3][in[i + 3]] += in[i + 3] == in[i + 2] ? 1 : -1;
        }
        for (; i < len; i++) saved[in[i]] += in[i] == in[i - 1] ? 1 : -1;
        for (int j = 0; j < 256; j++)
            saved[j] += s4[0][j] + s4[1][j] + s4[2][j] + s4[3][j];
    }
    int n = 0;
    for (int i = 0; i < 256; i++)
        if (saved[i] > 0) rle_syms[n++] = uint8_t(i);
    *rle_nsyms = n;

    runs.clear();
    // resize (not per-byte push_back: a capacity check + size bump per
    // literal was the bulk of the 0xC1 transform cost); trimmed below.
    lits.resize(len);
    uint8_t* lp = lits.empty() ? nullptr : lits.data();
    uint8_t vbuf[8];
    const uint8_t* p = in;
    const uint8_t* pend = in + len;
    while (p < pend) {
        uint8_t b = *p;
        *lp++ = b;
        if (saved[b] > 0) {
            const uint8_t* q = p + 1;
            while (q < pend && *q == b) q++;
            uint32_t rlen = uint32_t(q - p - 1);
            int nb = put_uv(vbuf, rlen);
            runs.insert(runs.end(), vbuf, vbuf + nb);
            p = q;
        } else {
            p++;
        }
    }
    lits.resize(len ? size_t(lp - lits.data()) : 0);
}

bool rle_decode(const uint8_t* lit, uint64_t lit_len, const uint8_t* run,
                uint64_t run_len, const uint8_t* rle_syms, int rle_nsyms,
                uint8_t* out, uint64_t* out_len) {
    int saved[256] = {0};
    for (int j = 0; j < rle_nsyms; j++) saved[rle_syms[j]] = 1;
    const uint8_t* run_end = run + run_len;
    const uint8_t* lit_end = lit + lit_len;
    uint8_t* outp = out;
    uint8_t* out_end = out + *out_len;
    while (lit < lit_end) {
        if (outp >= out_end) return false;
        uint8_t b = *lit;
        if (saved[b]) {
            uint32_t rlen = 0;
            int n = get_uv(run, run_end, &rlen);
            if (!n) return false;
            run += n;
            if (rlen) {
                if (outp + rlen >= out_end) return false;
                memset(outp, b, rlen + 1);
                outp += rlen + 1;
            } else {
                *outp++ = b;
            }
        } else {
            *outp++ = b;
        }
        lit++;
    }
    *out_len = uint64_t(outp - out);
    return true;
}

}  // namespace

// ---------------------------------------------------------------------
// Top-level framing (rans_compress_to_4x16 / rans_uncompress_to_4x16)

// Result of the plain (non-STRIPE, non-requested-CAT) encode path:
// header fields plus payload spans, so callers can assemble the framed
// stream straight into their destination buffer with no staging copy.
struct PlainEnc {
    uint8_t order_byte = 0;
    std::vector<uint8_t> meta;      // size varint + transform metadata
    bool cat = false;               // payload = raw cur bytes
    const uint8_t* cur = nullptr;   // post-transform input (CAT source)
    uint32_t cur_size = 0;
    EncSpans sp;                    // core output when !cat
    std::vector<uint8_t> packed_store, rle_store;  // keep cur alive
    size_t payload_len() const { return cat ? cur_size : sp.size(); }
    size_t total() const { return 1 + meta.size() + payload_len(); }
};

// `order` must already be normalized (SIMD_AUTO resolved, small-size
// STRIPE/X32 clears applied) and contain neither kStripe nor kCat.
static bool compress_plain(const uint8_t* in, uint32_t in_size, int order,
                           PlainEnc& pe) {
    int do_pack = order & kPack;
    int do_rle = order & kRle;
    int no_size = order & kNosz;
    int do_simd = order & kX32;

    pe.order_byte = uint8_t(order & 0xff);
    std::vector<uint8_t>& meta = pe.meta;
    uint8_t vbuf[8];
    int nb;
    if (!no_size) {
        nb = put_uv(vbuf, in_size);
        meta.insert(meta.end(), vbuf, vbuf + nb);
    }

    pe.cur = in;
    pe.cur_size = in_size;

    if (do_pack && in_size) {
        std::vector<uint8_t> pmeta;
        if (!pack_bytes(pe.cur, pe.cur_size, pmeta, pe.packed_store)) {
            pe.order_byte &= ~kPack;
            do_pack = 0;
        } else {
            meta.insert(meta.end(), pmeta.begin(), pmeta.end());
            pe.cur = pe.packed_store.data();
            pe.cur_size = uint32_t(pe.packed_store.size());
            nb = put_uv(vbuf, pe.cur_size);
            meta.insert(meta.end(), vbuf, vbuf + nb);
            if (do_simd && pe.cur_size < 32) {
                do_simd = 0;
                pe.order_byte &= ~kX32;
            }
        }
    } else if (do_pack) {
        pe.order_byte &= ~kPack;
        do_pack = 0;
    }

    if (do_rle && pe.cur_size) {
        uint8_t rle_syms[256];
        int rle_nsyms = 0;
        std::vector<uint8_t> runs, lits;
        rle_encode(pe.cur, pe.cur_size, runs, lits, rle_syms, &rle_nsyms);
        // meta stream = [nsyms][syms][runs]
        std::vector<uint8_t> rmeta;
        rmeta.push_back(uint8_t(rle_nsyms));
        rmeta.insert(rmeta.end(), rle_syms, rle_syms + rle_nsyms);
        rmeta.insert(rmeta.end(), runs.begin(), runs.end());
        uint32_t rmeta_len = uint32_t(rmeta.size());
        uint64_t rle_len = lits.size();

        if (rle_len + rmeta_len >= 0.99 * pe.cur_size) {
            pe.order_byte &= ~kRle;
            do_rle = 0;
        } else {
            if (do_simd && (rmeta_len < 32 || rle_len < 32)) {
                do_simd = 0;
                pe.order_byte &= ~kX32;
            }
            std::vector<uint8_t> cmeta;
            if (!core_encode(rmeta.data(), rmeta_len, do_simd, 0, cmeta))
                return false;
            if (cmeta.size() < rmeta_len) {
                nb = put_uv(vbuf, rmeta_len * 2);
                meta.insert(meta.end(), vbuf, vbuf + nb);
                nb = put_uv(vbuf, uint32_t(rle_len));
                meta.insert(meta.end(), vbuf, vbuf + nb);
                nb = put_uv(vbuf, uint32_t(cmeta.size()));
                meta.insert(meta.end(), vbuf, vbuf + nb);
                meta.insert(meta.end(), cmeta.begin(), cmeta.end());
            } else {
                nb = put_uv(vbuf, rmeta_len * 2 + 1);  // odd => raw meta
                meta.insert(meta.end(), vbuf, vbuf + nb);
                nb = put_uv(vbuf, uint32_t(rle_len));
                meta.insert(meta.end(), vbuf, vbuf + nb);
                meta.insert(meta.end(), rmeta.begin(), rmeta.end());
            }
            pe.rle_store = std::move(lits);
            pe.cur = pe.rle_store.data();
            pe.cur_size = uint32_t(pe.rle_store.size());
        }
    } else if (do_rle) {
        pe.order_byte &= ~kRle;
        do_rle = 0;
    }

    int order01 = order & 3 & 1;
    if (order01 && pe.cur_size < 8) {
        pe.order_byte &= ~1;
        order01 = 0;
    }

    if (!core_encode_sp(pe.cur, pe.cur_size, do_simd, order01, pe.sp))
        return false;

    if (pe.sp.size() >= pe.cur_size) {
        // rANS didn't help: CAT the (transformed) data
        pe.order_byte &= ~3;
        pe.order_byte |= kCat | no_size;
        pe.cat = true;
    }
    return true;
}

std::vector<uint8_t> rans_compress(const uint8_t* in, uint32_t in_size,
                                   int order) {
    std::vector<uint8_t> out;
    if ((order & kSimdAuto) && in_size >= 50000 && !(order & kStripe))
        order |= kX32;
    if (in_size <= 20) order &= ~kStripe;
    if (in_size <= 1000) order &= ~kX32;

    if (order & kStripe) {
        int N = (order >> 8) & 0xff;
        if (N == 0) N = 4;
        if (uint32_t(N) > in_size) N = in_size;

        // byte-transpose into N sub-streams
        std::vector<uint8_t> transposed(in_size);
        uint32_t part_len[256], idx[256];
        for (int i = 0; i < N; i++) {
            part_len[i] = in_size / N + ((in_size % N) > uint32_t(i));
            idx[i] = i ? idx[i - 1] + part_len[i - 1] : 0;
        }
        {
            uint32_t i = 0, x = 0;
            for (; i + N <= in_size; i += N, x++)
                for (int j = 0; j < N; j++) transposed[idx[j] + x] = in[i + j];
            for (int j = 0; i + j < in_size; j++)
                transposed[idx[j] + x] = in[i + j];
        }

        std::vector<uint8_t> hdr;
        hdr.push_back(uint8_t(order & ~kNosz));
        uint8_t vbuf[8];
        int nb = put_uv(vbuf, in_size);
        hdr.insert(hdr.end(), vbuf, vbuf + nb);
        hdr.push_back(uint8_t(N));

        std::vector<uint8_t> body;
        const int m[4] = {1, 64, 128, 0};
        for (int i = 0; i < N; i++) {
            std::vector<uint8_t> best;
            bool have = false;
            for (int j = 0; j < 4; j++) {
                if ((order & m[j]) != m[j]) continue;
                if ((order & kStripeNo0) && (m[j] & 1) == 0) continue;
                std::vector<uint8_t> sub = rans_compress(
                    transposed.data() + idx[i], part_len[i],
                    m[j] | kNosz | (order & kX32));
                if (!sub.empty() && (!have || sub.size() < best.size())) {
                    best = std::move(sub);
                    have = true;
                }
            }
            if (!have && part_len[i] > 0) return {};
            if (!have) {
                // zero-length stripe: CAT of nothing
                best = rans_compress(transposed.data() + idx[i], 0,
                                     kNosz | (order & 1));
            }
            nb = put_uv(vbuf, uint32_t(best.size()));
            hdr.insert(hdr.end(), vbuf, vbuf + nb);
            body.insert(body.end(), best.begin(), best.end());
        }
        out = std::move(hdr);
        out.insert(out.end(), body.begin(), body.end());
        return out;
    }

    if (order & kCat) {
        out.push_back(uint8_t(order & 0xff));
        uint8_t vbuf[8];
        int nb = put_uv(vbuf, in_size);
        out.insert(out.end(), vbuf, vbuf + nb);
        out.insert(out.end(), in, in + in_size);
        return out;
    }

    PlainEnc pe;
    if (!compress_plain(in, in_size, order, pe)) return {};
    out.reserve(pe.total());
    out.push_back(pe.order_byte);
    out.insert(out.end(), pe.meta.begin(), pe.meta.end());
    if (pe.cat) {
        out.insert(out.end(), pe.cur, pe.cur + pe.cur_size);
    } else {
        out.insert(out.end(), pe.sp.tab, pe.sp.tab + pe.sp.tab_len);
        out.insert(out.end(), pe.sp.stream, pe.sp.stream + pe.sp.stream_len);
    }
    return out;
}

// Zero-copy encode: assembles the framed stream directly into `out`
// (caller-provided, e.g. the final section buffer).  Handles only the
// plain path (no STRIPE, no requested CAT) — callers fall back to
// rans_compress for those.  Returns encoded size, -1 on failure, or
// -2 if `out_cap` is too small (caller retries via the vector path).
int64_t rans_compress_into(const uint8_t* in, uint32_t in_size, int order,
                           uint8_t* out, size_t out_cap) {
    if ((order & kSimdAuto) && in_size >= 50000 && !(order & kStripe))
        order |= kX32;
    if (in_size <= 20) order &= ~kStripe;
    if (in_size <= 1000) order &= ~kX32;
    if (order & (kStripe | kCat)) {
        std::vector<uint8_t> tmp = rans_compress(in, in_size, order);
        if (tmp.empty() && in_size) return -1;
        if (tmp.size() > out_cap) return -2;
        memcpy(out, tmp.data(), tmp.size());
        return int64_t(tmp.size());
    }
    PlainEnc pe;
    if (!compress_plain(in, in_size, order, pe)) return -1;
    if (pe.total() > out_cap) return -2;
    uint8_t* p = out;
    *p++ = pe.order_byte;
    memcpy(p, pe.meta.data(), pe.meta.size());
    p += pe.meta.size();
    if (pe.cat) {
        memcpy(p, pe.cur, pe.cur_size);
        p += pe.cur_size;
    } else {
        memcpy(p, pe.sp.tab, pe.sp.tab_len);
        p += pe.sp.tab_len;
        memcpy(p, pe.sp.stream, pe.sp.stream_len);
        p += pe.sp.stream_len;
    }
    return int64_t(p - out);
}

// Zero-copy decode: writes the decoded stream directly into `out`
// (reference analog: rans_uncompress_to_4x16 decodes into the caller
// buffer; the old vector staging cost 3 extra 100MB+ passes per block
// on the hot plain-order path).  Returns decoded size or -1.
int64_t rans_uncompress_into(const uint8_t* in, uint32_t in_size,
                             uint8_t* out, uint32_t out_cap,
                             uint32_t out_hint, bool know_size) {
    if (in_size == 0) return -1;
    const uint8_t* in_end = in + in_size;

    if (*in & kStripe) {
        uint32_t c_meta_len = 1, ulen;
        int n = get_uv(in + c_meta_len, in_end, &ulen);
        if (!n) return -1;
        c_meta_len += n;
        if (c_meta_len >= in_size) return -1;
        unsigned int N = in[c_meta_len++];
        if (N < 1) return -1;
        if (know_size && ulen != out_hint) return -1;
        if (ulen > out_cap) return -1;

        uint32_t clenN[256], ulenN[256], idxN[256];
        uint64_t clen_tot = 0;
        for (unsigned int i = 0; i < N; i++) {
            ulenN[i] = ulen / N + ((ulen % N) > i);
            idxN[i] = i ? idxN[i - 1] + ulenN[i - 1] : 0;
            n = get_uv(in + c_meta_len, in_end, &clenN[i]);
            if (!n) return -1;
            c_meta_len += n;
            clen_tot += clenN[i];
            if (c_meta_len > in_size || clenN[i] > in_size || clenN[i] < 1)
                return -1;
        }
        if (c_meta_len + clen_tot > in_size) return -1;

        std::vector<uint8_t> outN(ulen);
        for (unsigned int i = 0; i < N; i++) {
            int64_t rc = rans_uncompress_into(
                in + c_meta_len, in_size - c_meta_len,
                outN.data() + idxN[i], ulenN[i], ulenN[i], true);
            if (rc != int64_t(ulenN[i])) return -1;
            c_meta_len += clenN[i];
        }
        // un-transpose
        uint32_t j = 0;
        uint32_t pos[256];
        memcpy(pos, idxN, sizeof(pos));
        while (j + N <= ulen)
            for (unsigned int k = 0; k < N; k++) out[j++] = outN[pos[k]++];
        for (unsigned int k = 0; j < ulen; k++) out[j++] = outN[pos[k]++];
        return ulen;
    }

    int order = *in++;
    in_size--;
    int do_pack = order & kPack;
    int do_rle = order & kRle;
    int do_cat = order & kCat;
    int no_size = order & kNosz;
    int do_simd = order & kX32;
    order &= 1;

    uint32_t osz;
    if (!no_size) {
        int n = get_uv(in, in_end, &osz);
        if (!n) return -1;
        in += n;
        in_size -= n;
    } else {
        if (!know_size) return -1;
        osz = out_hint;
    }
    if (osz > out_cap) return -1;

    uint32_t tmp1_size = osz;

    // PACK meta
    uint8_t map[16] = {0};
    int npacked_sym = 0;
    uint64_t unpacked_sz = 0;
    if (do_pack) {
        int used = unpack_meta(in, in_size, map, &npacked_sym);
        if (used == 0) return -1;
        unpacked_sz = osz;
        in += used;
        in_size -= used;
        uint32_t psz;
        int n = get_uv(in, in_end, &psz);
        if (!n) return -1;
        in += n;
        in_size -= n;
        if (psz > tmp1_size) return -1;
        tmp1_size = psz;
    }

    // RLE meta
    std::vector<uint8_t> rle_meta_store;
    const uint8_t* rmeta = nullptr;
    uint32_t u_meta_size = 0;
    if (do_rle) {
        uint32_t rle_len, c_meta_size;
        int sz = get_uv(in, in_end, &u_meta_size);
        if (!sz) return -1;
        int sz2 = get_uv(in + sz, in_end, &rle_len);
        if (!sz2) return -1;
        sz += sz2;
        if (rle_len > tmp1_size) return -1;
        if (u_meta_size & 1) {
            rmeta = in + sz;
            u_meta_size = u_meta_size / 2 > uint32_t(in_end - rmeta)
                              ? uint32_t(in_end - rmeta)
                              : u_meta_size / 2;
            c_meta_size = u_meta_size;
        } else {
            int n = get_uv(in + sz, in_end, &c_meta_size);
            if (!n) return -1;
            sz += n;
            u_meta_size /= 2;
            rle_meta_store.resize(u_meta_size);
            if (!core_decode(in + sz, in_size - sz, do_simd, 0,
                             rle_meta_store.data(), u_meta_size))
                return -1;
            rmeta = rle_meta_store.data();
        }
        if (c_meta_size + sz > in_size) return -1;
        in += c_meta_size + sz;
        in_size -= c_meta_size + sz;
        tmp1_size = rle_len;
    }

    // Entropy payload.  Plain path decodes straight into `out`.
    // PACK-only decodes the packed bytes into the TAIL of `out` and
    // unpacks forward in place: with vpb values per byte the writer at
    // k*vpb stays behind the reader at (cap - psz + k) because
    // (vpb-1)*k < cap - psz for every k < psz (cap >= unpacked size).
    // RLE stages through a scratch vector (rare path).
    std::vector<uint8_t> tmp_store;
    uint8_t* stage_w;      // where the entropy payload lands
    if (do_rle) {
        tmp_store.resize(tmp1_size);
        stage_w = tmp_store.data();
    } else if (do_pack) {
        if (tmp1_size > out_cap) return -1;
        stage_w = out + (out_cap - tmp1_size);
    } else {
        stage_w = out;
    }
    if (in_size) {
        if (do_cat) {
            if (tmp1_size > in_size) return -1;
            memcpy(stage_w, in, tmp1_size);
        } else {
            if (!core_decode(in, in_size, do_simd, order, stage_w,
                             tmp1_size))
                return -1;
        }
    } else {
        tmp1_size = 0;
    }

    const uint8_t* stage = stage_w;
    uint64_t stage_size = tmp1_size;

    // un-RLE
    std::vector<uint8_t> tmp2;
    if (do_rle) {
        if (u_meta_size == 0) return -1;
        int rle_nsyms = rmeta[0] ? rmeta[0] : 256;
        if (u_meta_size < uint32_t(1 + rle_nsyms)) return -1;
        uint64_t unrle_size = osz;
        uint8_t* unrle_dst;
        if (do_pack) {
            tmp2.resize(osz);
            unrle_dst = tmp2.data();
        } else {
            unrle_dst = out;
        }
        if (!rle_decode(stage, stage_size, rmeta + 1 + rle_nsyms,
                        u_meta_size - (1 + rle_nsyms), rmeta + 1, rle_nsyms,
                        unrle_dst, &unrle_size))
            return -1;
        stage = unrle_dst;
        stage_size = unrle_size;
        if (!do_pack) return int64_t(stage_size);
    }

    // un-PACK
    if (do_pack) {
        if (npacked_sym == 1) unpacked_sz = stage_size;
        if (unpacked_sz > out_cap) return -1;
        if (!unpack_bytes(stage, uint32_t(stage_size), out, unpacked_sz,
                          npacked_sym, map))
            return -1;
        return int64_t(unpacked_sz);
    }

    return int64_t(stage_size);
}

bool rans_uncompress(const uint8_t* in, uint32_t in_size,
                     std::vector<uint8_t>& out, uint32_t out_hint,
                     bool know_size) {
    // Vector convenience wrapper (internal/tok3 callers): size the
    // buffer from the header, then decode in place.
    if (in_size == 0) return false;
    const uint8_t* in_end = in + in_size;
    uint32_t osz;
    if (*in & kStripe) {
        if (!get_uv(in + 1, in_end, &osz)) return false;
    } else if (*in & kNosz) {
        if (!know_size) return false;
        osz = out_hint;
    } else {
        if (!get_uv(in + 1, in_end, &osz)) return false;
    }
    out.resize(osz);
    int64_t rc = rans_uncompress_into(in, in_size, out.data(), osz,
                                      out_hint, know_size);
    if (rc < 0) return false;
    out.resize(size_t(rc));
    return true;
}

}  // namespace fqz5

// ---------------------------------------------------------------------
// Table-preparation helpers for the device (JAX/Pallas) engine: the
// host builds/parses frequency tables with the exact reference logic;
// the O(n) state walk runs on the device.

namespace fqz5 {
extern "C" {

// Order-0 encode prep: histogram + two-stage normalisation + table
// serialization.  Writes the serialized table to tab (returns its
// length) and the final freqs (normalised to 1<<12) to freqs[256].
int64_t fqz5_rans_o0_prep(const uint8_t* in, uint32_t in_size, uint8_t* tab,
                          uint32_t tab_cap, uint32_t* freqs) {
    uint32_t F[256 + 8] = {0};
    hist4(in, in_size, F);
    uint32_t fsum = in_size;
    uint32_t max_val = round2(fsum);
    if (max_val > kTot) max_val = kTot;
    if (normalise_freq(F, fsum, max_val) < 0) return -1;
    fsum = max_val;
    if (tab_cap < 1024) return -1;
    int tab_size = encode_freq(tab, F);
    if (normalise_freq(F, fsum, kTot) < 0) return -1;
    memcpy(freqs, F, 256 * sizeof(uint32_t));
    return tab_size;
}

// Order-0 decode prep: parse the table and expand the s3 LUT.
// Returns bytes consumed.
int64_t fqz5_rans_o0_dec_prep(const uint8_t* in, uint32_t in_size,
                              uint32_t* s3) {
    const uint8_t* cp = in;
    const uint8_t* cp_end = in + in_size - 8;
    uint32_t F[256] = {0}, fsum = 0;
    int fsz = decode_freq(cp, cp_end, F, &fsum);
    if (!fsz) return -1;
    normalise_freq_shift(F, fsum, kTot);
    uint32_t x = 0;
    for (int j = 0; j < 256; j++) {
        if (!F[j]) continue;
        if (F[j] > kTot - x) return -1;
        uint32_t base = (F[j] << (kShift + 8)) | uint32_t(j);
        for (uint32_t y = 0; y < F[j]; y++, x++) s3[x] = base + (y << 8);
    }
    if (x != kTot) return -1;
    return fsz;
}

// Order-1 encode prep: order-1 stats, shift estimation, per-context
// normalisation, serialized (possibly recompressed) table.  freqs is
// 256*256 u32 normalised to 1<<shift.  Returns table length; *shift_out
// receives 10 or 12.
int64_t fqz5_rans_o1_prep(const uint8_t* in, uint32_t in_size, int nway,
                          uint8_t* tab, uint32_t tab_cap, uint32_t* freqs,
                          int* shift_out) {
    if (in_size < uint32_t(nway)) return -1;
    std::vector<uint32_t> Fbuf(256 * 256, 0);
    uint32_t (*F)[256] = reinterpret_cast<uint32_t(*)[256]>(Fbuf.data());
    uint32_t T[256] = {0};
    {
        uint8_t l = 0;
        for (uint32_t i = 0; i < in_size; i++) {
            F[l][in[i]]++;
            l = in[i];
        }
        T[l]++;
        for (int i = 0; i < 256; i++) {
            uint32_t tt = 0;
            for (int j = 0; j < 256; j++) tt += F[i][j];
            T[i] += tt;
        }
    }
    uint32_t isz = in_size / nway;
    for (int z = 1; z < nway; z++) F[0][in[z * isz]]++;
    T[0] += nway - 1;

    if (tab_cap < 257 * 257 * 3 + 64) return -1;
    uint8_t* op = tab;
    uint8_t* cp = op;
    uint32_t tmp_T0 = T[0];
    T[0] = 1;
    *cp++ = 0;
    cp += encode_alphabet(cp, T);
    T[0] = tmp_T0;

    uint32_t S[256] = {0};
    int shift = compute_shift(T, F, T, S);
    for (int i = 0; i < 256; i++) {
        if (T[i] == 0) continue;
        uint32_t max_val = S[i];
        if (shift == kShiftO1Fast && max_val > (1u << kShiftO1Fast))
            max_val = 1u << kShiftO1Fast;
        if (normalise_freq(F[i], T[i], max_val) < 0) return -1;
        T[i] = max_val;
        cp += encode_freq_row(cp, T, F[i]);
        normalise_freq_shift(F[i], T[i], 1u << shift);
        T[i] = 1u << shift;
    }
    *op = uint8_t(shift << 4);
    if (cp - op > 1000) {
        uint32_t u_sz = uint32_t(cp - (op + 1));
        std::vector<uint8_t> ctab;
        if (rans_enc_o0<4>(op + 1, u_sz, ctab) &&
            ctab.size() + 6 < size_t(cp - op)) {
            uint8_t hdr = *op | 1;
            uint8_t* p = op;
            *p++ = hdr;
            p += put_uv(p, u_sz);
            p += put_uv(p, uint32_t(ctab.size()));
            memcpy(p, ctab.data(), ctab.size());
            cp = p + ctab.size();
        }
    }
    memcpy(freqs, Fbuf.data(), 256 * 256 * sizeof(uint32_t));
    *shift_out = shift;
    return int64_t(cp - op);
}

// Order-1 decode prep: parse table into per-context s3 LUTs
// (256 * (1<<shift) u32).  Returns bytes consumed; *shift_out set.
int64_t fqz5_rans_o1_dec_prep(const uint8_t* in, uint32_t in_size,
                              uint32_t* s3, int* shift_out) {
    const uint8_t* cp = in;
    const uint8_t* cp_end = in + in_size;
    std::vector<uint8_t> c_freq;
    const uint8_t* tab_end = nullptr;
    const uint8_t* c_freq_end = cp_end;
    unsigned shift = *cp >> 4;
    if (*cp++ & 1) {
        uint32_t u_sz, c_sz;
        int n = get_uv(cp, cp_end, &u_sz);
        if (!n) return -1;
        cp += n;
        n = get_uv(cp, cp_end, &c_sz);
        if (!n) return -1;
        cp += n;
        if (c_sz > uint32_t(cp_end - cp)) return -1;
        tab_end = cp + c_sz;
        c_freq.resize(u_sz);
        if (!rans_dec_o0<4>(cp, c_sz, c_freq.data(), u_sz)) return -1;
        cp = c_freq.data();
        c_freq_end = c_freq.data() + u_sz;
    }
    if (shift != kShiftO1 && shift != kShiftO1Fast) return -1;
    uint32_t F0[256] = {0};
    int fsz = decode_alphabet(cp, c_freq_end, F0);
    if (!fsz) return -1;
    cp += fsz;
    const uint32_t tot = 1u << shift;
    memset(s3, 0, 256 * tot * sizeof(uint32_t));
    for (int i = 0; i < 256; i++) {
        if (F0[i] == 0) continue;
        uint32_t F[256] = {0}, T = 0;
        fsz = decode_freq_row(cp, c_freq_end, F0, F, &T);
        if (!fsz) return -1;
        cp += fsz;
        if (!T) continue;
        normalise_freq_shift(F, T, tot);
        uint32_t x = 0;
        for (int j = 0; j < 256; j++) {
            if (!F[j]) continue;
            if (F[j] > tot - x) return -1;
            uint32_t base = (F[j] << (shift + 8)) | uint32_t(j);
            for (uint32_t y = 0; y < F[j]; y++, x++)
                s3[i * tot + x] = base + (y << 8);
        }
        if (x != tot) return -1;
    }
    *shift_out = int(shift);
    if (tab_end) return tab_end - in;
    return cp - in;
}

}  // extern "C"
}  // namespace fqz5
